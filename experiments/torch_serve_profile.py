#!/usr/bin/env python3
"""Where the time goes when ``repro_torch`` serves GPT-A or RWKV-6 7B on the card.

    python3 experiments/torch_serve_profile.py [--arch gpt-a|rwkv6-7b] [--layers N] [--steps 8]

Needs one NVIDIA Hopper card and ``nvcc``.  Serves one batch of 4 prompts of
512 tokens at full width (random weights from a seed) and traces one prefill
and ``--steps`` decode steps with ``torch.profiler``.  For each of the two
phases it prints one JSON line: the host's wall time, the card's busy time (the
sum of the kernels' device times), the idle share, the number of kernels
launched, and the kernels that took most of the device time.  The first line
names the card and its power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.serving.engine import zeros_cache  # noqa: E402


def traced(fn, top: int = 8, pick=()) -> dict:
    """Runs ``fn`` once untraced for the host's wall time, then once under the
    profiler for the device times (tracing slows the host down); times in ms.
    ``pick``: substrings of kernel names whose calls and device time are
    summed apart, wherever they rank."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms == 0 else max(0.0, 1 - busy_ms / wall_ms),
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:80], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels[:top]],
        "picked": {p: {"calls": sum(e.count for e in kernels if p in e.key),
                       "device_ms": sum(e.self_device_time_total for e in kernels if p in e.key) / 1e3}
                   for p in pick},
    }


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-a", help="gpt-a or rwkv6-7b, at its full width")
    ap.add_argument("--layers", type=int, default=None, help="depth to run (default: the config's)")
    ap.add_argument("--steps", type=int, default=8, help="decode steps to trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"gpu": smi, "torch": torch.__version__}), flush=True)

    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, num_layers=args.layers or cfg.num_layers)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.cast_params(model.init(gen))
    B, T, max_len = 4, 512, 1024
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda", dtype=torch.int32)

    def prefill():
        return model.prefill(params, {"tokens": tokens}, zeros_cache(model, B, max_len, "cuda"))

    logits, cache = prefill()  # warm-up: builds the kernels, loads the libraries
    state = {"cache": cache, "tok": logits.argmax(-1).to(torch.int32),
             "pos": torch.full((B,), T, dtype=torch.int32, device="cuda")}

    def decode():
        for _ in range(args.steps):
            lg, state["cache"] = model.decode_step(params, state["cache"], state["tok"], state["pos"])
            state["tok"] = lg.argmax(-1).to(torch.int32)
            state["pos"] = state["pos"] + 1

    decode()  # warm-up
    out = traced(prefill)
    print(json.dumps({"phase": "prefill", "model": cfg.name, "batch": B, "prompt_tokens": T, "layers": cfg.num_layers, **out}), flush=True)
    out = traced(decode)
    for k in ("wall_ms", "device_busy_ms", "kernel_launches"):
        out[k + "_per_step"] = out.pop(k) / args.steps
    print(json.dumps({"phase": "decode", "model": cfg.name, "batch": B, "steps": args.steps, "layers": cfg.num_layers, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
