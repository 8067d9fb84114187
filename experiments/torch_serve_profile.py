#!/usr/bin/env python3
"""Where the time goes when ``repro_torch`` serves a model on the card.

    python3 experiments/torch_serve_profile.py [--arch gpt-a|rwkv6-7b|qwen2-moe-a2.7b|deepseek-v2-lite-16b]
        [--layers N] [--steps 8]

Needs one NVIDIA Hopper card and ``nvcc``.  Serves one batch of 4 prompts of
512 tokens at full width (random weights from a seed) and traces one prefill
and ``--steps`` decode steps with ``torch.profiler`` (``chip_smoke.traced``,
the attention and MoE layers marked as ranges).  For each of the two phases it
prints one JSON line: the host's wall time, the card's busy time (the sum of
the kernels' device times), the idle share, the number of kernels launched,
the device time under each range and of each ported kernel, and the kernels
that took most of the device time.  The first line names the card and its
power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.serving.engine import zeros_cache  # noqa: E402


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-a", help="a served architecture, at its full width")
    ap.add_argument("--layers", type=int, default=None, help="depth to run (default: the config's)")
    ap.add_argument("--steps", type=int, default=8, help="decode steps to trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    print(json.dumps({"gpu": cs.nvidia_smi_line(), "torch": torch.__version__}), flush=True)

    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, num_layers=args.layers or cfg.num_layers)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = model.init(gen, dtype=cfg.dtype)  # the bits of cast_params(init(gen)), without the f32 master
    B, T, max_len = 4, 512, 1024
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device="cuda", dtype=torch.int32)

    def prefill():
        return model.prefill(params, {"tokens": tokens}, zeros_cache(model, B, max_len, "cuda"))

    logits, cache = prefill()  # the decode steps' cache; builds the kernels, loads the libraries
    state = {"cache": cache, "tok": logits.argmax(-1).to(torch.int32),
             "pos": torch.full((B,), T, dtype=torch.int32, device="cuda")}

    def decode():
        for _ in range(args.steps):
            lg, state["cache"] = model.decode_step(params, state["cache"], state["tok"], state["pos"])
            state["tok"] = lg.argmax(-1).to(torch.int32)
            state["pos"] = state["pos"] + 1

    ranges = cs.serving_ranges(cfg)
    out = cs.traced(prefill, ranges, top=8)
    print(json.dumps({"phase": "prefill", "model": cfg.name, "batch": B, "prompt_tokens": T, "layers": cfg.num_layers, **out}), flush=True)
    out = cs.traced(decode, ranges, top=8)
    for k in ("wall_ms", "device_busy_ms", "kernel_launches"):
        out[k + "_per_step"] = out.pop(k) / args.steps
    print(json.dumps({"phase": "decode", "model": cfg.name, "batch": B, "steps": args.steps, "layers": cfg.num_layers, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
