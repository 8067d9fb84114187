#!/usr/bin/env python3
"""K1 (RMSNorm, forward and backward), K2's backward and K4 (WKV-6, forward and
backward) kernels of a checkout, timed on the card.

    python3 experiments/torch_kernel_ab.py [--src DIR] [--label NAME] [--skip-sweep]

Needs one NVIDIA Hopper card and ``nvcc``.  Imports ``repro_torch`` from
``--src`` (default: this checkout's ``src``), so that two checkouts can be
timed in turns on one card, e.g. a parent unpacked with
``git archive`` into a directory that ``.gitignore`` lists.  Times, in ms of
device time (CUDA events around queued calls, median of 7 rounds, as
``chip_smoke.py`` times them):

* K1 at a prefill's rows, x (2048, 4096) bf16, and a decode step's, (4, 4096);
* K1's backward at a training step's rows, x and dy (2048, 4096) bf16, and
  (``rmsnorm_bwd_split_ms``) each of its two kernels' device time a launch,
  from ``torch.profiler``;
* K2's backward (``flash_attention_bwd_cuda``, bf16) at GPT-A's training
  shape, q, k, v, o, dO (4, 512, 32, 128) causal, at a 4K context, (1, 4096,
  32, 128) causal, and at HuBERT-XLarge's, (4, 1024, 16, 80) non-causal: the
  whole call, each of its kernels' device time a launch (``torch.profiler``),
  the backward of ``F.scaled_dot_product_attention`` on a graph built
  beforehand, and the card's bound; a checkout whose wrapper refuses a shape
  gets ``"refused"`` there.  Beside them, what ``ptxas -v`` said of the
  checkout's ``flash_bwd`` kernels;
* K4 at RWKV-6 7B's prefill, r, k, v (4, 512, 64, 64) bf16 with a state, and
  its decode step, (4, 1, 64, 64);
* K4's backward (``wkv6_bwd_cuda``) at RWKV-6 7B's training shape, r, k, v,
  dy (4, 512, 64, 64) bf16: the whole call and each of its kernels' device
  time a launch (``torch.profiler``); where the checkout has
  ``wkv6.CHUNKED_BWD_T_MIN``, also its sequential passes forced by that
  threshold, in the same process;
* unless ``--skip-sweep`` is given: where the checkout has
  ``wkv6.CHUNKED_T_MIN``, both K4 kernels at (4, T, 64, 64) bf16 for T from 1
  to 128, and where it has ``wkv6.CHUNKED_BWD_T_MIN``, both backward routes at
  (4, T, 64, 64) bf16 for T from 1 to 256, each forced by setting its
  threshold, which is how the thresholds are chosen.

Prints one JSON line per group and, first, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

SPIN_CYCLES = 20_000_000  # about 10 ms of the card's clock
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12  # one H100 SXM's published peaks at 700 W


def time_ms(fn, arg_sets, iters: int = 20, reps: int = 7) -> float:
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernel_times_ms(fn, arg_sets, iters: int = 20) -> dict:
    """{kernel name: device ms a launch} of the kernels ``fn`` launches, from
    torch.profiler's device time over ``iters`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def ptxas_lines(log: str, sub: str) -> dict:
    """{mangled kernel name: "registers; spills"} of the kernels whose name
    holds ``sub``, from what ``ptxas -v`` printed."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if sub in ln else None
        elif fn and "Used" in ln and "registers" in ln:
            out[fn] = ln.split("Used", 1)[1].split(",")[0].strip() + "; " + out.get(fn, "")
        elif fn and "spill" in ln:
            out[fn] = out.get(fn, "") + ln.split(":", 1)[-1].strip()
    return out


def flash_bwd_row(fa_mod, randn, B, T, H, D, causal) -> dict:
    """K2's backward at (B, T, H, D) bf16: the whole call, its kernels apart,
    the library's backward and the bound (inputs read once, outputs written once)."""
    import torch.nn.functional as F  # timed here as a yardstick; the port never calls it

    dt = torch.bfloat16
    sets, lib_sets = [], []
    for _ in range(2):
        q, k, v, do = (randn((B, T, H, D), dt) for _ in range(4))
        o, lse = fa_mod.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        sets.append((q, k, v, o, lse, do))
        leaves = [t.transpose(1, 2).clone().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            lib_sets.append((F.scaled_dot_product_attention(*leaves, is_causal=causal), *leaves, do.transpose(1, 2)))
    nbytes = 8 * B * T * H * D * 2 + 2 * B * H * T * 4  # q, k, v, o, dO read, dq, dk, dv written; lse, D
    flops = 5 * 2 * B * H * D * (T * (T + 1) // 2 if causal else T * T)  # five products
    row = {"shape": f"q,k,v,o,dO ({B},{T},{H},{D}) bf16 {'causal' if causal else 'non-causal'}",
           "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "operations",
           "library_ms": time_ms(lambda y, a, b, c, g: torch.autograd.grad(y, (a, b, c), g, retain_graph=True),
                                 lib_sets, iters=5)}

    def bwd(q, k, v, o, lse, do):
        return fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)

    try:
        bwd(*sets[0])
    except ValueError as e:
        return {**row, "ms": "refused", "why": str(e)}
    return {**row, "ms": time_ms(bwd, sets, iters=5), "split_ms": kernel_times_ms(bwd, sets, iters=5)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--skip-sweep", action="store_true", help="leave out the sweeps of K4's routes over T")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rmsnorm as rms_mod
    from repro_torch.kernels import wkv6 as wkv_mod

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def wkv_set(B, T, H=64, D=64):
        r, k, v = (randn((B, T, H, D)).mul_(0.5).to(torch.bfloat16) for _ in range(3))
        logw = -torch.exp(randn((B, T, H, D)) * 0.5 - 2.0)
        return r, k, v, logw, randn((H, D)) * 0.1, randn((B, H, D, D)) * 0.5

    def wkv(r, k, v, w, u, S):
        return kops.wkv6(r, k, v, w, u, S)

    def wkv_bwd_set(B, T, H=64, D=64):
        r, k, v, logw, u, _ = wkv_set(B, T, H, D)
        return r, k, v, logw, u, randn((B, T, H, D), torch.bfloat16)

    bwd_t_min = getattr(wkv_mod, "CHUNKED_BWD_T_MIN", None)

    def on_bwd_route(t_min, fn, *a):
        """fn(*a) with the backward's threshold set to ``t_min`` for the call."""
        wkv_mod.CHUNKED_BWD_T_MIN = t_min
        try:
            return fn(*a)
        finally:
            wkv_mod.CHUNKED_BWD_T_MIN = bwd_t_min

    with torch.no_grad():
        out = {"label": args.label, "src": args.src}
        for key, N, nsets in (("rmsnorm_ms", 2048, 6), ("rmsnorm_decode_ms", 4, 8)):
            sets = [(randn((N, 4096), torch.bfloat16), randn((4096,))) for _ in range(nsets)]
            out[key] = time_ms(lambda x, s: kops.rmsnorm(x, s), sets)
        sets = [(randn((2048, 4096), torch.bfloat16), randn((4096,)), randn((2048, 4096), torch.bfloat16))
                for _ in range(4)]
        out["rmsnorm_bwd_ms"] = time_ms(rms_mod.rmsnorm_bwd_rows, sets)
        out["rmsnorm_bwd_split_ms"] = kernel_times_ms(rms_mod.rmsnorm_bwd_rows, sets)
        del sets
        out["flash_bwd"] = [flash_bwd_row(fa_mod, randn, *shape)
                            for shape in ((4, 512, 32, 128, True), (1, 4096, 32, 128, True), (4, 1024, 16, 80, False))]
        out["flash_bwd_ptxas"] = ptxas_lines(build.build_log, "flash_bwd")
        out["wkv6_ms"] = time_ms(wkv, [wkv_set(4, 512) for _ in range(2)])
        out["wkv6_decode_ms"] = time_ms(wkv, [wkv_set(4, 1) for _ in range(8)])
        sets = [wkv_bwd_set(4, 512) for _ in range(2)]
        out["wkv6_bwd_ms"] = time_ms(wkv_mod.wkv6_bwd_cuda, sets)
        out["wkv6_bwd_split_ms"] = kernel_times_ms(wkv_mod.wkv6_bwd_cuda, sets, iters=10)
        if bwd_t_min is not None:  # the sequential passes of the same checkout, forced
            out["wkv6_bwd_sequential_ms"] = on_bwd_route(1 << 30, time_ms, wkv_mod.wkv6_bwd_cuda, sets)
        out["wkv6_bwd_ptxas"] = ptxas_lines(build.build_log, "wkv6_bwd")
        del sets
        print(json.dumps(out), flush=True)

        t_min = getattr(wkv_mod, "CHUNKED_T_MIN", None)
        if t_min is not None and not args.skip_sweep:
            sweep = []
            for T in (1, 2, 4, 8, 16, 24, 32, 36, 40, 48, 64, 128):
                sets = [wkv_set(4, T) for _ in range(4)]
                row = {"T": T}
                for name, forced in (("sequential_ms", 1 << 30), ("chunked_ms", 1)):
                    wkv_mod.CHUNKED_T_MIN = forced
                    row[name] = time_ms(wkv, sets)
                sweep.append(row)
            wkv_mod.CHUNKED_T_MIN = t_min
            print(json.dumps({"label": args.label, "chunked_t_min": t_min, "wkv6_sweep": sweep}), flush=True)
        if bwd_t_min is not None and not args.skip_sweep:
            sweep = []
            for T in (1, 2, 4, 8, 16, 24, 32, 48, 64, 96, 128, 192, 256):
                sets = [wkv_bwd_set(4, T) for _ in range(4)]
                sweep.append({"T": T, "sequential_ms": on_bwd_route(1 << 30, time_ms, wkv_mod.wkv6_bwd_cuda, sets),
                              "chunked_ms": on_bwd_route(1, time_ms, wkv_mod.wkv6_bwd_cuda, sets)})
            print(json.dumps({"label": args.label, "chunked_bwd_t_min": bwd_t_min, "wkv6_bwd_sweep": sweep}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
