#!/usr/bin/env python3
"""K3 ``decode_attention``'s device time against its split plan's target and
the depth of its bf16 copy ring.

    python3 experiments/torch_decode_plan.py [--blocks-per-sm 1 2 3 4 6] [--stages 2 3 2]

Needs one NVIDIA Hopper card and ``nvcc``.  For each depth of the copy ring
(``STAGES`` of ``csrc/decode_attention.cu``; a depth other than the source's
is built from a copy of ``csrc/`` under ``build/`` with that one number
changed) and each value of
``repro_torch.kernels.decode_attention.BLOCKS_PER_SM`` (the blocks a SM the
plan aims the grid at), it times K3 in bf16 with 32 heads of 128 at GPT-A's
decode shapes: 4 sequences 520 tokens into a ring of 1024 (``chip_smoke.py``'s
timed input), the ring full, one sequence of 310 tokens, and 4 sequences of
4000 tokens in a ring of 4096.  Times come from ``chip_smoke.time_ms`` (device
time between CUDA events, inputs cold in L2), the values of BLOCKS_PER_SM in
order and then in reverse, both kept.  Prints one JSON line a depth and shape,
the plan (slices, tiles a slice) beside each time, then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

SHAPES = [("timed", 4, 1024, 520, 4), ("full", 4, 1024, 1024, 4), ("single", 1, 1024, 310, 8),
          ("long", 4, 4096, 4000, 2)]  # (label, B, S, filled, input sets)
SOURCE_CSRC = build.CSRC
STAGES_LINE = "constexpr int STAGES = 2;"  # the depth of K3's ring in the source


def use_stages(n: int) -> None:
    """Loads the kernels built with an n-deep ring in K3."""
    csrc = SOURCE_CSRC
    if n != 2:
        root = build.build_dir() / f"k3_stages{n}"
        csrc = root / SOURCE_CSRC.relative_to(SOURCE_CSRC.parents[3])
        shutil.copytree(SOURCE_CSRC, csrc, dirs_exist_ok=True)
        text = (SOURCE_CSRC / "decode_attention.cu").read_text()
        if STAGES_LINE not in text:
            raise RuntimeError("the ring's depth is not where this script looks for it")
        (csrc / "decode_attention.cu").write_text(text.replace(STAGES_LINE, f"constexpr int STAGES = {n};", 1))
    build.CSRC, build._lib = csrc, None
    build.load()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks-per-sm", type=int, nargs="+", default=[1, 2, 3, 4, 6])
    ap.add_argument("--stages", type=int, nargs="+", default=[2])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_plan: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    H, D, dt = 32, 128, torch.bfloat16
    values = args.blocks_per_sm
    inputs = {}
    for label, B, S, filled, nsets in SHAPES:
        ar = torch.arange(S, device="cuda", dtype=torch.int32)[None].expand(B, S)
        kv_pos = torch.where(ar < filled, ar, -1).contiguous()
        q_pos = torch.full((B, 1), filled - 1, device="cuda", dtype=torch.int32)
        inputs[label] = [(cs.randn(gen, (B, 1, H, D), dt), cs.randn(gen, (B, S, H, D), dt),
                          cs.randn(gen, (B, S, H, D), dt), q_pos, kv_pos) for _ in range(nsets)]
    for stages in args.stages:
        use_stages(stages)
        for label, B, S, filled, _ in SHAPES:
            rows = {bps: {"plan": None, "ms": []} for bps in values}
            for order in (values, values[::-1]):
                for bps in order:
                    dec_mod.BLOCKS_PER_SM = bps
                    rows[bps]["plan"] = dec_mod.split_plan(B, H, S, sm_count)
                    rows[bps]["ms"].append(cs.time_ms(
                        lambda q, k, v, qp, kp: kops.decode_attention(q, k, v, qp, kp), inputs[label]))
            print(json.dumps({"stages": stages, "shape": label, "B": B, "S": S, "filled": filled,
                              "sm_count": sm_count, "by_blocks_per_sm": {str(bps): row for bps, row in rows.items()}}),
                  flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
