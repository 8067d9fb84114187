#!/usr/bin/env python3
"""How far correct ways of computing the MoE family (and Zamba2's hybrid) part
on the card, in bf16.

    python3 experiments/torch_moe_parity.py [--arch qwen2-moe-a2.7b|deepseek-v2-lite-16b|zamba2-2.7b] [--layers N]

Needs one NVIDIA Hopper card and ``nvcc``.  Makes the model at full width
(depth ``--layers``, default the config's) with its weights made directly in
bf16 from seed 0, prefills 4 prompts of 512 random tokens and takes one decode
step, on several paths at once (``chip_smoke.run_paths``), each held against
``plain`` (the plain RMSNorm and the masked plain sdpa):

- ``kernel``: the serving path, the RMSNorm, flash and decode kernels;
- ``plain_pinned``: the plain path routed as the kernel path routed, so that
  it differs from ``kernel`` only in its continuous arithmetic;
- ``reverse``: the plain path with its sums in another order (each RMSNorm
  row's mean of squares over the reversed row, each sdpa over the slots in
  reverse);
- ``p_bf16``: the plain path whose attention rounds its probabilities to bf16
  before P·V (``sdpa_p_bf16``), the one extra rounding of
  ``flash_mma_kernel``'s design (``tests/test_torch_flash_mma.py``), and
  otherwise the same;
- ``kernel_reverse``: the kernel path with the plain RMSNorm over reversed rows;
- ``plain_chunk64`` (Zamba2 only): the plain path with the Mamba2 scan in
  chunks of 64 (``chip_smoke.ssd_chunk``), the control ``chip_smoke.py`` holds
  the hybrid's bf16 kernel path against.

For each path it prints the logits' largest gap to ``plain`` after the
prefill and after the decode step, the share of (layer, token) routes whose
top-k sets agree with ``plain``'s, and that share layer by layer (a model
without routes: the ssm state's gap instead); then the
kernel path's gaps to ``plain_pinned``.  The last
line but one names the card and its power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402


def sdpa_p_bf16(q, k, v, q_pos, kv_pos, *, causal, window=None, scale=None):
    """``attention.sdpa``'s masked plain branch with P rounded to q's dtype
    before P·V, as ``flash_mma_kernel`` rounds it (tests/test_torch_flash_mma.py)."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D**-0.5
    qf = (q.float() * scale).reshape(B, T, Hkv, Hq // Hkv, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    mask = (kv_pos[:, None, :] >= 0).expand(B, T, S)
    if causal:
        mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])
    scores = torch.where(mask[:, None, None], scores, torch.full_like(scores, attention.NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(B, T, Hq, v.shape[-1]).to(q.dtype)


def rmsnorm_reversed(x, scale, *, eps=1e-6):
    """The plain RMSNorm with each row's mean of squares summed over the reversed row."""
    return rms_mod.rmsnorm_plain(x.flip(-1), scale.flip(-1), eps).flip(-1)


@contextlib.contextmanager
def swapped(plain=True, rmsnorm=None, sdpa=None):
    """The plain path (``chip_smoke.plain_path``), or with ``plain`` false the
    kernel path, with ``rmsnorm`` in place of ``kops.rmsnorm`` and ``sdpa`` in
    place of ``attention.sdpa`` where they are given."""
    saved = kops.rmsnorm, attention.sdpa
    with cs.plain_path() if plain else contextlib.nullcontext():
        kops.rmsnorm = rmsnorm or kops.rmsnorm
        attention.sdpa = sdpa or attention.sdpa
        try:
            yield
        finally:
            kops.rmsnorm, attention.sdpa = saved


SDPA = attention.sdpa


def sdpa_reversed(q, k, v, q_pos, kv_pos, **kw):
    """The plain sdpa over the slots in reverse: the mask reads positions, not slots."""
    return SDPA(q, k.flip(1), v.flip(1), q_pos, kv_pos.flip(1), **kw)


PATHS = {"kernel": contextlib.nullcontext, "plain": cs.plain_path, "plain_pinned": cs.plain_path,
         "reverse": lambda: swapped(rmsnorm=rmsnorm_reversed, sdpa=sdpa_reversed),
         "p_bf16": lambda: swapped(sdpa=sdpa_p_bf16),
         "kernel_reverse": lambda: swapped(plain=False, rmsnorm=rmsnorm_reversed)}


def by_layer(a: list, b: list, L: int) -> list:
    return [round(cs.route_agreement(a[i:i + 1], b[i:i + 1]), 4) for i in range(L)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-moe-a2.7b")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, num_layers=args.layers or cfg.num_layers)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    params = model.init(gen, dtype=cfg.dtype)
    tokens = torch.from_numpy(np.random.default_rng(cs.SEED).integers(0, cfg.vocab_size, (4, 512))).to("cuda")
    paths = dict(PATHS)
    if cfg.ssm is not None:
        paths["plain_chunk64"] = lambda: cs.ssd_chunk(model, 64)
    out = cs.run_paths(model, params, tokens, paths)
    plain = out["plain"]
    rows = {}
    for name, o in out.items():
        if name == "plain":
            continue
        g = cs.gaps(o, plain)
        if o["routes_prefill"]:
            g["route_agreement_by_layer"] = by_layer(o["routes_prefill"], plain["routes_prefill"], cfg.num_layers)
        rows[name] = g
    pinned = cs.gaps(out["kernel"], out["plain_pinned"])  # what chip_smoke.py holds within PARITY_TOL
    print(json.dumps({"model": cfg.name, "layers": cfg.num_layers, "dtype": "bf16",
                      "logit_abs_max": plain["prefill"].abs().max().item(), "against_plain": rows,
                      "kernel_against_plain_pinned": pinned}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
