#!/usr/bin/env python3
"""How far two correct ways of computing RWKV-6 7B part on the card, layer by layer.

    python3 experiments/torch_rwkv_parity.py [--layers 32] [--batch 4] [--tokens 512]

Needs one NVIDIA Hopper card and ``nvcc``.  Makes RWKV-6 7B at full width
(random weights from a seed), prefills one batch of random tokens and follows
the hidden state through the stack for several paths at once, each from the
same embeddings:

- ``kernel``: the serving path, the RMSNorm and WKV-6 CUDA kernels;
- ``plain``: the plain RMSNorm and the plain chunked WKV-6 (chunk 128);
- ``plain_c64``: the same plain path with chunks of 64, an equally exact
  order of the same sums;
- ``kernel_wkv``: the WKV-6 kernel with the plain RMSNorm.

For f32 and for bf16 activations it prints, after every layer, each path's
largest difference from ``plain`` over the largest entry of ``plain``, then
the same for the last token's logits and for the final wkv state.  A first
line holds layer 0's recurrence alone on the model's own inputs: kernel and
plain against a float64 sequential recurrence.  The last line but one names
the card and its power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.kernels import wkv6 as wkv_mod  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models.modules import dense, rmsnorm  # noqa: E402
from repro_torch.models.transformer import _embed_tokens, _head_weight, _unstack, build_model  # noqa: E402

KERNEL_RMSNORM, KERNEL_WKV6 = kops.rmsnorm, kops.wkv6


def plain_rmsnorm(x, scale, *, eps=1e-6):
    return rms_mod.rmsnorm_plain(x, scale, eps)


def plain_wkv6(chunk):
    def op(r, k, v, logw, u, state=None, **_):
        y, S = wkv_mod.wkv6_plain(r, k, v, logw, u, state, chunk=chunk)
        if state is not None:
            state.copy_(S)
        return y
    return op


PATHS = {
    "kernel": (KERNEL_RMSNORM, KERNEL_WKV6),
    "plain": (plain_rmsnorm, plain_wkv6(128)),
    "plain_c64": (plain_rmsnorm, plain_wkv6(64)),
    "kernel_wkv": (plain_rmsnorm, KERNEL_WKV6),
}


@contextlib.contextmanager
def path(name):
    kops.rmsnorm, kops.wkv6 = PATHS[name]
    try:
        yield
    finally:
        kops.rmsnorm, kops.wkv6 = KERNEL_RMSNORM, KERNEL_WKV6


def rel(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def sequential64(r, k, v, logw, u):
    """y (B, T, H, D) and the final state of the recurrence, one step at a time in float64."""
    r, k, v, logw, u = (t.double() for t in (r, k, v, logw, u))
    B, T, H, D = r.shape
    S = torch.zeros((B, H, D, D), dtype=torch.float64, device=r.device)
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, t], S + u[None, :, :, None] * kv))
        S = S * logw[:, t].exp()[..., None] + kv
    return torch.stack(ys, 1), S


def layer0_wkv(model, params, x):
    """The recurrence of layer 0 on the model's own inputs, kernel and plain
    against the float64 sequential recurrence."""
    seen = {}

    def capture(r, k, v, logw, u, state=None, **_):
        seen.update(r=r.clone(), k=k.clone(), v=v.clone(), logw=logw.clone(), u=u.clone())
        return KERNEL_WKV6(r, k, v, logw, u, state)

    kops.wkv6 = capture
    try:
        rwkv.rwkv6_apply(_unstack(params["layers"], model.cfg.num_layers)[0], model.cfg, x, None)
    finally:
        kops.wkv6 = KERNEL_WKV6
    a = seen
    y64, S64 = sequential64(a["r"], a["k"], a["v"], a["logw"], a["u"])
    S = torch.zeros_like(S64, dtype=torch.float32)
    y_k = KERNEL_WKV6(a["r"], a["k"], a["v"], a["logw"], a["u"], S)
    y_p, S_p = wkv_mod.wkv6_plain(a["r"], a["k"], a["v"], a["logw"], a["u"], chunk=model.cfg.rwkv.chunk)
    chunk_sum = a["logw"].reshape(a["logw"].shape[0], -1, model.cfg.rwkv.chunk, *a["logw"].shape[2:]).sum(2)
    return {
        "y_abs_max": y64.abs().max().item(), "state_abs_max": S64.abs().max().item(),
        "logw_min": a["logw"].min().item(), "logw_max": a["logw"].max().item(),
        "chunk_logdecay_min": chunk_sum.min().item(),
        "kernel_y_rel": rel(y_k, y64), "plain_y_rel": rel(y_p, y64),
        "kernel_state_rel": rel(S, S64), "plain_state_rel": rel(S_p, S64),
        "dtype": str(a["r"].dtype).replace("torch.", ""),
    }


@torch.no_grad()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None, help="depth (default: the config's 32)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    base = get_config("rwkv6_7b")
    base = dataclasses.replace(base, num_layers=args.layers or base.num_layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    params32 = build_model(dataclasses.replace(base, dtype=torch.float32)).init(gen)
    tokens = torch.randint(0, base.vocab_size, (args.batch, args.tokens), generator=gen, device="cuda")

    for dtype in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(base, dtype=dtype)
        model = build_model(cfg)
        params = model.cast_params(params32)  # f32: the same tensors
        x0 = _embed_tokens(params, cfg, tokens)
        emit(dict(phase="layer0_wkv", **layer0_wkv(model, params, x0)))
        xs = {name: x0.clone() for name in PATHS}
        states = {name: {n: torch.zeros(s, dtype=d, device="cuda") for n, (s, d) in
                         rwkv.rwkv6_state_shape(cfg, args.batch).items()} for name in PATHS}
        wkv_last = {}
        for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
            for name in PATHS:
                st = states[name]
                for t in st.values():
                    t.zero_()
                with path(name):
                    xs[name], _ = rwkv.rwkv6_apply(lp, cfg, xs[name], st)
                wkv_last[name] = st["wkv"].clone() if i == cfg.num_layers - 1 else None
            emit({"phase": "layer", "dtype": str(dtype).replace("torch.", ""), "layer": i,
                  "x_abs_max": xs["plain"].abs().max().item(),
                  "rel_to_plain": {n: rel(xs[n], xs["plain"]) for n in PATHS if n != "plain"}})
        logits = {}
        for name in PATHS:
            with path(name):
                logits[name] = dense(_head_weight(params, cfg), rmsnorm(params["final_norm"], xs[name])[:, -1]).float()
        emit({"phase": "logits", "dtype": str(dtype).replace("torch.", ""),
              "logit_abs_max": logits["plain"].abs().max().item(),
              "abs_diff_to_plain": {n: (logits[n] - logits["plain"]).abs().max().item() for n in PATHS if n != "plain"},
              "argmax_agreement": {n: (logits[n].argmax(-1) == logits["plain"].argmax(-1)).float().mean().item()
                                   for n in PATHS if n != "plain"},
              "last_layer_wkv_rel": {n: rel(wkv_last[n], wkv_last["plain"]) for n in PATHS if n != "plain"}})
        del params, xs, states, wkv_last
        torch.cuda.empty_cache()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"ok": True})
    return 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


if __name__ == "__main__":
    sys.exit(main())
