"""Blocked attention forward: the CUDA kernel's wrapper, its plain version and
its launch count.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention_bhsd``
(body ``_flash_kernel``).  Bound by operations on this card, ``4 * B * Hq * T *
S * D`` (half when causal) over the tensor cores' rate.  The dtype picks one of
two hand-written kernels in ``csrc/flash_attention.cu``: bf16 runs
``flash_mma_kernel`` on the tensor cores (``mma.sync`` on bf16 tiles with f32
sums, ``cp.async`` fetching the next K/V tile during the products, P rounded
once to bf16 before P·V); f32 runs ``flash_kernel`` on the CUDA cores, which
keeps it within 2e-5 of the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels._check import DTYPE_CODES, HEAD_DIMS, require, require_cuda, require_no_grad, require_rows_aligned

NEG_INF = -2.0**30
launches = 0  # one more for every kernel launch; reset by whoever wants to count a run


def flash_attention_plain(
    q: torch.Tensor,  # (B, T, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax(q k^T scale [+ causal mask by index]) v; f32 inside, output in q's dtype."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D**-0.5
    qf = (q.float() * scale).reshape(B, T, Hkv, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    if causal:
        idx_t = torch.arange(T, device=q.device)[:, None]
        idx_s = torch.arange(S, device=q.device)[None, :]
        s = torch.where(idx_t >= idx_s, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return o.reshape(B, T, Hq, D).to(q.dtype)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, scale: Optional[float] = None
) -> torch.Tensor:
    """q (B, T, Hq, D), k and v (B, S, Hkv, D) on the card, read through their
    strides (so a transposed or sliced view costs no copy) -> (B, T, Hq, D)
    contiguous.  T and S need divide nothing.  Launches the kernel."""
    global launches
    require_no_grad("flash_attention", q, k, v)
    require_cuda("flash_attention", q, k, v)
    require(q.dtype in DTYPE_CODES and k.dtype == q.dtype and v.dtype == q.dtype,
            f"flash_attention: q, k, v of one type, f32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape, "flash_attention: q (B,T,Hq,D), k and v (B,S,Hkv,D)")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    require(k.shape[0] == B and k.shape[3] == D, f"flash_attention: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    require(D in HEAD_DIMS, f"flash_attention: head size {D} not in {HEAD_DIMS}")
    require(Hkv >= 1 and Hq % Hkv == 0, f"flash_attention: {Hq} query heads over {Hkv} kv heads")
    require(B >= 1 and T >= 1 and S >= 1, "flash_attention: empty input")
    require(Hq <= 65535 and B <= 65535, "flash_attention: too many heads or batch rows for one grid")
    for what, t in (("q", q), ("k", k), ("v", v)):
        require_rows_aligned("flash_attention", what, t)
    scale = scale if scale is not None else D**-0.5
    o = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    lib = build.load()
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, T, S, Hq, Hkv, D, float(scale),
        int(bool(causal)), DTYPE_CODES[q.dtype], *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "flash_attention")
    launches += 1
    return o
