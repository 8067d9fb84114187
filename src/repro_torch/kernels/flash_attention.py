"""Blocked attention, forward and backward: the CUDA kernels' wrappers, their
plain versions, their launch counts and ``FlashAttentionFn``, the autograd
Function that joins them.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention_bhsd``
(body ``_flash_kernel``).  The forward is bound by operations on this card,
``4 * B * Hq * T * S * D`` (half when causal) over the tensor cores' rate.  The
dtype picks one of two hand-written kernels in ``csrc/flash_attention.cu``:
bf16 runs ``flash_mma_kernel`` on the tensor cores (``mma.sync`` on bf16 tiles
with f32 sums, ``cp.async`` fetching the next K/V tile during the products, P
rounded once to bf16 before P·V); f32 runs ``flash_kernel`` on the CUDA cores,
which keeps it within 2e-5 of the plain version.  Asked for it, either writes
the log-sum-exp of every query row's scaled scores, which the backward reads.

The backward is the port's counterpart of what XLA derives for the reference's
attention when it trains: the FlashAttention-2 form in
``csrc/flash_attention_bwd.cu``, the row sums D = rowsum(dO * O), then dK and
dV (the group's query heads summed inside the block) and dQ, P recomputed from
the LSE, no atomics, so two runs give the same bits.  bf16 runs them on
Hopper's warpgroup products (``wgmma``, tiles moved by TMA through a
four-stage ring, P and dS rounded to bf16 before their products, as the
forward rounds P); f32 on the CUDA cores, which keeps it within 1e-4 of the
plain backward.  Both take head sizes 32, 64, 80 and 128.

``fwd_cost`` and ``bwd_cost`` give each direction's bytes and operations; on
``meta`` tensors ``flash_attention_meta`` and ``flash_attention_bwd_meta``
allocate what the card's wrappers allocate and record the launch (``cost.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels._check import (
    DTYPE_CODES, FLASH_HEAD_DIMS, require, require_cuda, require_no_grad, require_rows_aligned,
    rows_aligned,
)

NEG_INF = -2.0**30
launches = 0  # one more for every forward kernel launch; reset by whoever wants to count a run
bwd_launches = 0  # one more for every backward launch (its three kernels count once)

Out = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def causal_pairs(T: int, S: int) -> int:
    """The (query, key) pairs a causal call computes: query t sees keys 0..t,
    as the kernels skip every tile above the diagonal."""
    if S >= T:
        return T * (T + 1) // 2
    return S * (S + 1) // 2 + (T - S) * S


def fwd_cost(B: int, T: int, S: int, Hq: int, Hkv: int, D: int, causal: bool, dtype: torch.dtype,
             lse: bool = False) -> cost.Cost:
    """q read and o written (B, T, Hq, D), k and v read (B, S, Hkv, D), and with
    ``lse`` the (B, Hq, T) f32 log-sum-exp written; two products of 2 D
    operations a pair, each pair the kernel does not skip."""
    pairs = causal_pairs(T, S) if causal else T * S
    nbytes = (2 * B * T * Hq * D + 2 * B * S * Hkv * D) * dtype.itemsize + (B * Hq * T * 4 if lse else 0)
    return nbytes, 4 * B * Hq * D * pairs, cost.rate(dtype)


def bwd_cost(B: int, T: int, S: int, Hq: int, Hkv: int, D: int, causal: bool, dtype: torch.dtype) -> cost.Cost:
    """q, o and dO read and dq written (B, T, Hq, D), k and v read and dk and
    dv written (B, S, Hkv, D), the LSE read and the row sums D written (B, Hq,
    T, f32); five products of 2 D operations a pair (S and dP, dV, dS to dQ and
    dK), each pair the kernels do not skip."""
    pairs = causal_pairs(T, S) if causal else T * S
    nbytes = (4 * B * T * Hq * D + 4 * B * S * Hkv * D) * dtype.itemsize + 2 * B * Hq * T * 4
    return nbytes, 5 * 2 * B * Hq * D * pairs, cost.rate(dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, scale: float) -> torch.Tensor:
    """(B, Hkv, G, T, S) f32 scores q k^T scale, causally hidden keys at NEG_INF."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qf = (q.float() * scale).reshape(B, T, Hkv, Hq // Hkv, D)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    if causal:
        idx_t = torch.arange(T, device=q.device)[:, None]
        idx_s = torch.arange(S, device=q.device)[None, :]
        s = torch.where(idx_t >= idx_s, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_plain(
    q: torch.Tensor,  # (B, T, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Out:
    """Softmax(q k^T scale [+ causal mask by index]) v; f32 inside, output in
    q's dtype.  With ``return_lse`` also the (B, Hq, T) f32 log-sum-exp of
    each query row's scaled scores."""
    B, T, Hq, D = q.shape
    scale = scale if scale is not None else D**-0.5
    s = _scores(q, k, causal, scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float()).reshape(B, T, Hq, D).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, Hq, T)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    *, causal: bool, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the shapes and dtypes of q, k, v, from the forward's o
    and lse (B, Hq, T); f32 inside.  P = exp(s - lse), D = rowsum(dO o),
    dS = P (dO v^T - D); dq = scale dS k, dk = scale dS^T q and dv = P^T dO,
    the last two summed over the G query heads of each kv head."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D**-0.5
    p = torch.exp(_scores(q, k, causal, scale) - lse.reshape(B, Hkv, G, T, 1))
    dof = do.float().reshape(B, T, Hkv, G, D)
    rowsum = (dof * o.float().reshape(B, T, Hkv, G, D)).sum(-1).permute(0, 2, 3, 1)  # (B, Hkv, G, T)
    dp = torch.einsum("btkgd,bskd->bkgts", dof, v.float())
    ds = p * (dp - rowsum[..., None])
    qf = q.float().reshape(B, T, Hkv, G, D)
    dq = torch.einsum("bkgts,bskd->btkgd", ds, k.float()) * scale
    dk = sum(torch.einsum("bkts,btkd->bskd", ds[:, :, g], qf[:, :, :, g]) for g in range(G)) * scale
    dv = sum(torch.einsum("bkts,btkd->bskd", p[:, :, g], dof[:, :, :, g]) for g in range(G))
    return dq.reshape(B, T, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _fwd_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, return_lse: bool) -> Tuple:
    """The forward's checks of its shapes, types and strides and its outputs,
    which the card's wrapper and the meta wrapper share: (B, T, S, Hq, Hkv,
    D, o, lse or None)."""
    require(q.dtype in DTYPE_CODES and k.dtype == q.dtype and v.dtype == q.dtype,
            f"flash_attention: q, k, v of one type, f32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape, "flash_attention: q (B,T,Hq,D), k and v (B,S,Hkv,D)")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    require(k.shape[0] == B and k.shape[3] == D, f"flash_attention: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    require(D in FLASH_HEAD_DIMS, f"flash_attention: head size {D} not in {FLASH_HEAD_DIMS}")
    require(Hkv >= 1 and Hq % Hkv == 0, f"flash_attention: {Hq} query heads over {Hkv} kv heads")
    require(B >= 1 and T >= 1 and S >= 1, "flash_attention: empty input")
    require(Hq <= 65535 and B <= 65535, "flash_attention: too many heads or batch rows for one grid")
    for what, t in (("q", q), ("k", k), ("v", v)):
        require_rows_aligned("flash_attention", what, t)
    o = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device) if return_lse else None
    return B, T, S, Hq, Hkv, D, o, lse


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, scale: Optional[float] = None,
    return_lse: bool = False,
) -> Out:
    """q (B, T, Hq, D), k and v (B, S, Hkv, D) on the card, read through their
    strides (so a transposed or sliced view costs no copy) -> (B, T, Hq, D)
    contiguous, and with ``return_lse`` the (B, Hq, T) f32 log-sum-exp of the
    scaled scores.  T and S need divide nothing.  Launches the kernel."""
    global launches
    require_no_grad("flash_attention", q, k, v)
    require_cuda("flash_attention", q, k, v)
    B, T, S, Hq, Hkv, D, o, lse = _fwd_call(q, k, v, return_lse)
    scale = scale if scale is not None else D**-0.5
    lib = build.load()
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 0 if lse is None else lse.data_ptr(),
        B, T, S, Hq, Hkv, D, float(scale),
        int(bool(causal)), DTYPE_CODES[q.dtype], *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "flash_attention")
    launches += 1
    return o if lse is None else (o, lse)


def flash_attention_meta(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, scale: Optional[float] = None,
    return_lse: bool = False,
) -> Out:
    """``flash_attention_cuda`` on ``meta``: its checks and its outputs (o, and
    the LSE), one launch recorded."""
    require_no_grad("flash_attention", q, k, v)
    B, T, S, Hq, Hkv, D, o, lse = _fwd_call(q, k, v, return_lse)
    cost.record("flash_attention", fwd_cost(B, T, S, Hq, Hkv, D, causal, q.dtype, lse=return_lse))
    return o if lse is None else (o, lse)


def _bwd_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
              do: torch.Tensor) -> Tuple:
    """The backward's checks of its shapes, types and strides, its outputs and
    its scratch, which the card's wrapper and the meta wrapper share: (B, T,
    S, Hq, Hkv, D, dq, dk, dv, rowsum), ``rowsum`` the (B, Hq, T) f32 row sums."""
    require(q.dtype in DTYPE_CODES and all(t.dtype == q.dtype for t in (k, v, o, do)),
            f"flash_attention_bwd: q, k, v, o, dO of one type, f32 or bf16, got {[t.dtype for t in (q, k, v, o, do)]}")
    require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape and o.shape == q.shape and do.shape == q.shape,
            "flash_attention_bwd: q, o, dO (B,T,Hq,D), k and v (B,S,Hkv,D)")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    require(k.shape[0] == B and k.shape[3] == D, f"flash_attention_bwd: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    require(D in FLASH_HEAD_DIMS, f"flash_attention_bwd: head size {D} not in {FLASH_HEAD_DIMS}")
    require(Hkv >= 1 and Hq % Hkv == 0, f"flash_attention_bwd: {Hq} query heads over {Hkv} kv heads")
    require(B >= 1 and T >= 1 and S >= 1, "flash_attention_bwd: empty input")
    require(Hq <= 65535 and B <= 65535, "flash_attention_bwd: too many heads or batch rows for one grid")
    require(lse.dtype == torch.float32 and lse.shape == (B, Hq, T) and lse.is_contiguous(),
            f"flash_attention_bwd: lse must be ({B}, {Hq}, {T}) f32 contiguous, got {tuple(lse.shape)} {lse.dtype}")
    for what, t in (("q", q), ("k", k), ("v", v), ("o", o), ("dO", do)):
        require_rows_aligned("flash_attention_bwd", what, t)
    dq = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=q.device)
    rowsum = torch.empty((B, Hq, T), dtype=torch.float32, device=q.device)
    return B, T, S, Hq, Hkv, D, dq, dk, dv, rowsum


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    *, causal: bool, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card: q, o and dO (B, T, Hq, D), k and v (B, S, Hkv,
    D), all read through their strides, lse (B, Hq, T) f32 contiguous as the
    forward wrote it -> (dq, dk, dv) contiguous in the shapes and dtype of q,
    k, v.  D is one of ``FLASH_HEAD_DIMS`` (32, 64, 80, 128); T and S need
    divide nothing.  Launches the three backward kernels."""
    global bwd_launches
    require_no_grad("flash_attention_bwd", q, k, v, o, do)
    require_cuda("flash_attention_bwd", q, k, v, o, lse, do)
    B, T, S, Hq, Hkv, D, dq, dk, dv, rowsum = _bwd_call(q, k, v, o, lse, do)
    scale = scale if scale is not None else D**-0.5
    lib = build.load()
    code = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), rowsum.data_ptr(),
        B, T, S, Hq, Hkv, D, float(scale), int(bool(causal)), DTYPE_CODES[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *do.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


def flash_attention_bwd_meta(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    *, causal: bool, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_attention_bwd_cuda`` on ``meta``: its checks, its outputs and the
    row sums, one launch recorded."""
    require_no_grad("flash_attention_bwd", q, k, v, o, do)
    B, T, S, Hq, Hkv, D, dq, dk, dv, rowsum = _bwd_call(q, k, v, o, lse, do)
    cost.record("flash_attention_bwd", bwd_cost(B, T, S, Hq, Hkv, D, causal, q.dtype))
    del rowsum
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """o = attention(q, k, v) with a hand-written backward: on the card the
    forward launches the forward kernel with its LSE output and the backward
    the three backward kernels; on the CPU both use the plain versions; on
    ``meta`` both take the card's path to its meta wrappers.  Saves q, k, v, o
    and the LSE."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float]):
        scale = scale if scale is not None else q.shape[-1] ** -0.5
        fwd = flash_attention_plain if q.device.type == "cpu" else (
            flash_attention_meta if cost.on_meta(q) else flash_attention_cuda)
        o, lse = fwd(q, k, v, causal=causal, scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cpu":
            grads = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=ctx.causal, scale=ctx.scale)
        else:
            # the kernels read dO through its strides, but its rows must be
            # contiguous and start on 16 bytes: autograd may hand over an
            # expanded or otherwise strided gradient, which is copied then only
            if do.stride(-1) != 1 or not rows_aligned(do):
                do = do.contiguous()
            bwd = flash_attention_bwd_meta if cost.on_meta(do) else flash_attention_bwd_cuda
            grads = bwd(q, k, v, o, lse, do, causal=ctx.causal, scale=ctx.scale)
        return (*grads, None, None)
