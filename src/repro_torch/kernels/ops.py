"""Model-layout entry points of the kernels (``repro/kernels/ops.py``).

A tensor on the CPU goes to the kernel's plain version, and only because it
lies on the CPU; a tensor on the card launches the kernel or raises.  There is
no fall-back of any kind on the card: the kernels read the model's layouts
through strides and mask their own ragged edges, so T, S and N need divide
nothing.

Where gradients are enabled and an input requires grad, ``flash_attention``,
``rmsnorm`` and ``wkv6`` go through their autograd Functions
(``FlashAttentionFn``, ``RMSNormFn``, ``WKV6Fn``) on either device: on the
card the Function's forward and backward launch kernels, on the CPU they call
the plain forward and the plain backward, so the CPU tests run the backward
arithmetic the card runs.  WKV-6 is differentiated from a zero state only, as
the reference's loss runs it.  Decode attention has no backward: its wrapper
refuses such inputs.

A ``meta`` tensor (the dry-run, ``repro_torch.launch.dryrun``) takes the card's
path to the kernels' meta wrappers, which allocate what the card's wrappers
allocate, compute nothing and record the launch (``kernels/cost.py``).  No
plain version runs on ``meta``.  Any other device goes to the card's wrappers,
which raise unless it is the current CUDA device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import wkv6 as _wkv


def _differentiated(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(
    q: torch.Tensor,  # (B, T, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    if _differentiated(q, k, v):
        return _fa.FlashAttentionFn.apply(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return _fa.flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type == "meta":
        return _fa.flash_attention_meta(q, k, v, causal=causal, scale=scale)
    return _fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale)


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (B, 1) int32
    kv_pos: torch.Tensor,  # (B, S) int32
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return _dec.decode_attention_plain(q, k, v, q_pos, kv_pos, window=window, scale=scale)
    if q.device.type == "meta":
        return _dec.decode_attention_meta(q, k, v, q_pos, kv_pos, window=window, scale=scale)
    return _dec.decode_attention_cuda(q, k, v, q_pos, kv_pos, window=window, scale=scale)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d): the leading axes are flattened into rows for the kernel."""
    if _differentiated(x, scale):
        return _rms.RMSNormFn.apply(x, scale, eps)
    if x.device.type == "cpu":
        return _rms.rmsnorm_plain(x, scale, eps)
    if x.device.type == "meta":
        return _rms.rmsnorm_rows_meta(x.reshape(-1, x.shape[-1]), scale, eps).reshape(x.shape)
    return _rms.rmsnorm_rows(x.reshape(-1, x.shape[-1]), scale, eps).reshape(x.shape)


def wkv6(
    r: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # (B, T, H, D) f32, <= 0
    u: torch.Tensor,  # (H, D) f32
    state: Optional[torch.Tensor] = None,  # (B, H, D, D) f32
    *,
    chunk: int = 64,
) -> torch.Tensor:
    """y (B, T, H, D) in r's dtype.  ``state``, where given, is read as the
    initial state and overwritten with the final one; None starts from zeros.
    ``chunk`` is the plain version's chunk length.  On the card any T is taken:
    bf16 at head size 64 with T >= ``wkv6.CHUNKED_T_MIN`` runs the chunked form
    on the tensor cores (chunks of 64), everything else (f32, a decode step)
    the exact sequential recurrence.  Differentiated, it takes no ``state``."""
    if _differentiated(r, k, v, logw, u):
        if state is not None:
            raise ValueError("wkv6: a differentiated call starts from a zero state and takes no state")
        return _wkv.WKV6Fn.apply(r, k, v, logw, u, chunk)
    if r.device.type == "cpu":
        y, S = _wkv.wkv6_plain(r, k, v, logw, u, state, chunk=chunk)
        if state is not None:
            state.copy_(S)
        return y
    if r.device.type == "meta":
        return _wkv.wkv6_meta(r, k, v, logw, u, state)
    return _wkv.wkv6_cuda(r, k, v, logw, u, state)
