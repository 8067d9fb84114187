"""RWKV-6 WKV recurrence: the CUDA kernel's wrapper, its plain version and its
launch count.

    S_t = diag(w_t) S_{t-1} + k_tᵀ v_t          (S: D_key x D_value, f32)
    y_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)      w_t = exp(logw_t)

Replaces the TPU kernel ``repro/kernels/wkv6.py::wkv6_bhtd`` (body
``_wkv6_kernel``), which starts from a zero state and returns no final state;
serving needs both, so here the state comes in as ``S0`` and goes out as the
final state, as ``repro/models/rwkv.py::_wkv_chunked`` carries it.

Two hand-written kernels in ``csrc/wkv6.cu``, chosen in its C entry point:

* ``wkv6_chunk_kernel``: bf16 r, k, v at head size 64 and T >= CHUNKED_T_MIN
  (the served prefill).  The chunked form on the tensor cores: chunks of 64
  steps, the 64 x 64 state in ``mma.sync`` accumulators, products of bf16
  operands split into high and low parts with f32 sums, and only exps of
  non-positive arguments, so it stays finite where ``wkv6_plain`` overflows.
  Its bound is the bytes of r, k, v, logw and y.
* ``wkv6_kernel``: f32, bf16 at head size 32, shorter T (a decode step,
  T = 1) and rows that do not start on 16 bytes.  The exact sequential
  recurrence on the CUDA cores: at a prefill's length bound by its f32
  operations (5 a state element a step), at T = 1 by the state's bytes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels._check import DTYPE_CODES, require, require_cuda, require_no_grad, rows_aligned

HEAD_DIMS = (32, 64)  # the head sizes the kernels are instantiated for
# the shortest T that the chunked kernel takes (bf16, head size 64): below it
# the sequential kernel is faster on an H100 (experiments/torch_kernel_ab.py)
CHUNKED_T_MIN = 32
launches = 0  # one more for every kernel launch; reset by whoever wants to count a run


def wkv6_plain(
    r: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,  # (B, T, H, D) log decay, <= 0
    u: torch.Tensor,  # (H, D)
    S0: Optional[torch.Tensor] = None,  # (B, H, D, D) f32, zeros if None
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked form of ``_wkv_chunked``, f32 inside: y (B, T, H, D) in r's
    dtype and the final state (B, H, D, D) f32.  Any T: the last chunk is
    padded with zeros (k = 0 adds nothing to the state, logw = 0 decays
    nothing), and its pad rows are cut from y.  ``S0`` is not written."""
    B, T, H, D = r.shape
    c = min(chunk, T)
    nc = -(-T // c)
    pad = nc * c - T

    def chunks(a):
        return F.pad(a.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nc, c, H, D)

    rc, kc, vc, lw = chunks(r), chunks(k), chunks(v), chunks(logw)
    lcum_inc = lw.cumsum(2)  # inclusive cumulative log decay within a chunk
    lcum = lcum_inc - lw  # exclusive
    ltot = lcum_inc[:, :, -1]  # (B, nc, H, D)

    r_sc = rc * torch.exp(lcum)
    k_sc = kc * torch.exp(-lcum_inc)
    scores = torch.einsum("bkthd,bkshd->bkhts", r_sc, k_sc)
    scores = scores * torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    bonus = torch.einsum("bkthd,hd,bkthd->bkth", rc, u.float(), kc)
    y = torch.einsum("bkhts,bkshd->bkthd", scores, vc) + bonus[..., None] * vc

    kw = kc * torch.exp(ltot[:, :, None] - lcum_inc)
    S_chunk = torch.einsum("bkshd,bkshe->bkhde", kw, vc)
    S = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device) if S0 is None else S0.float()
    S_prevs = []
    for i in range(nc):  # the state carried from chunk to chunk
        S_prevs.append(S)
        S = S * torch.exp(ltot[:, i])[..., None] + S_chunk[:, i]
    y = y + torch.einsum("bkthd,bkhde->bkthe", r_sc, torch.stack(S_prevs, dim=1))
    return y.reshape(B, nc * c, H, D)[:, :T].to(r.dtype), S


def wkv6_cuda(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """r, k, v (B, T, H, D) f32 or bf16 of one type and logw (B, T, H, D) f32
    on the card, each read through its strides; u (H, D) f32; state
    (B, H, D, D) f32 contiguous, read as S0 and overwritten with the final state
    (None: S0 = 0 and no final state).  Returns y (B, T, H, D) in r's dtype.
    Any T >= 1; D in HEAD_DIMS.  Launches one of the two kernels."""
    global launches
    tensors = (r, k, v, logw, u) + (() if state is None else (state,))
    require_no_grad("wkv6", *tensors)
    require_cuda("wkv6", *tensors)
    require(r.dtype in DTYPE_CODES and k.dtype == r.dtype and v.dtype == r.dtype,
            f"wkv6: r, k, v of one type, f32 or bf16, got {r.dtype}, {k.dtype}, {v.dtype}")
    require(logw.dtype == torch.float32 and u.dtype == torch.float32,
            f"wkv6: logw and u must be f32, got {logw.dtype}, {u.dtype}")
    require(r.dim() == 4 and k.shape == r.shape and v.shape == r.shape and logw.shape == r.shape,
            f"wkv6: r, k, v, logw must be (B, T, H, D) alike, got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, T, H, D = r.shape
    require(B >= 1 and T >= 1 and H >= 1, "wkv6: empty input")
    require(D in HEAD_DIMS, f"wkv6: head size {D} not in {HEAD_DIMS}")
    require(B * H < 2**31, "wkv6: too many (batch, head) rows for one grid")
    for what, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        require(t.stride(-1) == 1, f"wkv6: {what} needs a unit stride along its last axis, got strides {t.stride()}")
    require(tuple(u.shape) == (H, D) and u.is_contiguous(), f"wkv6: u must be ({H}, {D}) contiguous, got {tuple(u.shape)}")
    if state is not None:
        require(state.dtype == torch.float32 and tuple(state.shape) == (B, H, D, D) and state.is_contiguous(),
                f"wkv6: state must be ({B}, {H}, {D}, {D}) f32 contiguous, got {tuple(state.shape)} {state.dtype}")
    y = torch.empty((B, T, H, D), dtype=r.dtype, device=r.device)
    strides = [s for t in (r, k, v, logw) for s in t.stride()[:3]]
    # the chunked kernel copies 16-byte pieces; a decode step (T = 1) never takes it
    aligned = T >= CHUNKED_T_MIN and all(rows_aligned(t) for t in (r, k, v, logw))
    lib = build.load()
    code = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(),
        B, T, H, D, DTYPE_CODES[r.dtype], int(aligned), CHUNKED_T_MIN, *strides,
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    build.check(code, "wkv6")
    launches += 1
    return y
