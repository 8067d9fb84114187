"""Decode attention over a ring cache: the CUDA kernels' wrapper, its plain
version and its launch count.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::decode_attention_bhsd``
(body ``_decode_kernel``).  Bound by bytes on this card: K and V of the valid
slots are read once, and tiles of 64 slots with no valid slot are not read at
all; see ``csrc/decode_attention.cu``.  ``cost_of`` gives the bytes and
operations of a call; on ``meta`` tensors ``decode_attention_meta`` allocates
what the card's wrapper allocates (the partials as ``split_plan`` sizes them for
an H100's SMs) and records the launch (``cost.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels._check import (
    DECODE_HEAD_DIMS, DTYPE_CODES, require, require_cuda, require_no_grad, require_rows_aligned,
)

NEG_INF = -2.0**30
TILE = 64  # slots a tile: TN of csrc/decode_attention.cu
MIN_TILES_PER_SPLIT = 2  # so that one tile's copies can be in flight during another's arithmetic
MAX_TILES_PER_SPLIT = 256  # MAX_TILES of csrc/decode_attention.cu: its table of valid slots
# blocks of the partial kernel the plan gives an SM, all in one wave: an SM
# holds three of 64 KB (bf16), but two with more tiles each measured faster
# (experiments/torch_decode_plan.py)
BLOCKS_PER_SM = 2
launches = 0  # one more for every call that launches the kernels; reset by whoever wants to count a run


def decode_attention_plain(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (B, 1)
    kv_pos: torch.Tensor,  # (B, S)
    *,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """A slot is valid iff 0 <= kv_pos <= q_pos (and kv_pos > q_pos - window):
    by the value in kv_pos, never by the slot's index.  f32 inside."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D**-0.5
    qf = (q.float() * scale).reshape(B, T, Hkv, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    mask = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        mask = mask & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return o.reshape(B, T, Hq, D).to(q.dtype)


def cost_of(B: int, S: int, Hq: int, Hkv: int, D: int, valid: int, dtype: torch.dtype) -> cost.Cost:
    """What a call's data needs: K and V of the ``valid`` (row, slot) pairs
    read, every kv position and q_pos read, q read and o written; two products
    of 2 D operations a valid slot and query head.  On ``meta`` no position is
    known, and every slot of the ring counts as valid (``valid = B * S``)."""
    nbytes = 2 * valid * Hkv * D * dtype.itemsize + B * S * 4 + B * 4 + 2 * B * Hq * D * dtype.itemsize
    return nbytes, 4 * valid * Hq * D, cost.rate(dtype)


def split_plan(B: int, Hkv: int, S: int, sm_count: int) -> tuple:
    """(number of slices, the most tiles a slice holds).  Slice s takes the
    ring's tiles s, s + nsplit, ... (round robin, so that the valid prefix of a
    ring that has not wrapped spreads over every slice).  There are as many
    slices as keep the grid of (batch, kv head, slice) blocks within one wave
    of sm_count * BLOCKS_PER_SM (a second, partial wave costs more than it
    gives), but a slice holds MIN_TILES_PER_SPLIT tiles where the ring has
    them and at most MAX_TILES_PER_SPLIT.  A function of the shapes alone:
    nothing is read from kv_pos."""
    ntiles = -(-S // TILE)
    nsplit = max(1, sm_count * BLOCKS_PER_SM // (B * Hkv))
    per = min(ntiles, MAX_TILES_PER_SPLIT, max(MIN_TILES_PER_SPLIT, -(-ntiles // nsplit)))
    nsplit = -(-ntiles // per)
    return nsplit, -(-ntiles // nsplit)


def _call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor, kv_pos: torch.Tensor,
          sm_count: int) -> Tuple:
    """The checks of the shapes, types and strides, the output and the
    partials (``split_plan`` at ``sm_count`` SMs), which the card's wrapper
    and the meta wrapper share: (B, S, Hq, Hkv, D, nsplit, tiles_per_split, o,
    part_acc, part_ml)."""
    require(q.dtype in DTYPE_CODES and k.dtype == q.dtype and v.dtype == q.dtype,
            f"decode_attention: q, k, v of one type, f32 or bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    require(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape, "decode_attention: q (B,1,Hq,D), k and v (B,S,Hkv,D)")
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    require(T == 1, f"decode_attention: one query a row, got T={T}")
    require(k.shape[0] == B and k.shape[3] == D, f"decode_attention: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    require(D in DECODE_HEAD_DIMS, f"decode_attention: head size {D} not in {DECODE_HEAD_DIMS}")
    require(Hkv >= 1 and Hq % Hkv == 0, f"decode_attention: {Hq} query heads over {Hkv} kv heads")
    require(B >= 1 and S >= 1, "decode_attention: empty input")
    require(Hkv <= 65535 and B <= 65535, "decode_attention: too many heads or batch rows for one grid")
    require(q.stride(-1) == 1, "decode_attention: q needs a unit stride along its last axis")
    for what, t in (("k", k), ("v", v)):
        require_rows_aligned("decode_attention", what, t)
    for what, t, shape in (("q_pos", q_pos, (B, 1)), ("kv_pos", kv_pos, (B, S))):
        require(t.dtype == torch.int32 and tuple(t.shape) == shape and t.is_contiguous(),
                f"decode_attention: {what} must be {shape} int32 contiguous, got {tuple(t.shape)} {t.dtype}")
    nsplit, tiles_per_split = split_plan(B, Hkv, S, sm_count)
    o = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((nsplit, B, Hq, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((2, nsplit, B, Hq), dtype=torch.float32, device=q.device)
    return B, S, Hq, Hkv, D, nsplit, tiles_per_split, o, part_acc, part_ml


def decode_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor, kv_pos: torch.Tensor,
    *, window: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, 1, Hq, D), k and v (B, S, Hkv, D) on the card, read through their
    strides; q_pos (B, 1) and kv_pos (B, S) int32 -> (B, 1, Hq, D).  S needs
    divide nothing.  Launches the two kernels (partials, merge) as one call."""
    global launches
    require_no_grad("decode_attention", q, k, v, q_pos, kv_pos)
    require_cuda("decode_attention", q, k, v, q_pos, kv_pos)
    sm_count = torch.cuda.get_device_properties(q.device).multi_processor_count
    B, S, Hq, Hkv, D, nsplit, tiles_per_split, o, part_acc, part_ml = _call(q, k, v, q_pos, kv_pos, sm_count)
    scale = scale if scale is not None else D**-0.5
    lib = build.load()
    code = lib.decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(), o.data_ptr(),
        part_acc.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
        B, S, Hq, Hkv, D, int(window or 0), float(scale), nsplit, tiles_per_split, DTYPE_CODES[q.dtype],
        q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(code, "decode_attention")
    launches += 1
    return o


def decode_attention_meta(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor, kv_pos: torch.Tensor,
    *, window: Optional[int] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """``decode_attention_cuda`` on ``meta``: its checks, o and the partials of
    ``split_plan`` at ``cost.SM_COUNT`` SMs, one launch recorded, with a full
    ring's cost."""
    require_no_grad("decode_attention", q, k, v, q_pos, kv_pos)
    B, S, Hq, Hkv, D, _, _, o, part_acc, part_ml = _call(q, k, v, q_pos, kv_pos, cost.SM_COUNT)
    cost.record("decode_attention", cost_of(B, S, Hq, Hkv, D, B * S, q.dtype))
    del part_acc, part_ml
    return o
