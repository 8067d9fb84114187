"""RWKV-6 WKV recurrence: the CUDA kernels' wrappers (forward and backward),
their plain versions, their launch counts and ``WKV6Fn``, the autograd
Function that joins them.

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

The backward (``wkv6_bwd_cuda``, from a zero initial state and with no final
state, as the reference's loss runs ``_wkv_chunked``) is the port's
counterpart of what XLA derives for the reference when it trains.  Two routes
in ``csrc/wkv6.cu``, chosen in its C entry point by dtype and shape alone:

* bf16 at head size 64 and T >= CHUNKED_BWD_T_MIN, rows 16-byte aligned (the
  training path): the chunked form on the tensor cores, two launches and the
  du sum.  ``wkv6_bwd_state_kernel`` walks the chunks forward and writes the
  state before each chunk to an f32 workspace; ``wkv6_bwd_chunk_kernel``
  walks them backward with dS in f32 in shared memory and computes every
  gradient of a chunk in one pass on ``mma.sync``, operands split into bf16
  parts (three on dlogw's path, whose allowance is f32's), no exp of a
  positive argument.
* everything else (f32, head size 32, shorter T): three sequential passes over
  the recurrence, f32 throughout, bound by their f32 operations (15 a state
  element a step, where the gradients need 12: the third pass carries dS a
  second time).

Both end in a fixed-order sum of ``du`` over the batch (no atomics: a run is
bit-reproducible).  With ``drI_t = S_{t-1} dy_t`` and ``dkI_t = dS_t v_t``
the parts of dr and dk that come through the state, the gradient of the log
decay needs no state:

    dlogw_s = sum_{t>s} r_t * drI_t - sum_{t>=s} k_t * dkI_t

``fwd_cost`` and ``bwd_cost`` give each direction's bytes and operations on the
route its C entry point takes; on ``meta`` tensors ``wkv6_meta`` and
``wkv6_bwd_meta`` allocate what the card's wrappers allocate (the backward's
``S_prev`` workspace on the chunked route) and record the launch (``cost.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, cost
from repro_torch.kernels._check import DTYPE_CODES, require, require_cuda, require_no_grad, rows_aligned

HEAD_DIMS = (32, 64)  # the head sizes the kernels are instantiated for
# the shortest T that the chunked kernel takes (bf16, head size 64): below it
# the sequential kernel is faster on an H100 (experiments/torch_kernel_ab.py)
CHUNKED_T_MIN = 32
# the shortest T that the chunked backward takes (bf16, head size 64): below
# it the sequential passes are faster on an H100 (experiments/torch_kernel_ab.py)
CHUNKED_BWD_T_MIN = 32
launches = 0  # one more for every forward kernel launch; reset by whoever wants to count a run
bwd_launches = 0  # one more for every backward launch (its kernels count once)
bwd_chunk_launches = 0  # of those, the launches that took the chunked route


def chunk_flops(B: int, T: int, H: int) -> int:
    """The tensor-core operations of csrc/wkv6.cu's wkv6_chunk_kernel, counted
    from its code: per chunk of 64 steps, m16n8k16 products for the scores
    against earlier sub-chunks (warp w: 2w column tiles x 4 x 3), A V (warp w:
    w + 1 blocks x 8 tiles x 2), (r exp(Lx)) S_prev (4 x 4 x 8 x 3) and the
    state update (4 x 4 x 8 x 2); 2 x 16 x 8 x 16 operations each."""
    per_chunk = sum(24 * w + 16 * (w + 1) for w in range(4)) + 384 + 256
    return B * H * -(-T // 64) * per_chunk * 2 * 16 * 8 * 16


def sequential_flops(B: int, T: int, H: int, D: int) -> int:
    """The sequential form's f32 operations: a state element a step r.S (2),
    S*w + k*v (3); a step r.u.k (3 D), + v_e * bonus (2 D)."""
    return B * T * H * (5 * D * D + 5 * D)


def bwd_flops(B: int, T: int, H: int, D: int) -> int:
    """The f32 operations the gradients need, whatever kernel computes them:
    a state element a step, 5 to carry S and read drI off it (a dot
    product's FMA, then the update's multiply and FMA), 5 to carry dS and read
    dkI off it, and 2 for dv's dot product with dS (12); a row a step, 20 (v.dy
    2; the bonus terms of dr and dk 3 each; r drI and k dkI 1 each; dlogw's
    running sum 2; du's product and sum 3; dv's r.u.k 3 and its add 2).  K4's
    backward does more (its pass C carries dS a second time: 15 a state
    element), which the bound does not count."""
    return B * T * H * (12 * D * D + 20 * D)


def bwd_chunk_flops(B: int, T: int, H: int) -> int:
    """The tensor-core operations of csrc/wkv6.cu's chunked backward, counted
    from its code as the mma.sync it issues (split products as the products
    they issue; an m16n8k8 as half an m16n8k16, 2 x 16 x 8 x 16 operations).
    wkv6_bwd_chunk_kernel, per chunk, warp w: (1) dy S_prev^T 96, dA 8 a
    sub-chunk up to its own, dA k' 48 each earlier one; (2) v dS^T 96, dA^T 8
    and dA^T r' 48 each later sub-chunk; (3a) 96 m16n8k8 and 12; (5) kw dS 96,
    the diagonal k-step 16, A^T 24 and A^T dy 16 each later sub-chunk; (6) 96:
    756 - 40 w.  wkv6_bwd_state_kernel: 384 each chunk but the last."""
    nc = -(-T // 64)
    per_chunk = sum(756 - 40 * w for w in range(4))
    return B * H * (nc * per_chunk + (nc - 1) * 384) * 2 * 16 * 8 * 16


def fwd_chunked(dtype: torch.dtype, T: int, D: int, aligned: bool) -> bool:
    """Whether ``wkv6_cuda`` takes the chunked kernel, as its C entry point
    decides: bf16 at head size 64, T >= CHUNKED_T_MIN, rows on 16 bytes."""
    return dtype == torch.bfloat16 and D == 64 and T >= CHUNKED_T_MIN and aligned


def fwd_cost(B: int, T: int, H: int, D: int, dtype: torch.dtype, state: bool, aligned: bool = True) -> cost.Cost:
    """r, k, v read and y written in ``dtype``, logw read in f32, u read, and
    with ``state`` the (B, H, D, D) f32 state read once and written once; the
    chunked kernel's tensor-core operations at the bf16 rate, or the
    sequential form's at the f32 rate, as the route the call takes."""
    n = B * T * H * D
    nbytes = 4 * n * dtype.itemsize + n * 4 + H * D * 4 + (2 * B * H * D * D * 4 if state else 0)
    if fwd_chunked(dtype, T, D, aligned):
        return nbytes, chunk_flops(B, T, H), cost.BF16_FLOPS
    return nbytes, sequential_flops(B, T, H, D), cost.F32_FLOPS


def bwd_cost(B: int, T: int, H: int, D: int, dtype: torch.dtype, aligned: bool = True) -> cost.Cost:
    """r, k, v, dy read and dr, dk, dv written in ``dtype``, logw read and dlogw
    written in f32, u read and du written; the chunked route's tensor-core
    operations at the bf16 rate, or the gradients' f32 operations at the f32
    rate, as the route the call takes (``bwd_chunked``)."""
    n = B * T * H * D
    nbytes = 7 * n * dtype.itemsize + 2 * n * 4 + 2 * H * D * 4
    if bwd_chunked(dtype, T, D, aligned):
        return nbytes, bwd_chunk_flops(B, T, H), cost.BF16_FLOPS
    return nbytes, bwd_flops(B, T, H, D), cost.F32_FLOPS


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


def _require_inputs(name: str, r, k, v, logw, u) -> Tuple[int, int, int, int]:
    """The checks the forward and the backward share, on the card and on
    ``meta``: r, k, v (B, T, H, D) of one type, f32 or bf16, and logw alike in
    f32, each with a unit stride along D; u (H, D) f32 contiguous; D in
    HEAD_DIMS.  Returns (B, T, H, D)."""
    require(r.dtype in DTYPE_CODES and k.dtype == r.dtype and v.dtype == r.dtype,
            f"{name}: r, k, v of one type, f32 or bf16, got {r.dtype}, {k.dtype}, {v.dtype}")
    require(logw.dtype == torch.float32 and u.dtype == torch.float32,
            f"{name}: logw and u must be f32, got {logw.dtype}, {u.dtype}")
    require(r.dim() == 4 and k.shape == r.shape and v.shape == r.shape and logw.shape == r.shape,
            f"{name}: r, k, v, logw must be (B, T, H, D) alike, got {[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, T, H, D = r.shape
    require(B >= 1 and T >= 1 and H >= 1, f"{name}: empty input")
    require(D in HEAD_DIMS, f"{name}: head size {D} not in {HEAD_DIMS}")
    require(B * H < 2**31, f"{name}: too many (batch, head) rows for one grid")
    for what, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        require(t.stride(-1) == 1, f"{name}: {what} needs a unit stride along its last axis, got strides {t.stride()}")
    require(tuple(u.shape) == (H, D) and u.is_contiguous(), f"{name}: u must be ({H}, {D}) contiguous, got {tuple(u.shape)}")
    return B, T, H, D


def _fwd_call(r, k, v, logw, u, state) -> Tuple:
    """The forward's checks and its output, which the card's wrapper and the
    meta wrapper share: (B, T, H, D, y, aligned), ``aligned`` whether the
    rows let the chunked kernel take the call."""
    B, T, H, D = _require_inputs("wkv6", r, k, v, logw, u)
    if state is not None:
        require(state.dtype == torch.float32 and tuple(state.shape) == (B, H, D, D) and state.is_contiguous(),
                f"wkv6: state must be ({B}, {H}, {D}, {D}) f32 contiguous, got {tuple(state.shape)} {state.dtype}")
    y = torch.empty((B, T, H, D), dtype=r.dtype, device=r.device)
    # the chunked kernel copies 16-byte pieces; a decode step (T = 1) never takes it
    aligned = T >= CHUNKED_T_MIN and all(rows_aligned(t) for t in (r, k, v, logw))
    return B, T, H, D, y, aligned


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
    more = () if state is None else (state,)
    require_no_grad("wkv6", r, k, v, logw, u, *more)
    require_cuda("wkv6", r, k, v, logw, u, *more)
    B, T, H, D, y, aligned = _fwd_call(r, k, v, logw, u, state)
    strides = [s for t in (r, k, v, logw) for s in t.stride()[:3]]
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


def wkv6_bwd_plain(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
    dy: torch.Tensor, *, chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of ``wkv6_plain(r, k, v, logw, u)`` (S0 = 0, the final
    state not differentiated) against dy, written out on the same chunks, f32
    inside: (dr, dk, dv) in r's dtype, dlogw (B, T, H, D) f32, du (H, D) f32.
    Per chunk, with the forward's rescaled r_sc, k_sc and kw, its scores, the
    states S_prev before each chunk and dS_next, the gradient of the state
    after it:

        dr = (dscores k_sc + dy S_prevᵀ) exp(lcum) + u k (v.dy)
        dk = dscoresᵀ r_sc exp(-lcum_inc) + v dS_nextᵀ exp(ltot - lcum_inc) + u r (v.dy)
        dv = scoresᵀ dy + (r.u.k) dy + kw dS_next
        dS_prev = r_scᵀ dy + diag(exp(ltot)) dS_next

    and dlogw from the identity of the module's docstring, on the parts of dr
    and dk without the bonus."""
    B, T, H, D = r.shape
    c = min(chunk, T)
    nc = -(-T // c)
    pad = nc * c - T

    def chunks(a):
        return F.pad(a.float(), (0, 0, 0, 0, 0, pad)).reshape(B, nc, c, H, D)

    rc, kc, vc, lw, gc = chunks(r), chunks(k), chunks(v), chunks(logw), chunks(dy)
    lcum_inc = lw.cumsum(2)
    lcum = lcum_inc - lw
    ltot = lcum_inc[:, :, -1]
    e_r, e_k = torch.exp(lcum), torch.exp(-lcum_inc)
    e_w = torch.exp(ltot[:, :, None] - lcum_inc)
    r_sc, k_sc, kw = rc * e_r, kc * e_k, kc * e_w
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    scores = torch.einsum("bkthd,bkshd->bkhts", r_sc, k_sc) * mask
    bonus = torch.einsum("bkthd,hd,bkthd->bkth", rc, u.float(), kc)
    vdy = (vc * gc).sum(-1)  # (B, nc, c, H)

    S_chunk = torch.einsum("bkshd,bkshe->bkhde", kw, vc)
    S = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    S_prevs = []
    for i in range(nc):
        S_prevs.append(S)
        S = S * torch.exp(ltot[:, i])[..., None] + S_chunk[:, i]
    dS = torch.zeros_like(S)
    dS_nexts = [None] * nc
    for i in reversed(range(nc)):  # the state's gradient carried back from chunk to chunk
        dS_nexts[i] = dS
        dS = dS * torch.exp(ltot[:, i])[..., None] + torch.einsum("bthd,bthe->bhde", r_sc[:, i], gc[:, i])
    S_prev, dS_next = torch.stack(S_prevs, dim=1), torch.stack(dS_nexts, dim=1)

    dscores = torch.einsum("bkthe,bkshe->bkhts", gc, vc) * mask
    drI = (torch.einsum("bkhts,bkshd->bkthd", dscores, k_sc) + torch.einsum("bkthe,bkhde->bkthd", gc, S_prev)) * e_r
    dkI = torch.einsum("bkhts,bkthd->bkshd", dscores, r_sc) * e_k \
        + torch.einsum("bkshe,bkhde->bkshd", vc, dS_next) * e_w
    uf = u.float()
    dr = drI + uf * kc * vdy[..., None]
    dk = dkI + uf * rc * vdy[..., None]
    dv = torch.einsum("bkhts,bkthe->bkshe", scores, gc) + bonus[..., None] * gc \
        + torch.einsum("bkshd,bkhde->bkshe", kw, dS_next)
    du = (rc * kc * vdy[..., None]).sum(dim=(0, 1, 2))

    def whole(a):
        return a.reshape(B, nc * c, H, D)[:, :T]

    # dlogw_s = sum_{t>s} r_t drI_t - sum_{t>=s} k_t dkI_t = sum_{t>=s} (r_{t+1} drI_{t+1} - k_t dkI_t):
    # one sum from the end of the sequence, which stays the size of dlogw
    rdr = F.pad(whole(rc * drI)[:, 1:], (0, 0, 0, 0, 0, 1))
    dlogw = (rdr - whole(kc * dkI)).flip(1).cumsum(1).flip(1)
    return whole(dr).to(r.dtype), whole(dk).to(r.dtype), whole(dv).to(r.dtype), dlogw, du


def _bwd_call(r, k, v, logw, u, dy) -> Tuple:
    """The backward's checks, its outputs and its scratch, which the card's
    wrapper and the meta wrapper share: (B, T, H, D, (dr, dk, dv, dlogw, du),
    du_part, ws, scratch, aligned, chunked).  ``du_part`` holds du's partials a
    (batch, head); the chunked route (``bwd_chunked``) takes ``ws``, the state
    before each chunk of 64, the sequential passes ``scratch``, the first
    pass's r_t * drI_t, read back by the second."""
    require(dy.dtype == r.dtype and dy.shape == r.shape and dy.stride(-1) == 1,
            f"wkv6_bwd: dy must be like r with a unit stride along D, got {tuple(dy.shape)} {dy.dtype} {dy.stride()}")
    B, T, H, D = _require_inputs("wkv6_bwd", r, k, v, logw, u)
    grads = tuple(torch.empty((B, T, H, D), dtype=r.dtype, device=r.device) for _ in range(3)) + (
        torch.empty((B, T, H, D), dtype=torch.float32, device=r.device),
        torch.empty((H, D), dtype=torch.float32, device=r.device))
    du_part = torch.empty((B, H, D), dtype=torch.float32, device=r.device)
    aligned = all(rows_aligned(t) for t in (r, k, v, dy, logw))
    chunked = bwd_chunked(r.dtype, T, D, aligned)
    ws = torch.empty((B * H, -(-T // 64), D, D), dtype=torch.float32, device=r.device) if chunked else None
    scratch = None if chunked else torch.empty((B * H, T, D), dtype=torch.float32, device=r.device)
    return B, T, H, D, grads, du_part, ws, scratch, aligned, chunked


def wkv6_bwd_cuda(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor, dy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients of ``wkv6_cuda(r, k, v, logw, u, None)`` against dy:
    (dr, dk, dv) (B, T, H, D) in r's dtype, dlogw (B, T, H, D) f32, du (H, D)
    f32.  r, k, v, dy of one type, f32 or bf16, logw f32, each read through its
    strides (unit stride along D); u (H, D) f32 contiguous.  Any T >= 1; D in
    HEAD_DIMS.  Launches the backward's kernels, the chunked route where
    ``bwd_chunked`` says so; bit-reproducible (no atomics)."""
    global bwd_launches, bwd_chunk_launches
    require_no_grad("wkv6_bwd", r, k, v, logw, u, dy)
    require_cuda("wkv6_bwd", r, k, v, logw, u, dy)
    B, T, H, D, grads, du_part, ws, scratch, aligned, chunked = _bwd_call(r, k, v, logw, u, dy)
    dr, dk, dv, dlogw, du = grads
    strides = [s for t in (r, k, v, logw, dy) for s in t.stride()[:3]]
    code = build.load().wkv6_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(), dy.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(),
        None if scratch is None else scratch.data_ptr(), None if ws is None else ws.data_ptr(), du_part.data_ptr(),
        B, T, H, D, DTYPE_CODES[r.dtype], int(aligned), CHUNKED_BWD_T_MIN, *strides,
        torch.cuda.current_stream(r.device).cuda_stream,
    )
    build.check(code, "wkv6_bwd")
    bwd_launches += 1
    bwd_chunk_launches += int(chunked)
    return dr, dk, dv, dlogw, du


def wkv6_meta(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
              state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``wkv6_cuda`` on ``meta``: its checks and y (the state is written in
    place), one launch recorded."""
    require_no_grad("wkv6", r, k, v, logw, u, *(() if state is None else (state,)))
    B, T, H, D, y, aligned = _fwd_call(r, k, v, logw, u, state)
    cost.record("wkv6", fwd_cost(B, T, H, D, r.dtype, state is not None, aligned))
    return y


def wkv6_bwd_meta(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
                  dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``wkv6_bwd_cuda`` on ``meta``: its checks, the gradients, du's partials
    and the route's workspace (the chunked route's S_prev, else the sequential
    passes' scratch), one launch recorded."""
    require_no_grad("wkv6_bwd", r, k, v, logw, u, dy)
    B, T, H, D, grads, du_part, ws, scratch, aligned, _ = _bwd_call(r, k, v, logw, u, dy)
    cost.record("wkv6_bwd", bwd_cost(B, T, H, D, r.dtype, aligned))
    del du_part, ws, scratch
    return grads


def bwd_chunked(dtype: torch.dtype, T: int, D: int, aligned: bool) -> bool:
    """Whether ``wkv6_bwd_cuda`` takes the chunked route, as its C entry point
    decides: bf16 at head size 64, T >= CHUNKED_BWD_T_MIN, every row of r, k,
    v, dy and logw starting on 16 bytes."""
    return dtype == torch.bfloat16 and D == 64 and T >= CHUNKED_BWD_T_MIN and aligned


class WKV6Fn(torch.autograd.Function):
    """y = wkv6(r, k, v, logw, u) from a zero state, with no final state, and a
    hand-written backward: on the card both directions launch kernels
    (``wkv6_cuda``, ``wkv6_bwd_cuda``), on the CPU both use the plain versions
    on chunks of ``chunk``, on ``meta`` both take the card's path to its meta
    wrappers.  Saves the five inputs."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk: int):
        ctx.chunk = chunk
        ctx.save_for_backward(r, k, v, logw, u)
        if r.device.type == "cpu":
            return wkv6_plain(r, k, v, logw, u, None, chunk=chunk)[0]
        return (wkv6_meta if cost.on_meta(r) else wkv6_cuda)(r, k, v, logw, u, None)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        r, k, v, logw, u = ctx.saved_tensors
        if r.device.type == "cpu":
            dr, dk, dv, dlogw, du = wkv6_bwd_plain(r, k, v, logw, u, dy, chunk=ctx.chunk)
        else:
            # autograd may hand over an expanded dy; the kernels read rows of D
            bwd = wkv6_bwd_meta if cost.on_meta(r) else wkv6_bwd_cuda
            dr, dk, dv, dlogw, du = bwd(r, k, v, logw, u, dy if dy.stride(-1) == 1 else dy.contiguous())
        return dr, dk, dv, dlogw.to(logw.dtype), du.to(u.dtype), None
