"""Mamba2 (SSD, state-space duality) block (``repro/models/ssm.py``): the
chunked-parallel form for prefill and training, the O(1)-state recurrence for
a decode step.

Recurrence (per head h, head_dim p, state n):
    h_t = a_t * h_{t-1} + dt_t * x_t ⊗ B_t          a_t = exp(dt_t * A_h)  (a scalar a head)
    y_t = C_t · h_t + D_h * x_t
The chunked form is the reference's: an attention-like masked product inside
each chunk, then the chunks' carried states (the reference's ``lax.scan`` is a
loop over the chunks here).  The reference has no kernel for it, so neither has
the port: its products are ``torch`` operations.  Every exponent is at most 0:
the within-chunk decays are masked with -inf above the diagonal, and
``ltot - lcum`` and ``lcum`` are sums of dt * A <= 0.

The gated RMS norm goes through ``modules.rmsnorm`` (the RMSNorm kernel on the
card), which is term for term the reference's inline expression, wherever a
rank holds whole rows of it.

Parameters are stacked on leading axes (``lead``: (L,) in the SSM stack, (G, M)
in the hybrid's groups) with the reference's keys; a state, where given, is
updated in place.

Under tensor parallelism (``parallel/tensor_parallel.py``, the loss only) the
block runs as the reference's plan places its leaves (``_mamba_split``):
  * the pure stack's (L,)-stacked leaves by heads, as the reference's
    docstring lays them out: ``w_z``, ``w_x`` and ``conv_x`` on d_inner,
    ``w_out`` on its rows and ``norm_scale`` on its features; ``w_bc``,
    ``w_dt``, ``conv_bc``, ``A_log``, ``D`` and ``dt_bias`` whole.  Where
    ``model`` divides the heads a rank runs the SSD on its own heads, and
    the gated norm's statistic, whose row is split across the ranks, is
    summed over ``model``; where it divides d_inner but not the heads, z and
    the convolved x are gathered and every rank runs all the heads;
  * the hybrid's (G, M)-stacked leaves one dim to the left of that head
    split (ROADMAP Queue 3 (p)): ``w_z`` and ``w_x`` on d, their contracting
    dim, and ``conv_x`` on its taps where ``model`` divides them; the rest of
    the layer and the SSD's work stay whole, on every rank.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.modules import ModelConfig, Params, dense, dense_init, rmsnorm
from repro_torch.parallel import tensor_parallel as tp

# leaves the reference makes f32 whatever cfg.param_dtype, and the forward reads in f32
F32_KEYS = ("A_log", "D", "dt_bias", "norm_scale")


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, lead: Sequence[int], dtype=None) -> Params:
    """The block's parameters with leading axes ``lead``: the matrices and the
    two convolutions in ``dtype`` (default ``cfg.param_dtype``), ``F32_KEYS``
    in f32, valued as the reference initialises them."""
    s, d, dev = cfg.ssm, cfg.d_model, gen.device
    lead = tuple(lead)
    d_in = d * s.expand
    nheads = d_in // s.head_dim
    pdt = dtype or cfg.param_dtype

    def full(n, value):
        return torch.full(lead + (n,), value, dtype=torch.float32, device=dev)

    return {
        "w_z": dense_init(gen, lead + (d, d_in), pdt),  # gate
        "w_x": dense_init(gen, lead + (d, d_in), pdt),
        "w_bc": dense_init(gen, lead + (d, 2 * s.d_state), pdt),
        "w_dt": dense_init(gen, lead + (d, nheads), pdt),
        "conv_x": dense_init(gen, lead + (s.conv_width, d_in), pdt),
        "conv_bc": dense_init(gen, lead + (s.conv_width, 2 * s.d_state), pdt),
        "A_log": full(nheads, 0.0),
        "D": full(nheads, 1.0),
        "dt_bias": full(nheads, 0.0),
        "w_out": dense_init(gen, lead + (d_in, d), pdt),
        "norm_scale": full(d_in, 1.0),
    }


def _conv_taps(x: torch.Tensor, conv_w: torch.Tensor, first: int, width: int) -> torch.Tensor:
    """The depthwise causal conv1d of x (B, T, C) from zeros, before its
    SiLU, over the taps ``conv_w`` (n, C) alone, which are taps ``first`` to
    ``first + n - 1`` of a conv of ``width`` taps: a rank's share of the sum
    where ``model`` splits the taps."""
    T = x.shape[1]
    xp = torch.cat([x.new_zeros(x.shape[:1] + (width - 1,) + x.shape[2:]), x], dim=1)
    return sum(xp[:, first + i:first + i + T] * conv_w[i].to(x.dtype) for i in range(conv_w.shape[0]))


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor, state: Optional[torch.Tensor]):
    """Depthwise causal conv1d and SiLU. x (B, T, C); conv_w (W, C); state
    (B, W-1, C) or None (zeros).  Returns (out, the last W-1 inputs): for a
    prompt shorter than W-1 those still hold the end of ``state``."""
    W = conv_w.shape[0]
    if state is None:
        pad = x.new_zeros(x.shape[:1] + (W - 1,) + x.shape[2:])
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, T+W-1, C)
    T = x.shape[1]
    out = sum(xp[:, i:i + T] * conv_w[i].to(x.dtype) for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else pad[:, :0]
    return F.silu(out), new_state


def _ssd_chunked(x, B, C, dt, A, chunk: int, h0: Optional[torch.Tensor] = None):
    """The chunked SSD scan, in f32.

    x (b, T, H, P), B and C (b, T, N), dt (b, T, H), A (H,) negative; T a
    multiple of ``chunk``; h0 (b, H, P, N) or None (zeros).
    Returns y (b, T, H, P) f32 and the final state (b, H, P, N) f32."""
    b, T, H, Pd = x.shape
    N = B.shape[-1]
    nc = T // chunk
    xc = x.reshape(b, nc, chunk, H, Pd).float()
    Bc = B.reshape(b, nc, chunk, N).float()
    Cc = C.reshape(b, nc, chunk, N).float()
    dtc = dt.reshape(b, nc, chunk, H).float()

    la = dtc * A  # log decay a step (b, nc, c, H), <= 0
    lcum = torch.cumsum(la, dim=2)  # inclusive cumulative log decay
    ltot = lcum[:, :, -1]  # (b, nc, H)

    # within a chunk: a masked attention-like product
    cb = torch.einsum("bktn,bksn->bkts", Cc, Bc)
    seg = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (b, nc, t, s, H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    dec = torch.exp(torch.where(mask[None, None, :, :, None], seg, -torch.inf))
    att = cb[..., None] * dec * dtc[:, :, None, :, :]  # (b, nc, t, s, H)
    y_intra = torch.einsum("bktsh,bkshp->bkthp", att, xc)

    # each chunk's summary state: S_k = sum_s exp(ltot - lcum_s) dt_s B_s x_s^T
    w = torch.exp(ltot[:, :, None, :] - lcum) * dtc  # (b, nc, c, H)
    S = torch.einsum("bkch,bkchp,bkcn->bkhpn", w, xc, Bc)

    # across chunks: the carried state, the state entering each chunk kept
    h = x.new_zeros((b, H, Pd, N), dtype=torch.float32) if h0 is None else h0.float()
    entering = []
    for k in range(nc):
        entering.append(h)
        h = h * torch.exp(ltot[:, k])[:, :, None, None] + S[:, k]
    h_prevs = torch.stack(entering, dim=1)  # (b, nc, H, P, N)

    # the carried state's share: y_t += C_t · (exp(lcum_t) * h_prev)
    y_inter = torch.einsum("bktn,bkth,bkhpn->bkthp", Cc, torch.exp(lcum), h_prevs)
    return (y_intra + y_inter).reshape(b, T, H, Pd), h


def _split_gated_norm(scale: torch.Tensor, yz: torch.Tensor, width: int, eps: float = 1e-6) -> torch.Tensor:
    """The gated RMS norm of a row split over ``model``: yz (..., width /
    TP) is this rank's part and ``scale`` its features.  The statistic, the
    f32 sum of squares over the whole row, is all-reduced forward and its
    gradient all-reduced backward (``reduce_out(copy_in(.))``): every rank's
    features read it.  Plain torch: the RMSNorm kernel takes whole rows."""
    yf = yz.float()
    ss = tp.reduce_out(tp.copy_in(yf.square().sum(-1, keepdim=True)))
    return (yf * torch.rsqrt(ss / width + eps) * scale).to(yz.dtype)


def mamba2_apply(
    params: Params, cfg: ModelConfig, x: torch.Tensor, state: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params]:
    """x (B, T, d).  state {"ssm": (B, H, P, N) f32, "conv_x": (B, W-1, d_in),
    "conv_bc": (B, W-1, 2N)}, read and then overwritten in place with the state
    after x; None starts from zeros.  Returns (out, the state after x).

    As the reference: T > 1 or no state takes the chunked form, T padded with
    zeros to a multiple of ``chunk`` (dt = 0 there leaves the state as it is)
    and y cut back to T; one token with a state takes the recurrence.

    Under tensor parallelism (no state), by heads (the pure stack): ``w_z``
    and ``w_x`` take ``copy_in(x)`` and give the rank's columns of d_inner,
    which the depthwise ``conv_x`` convolves with no transport; ``w_bc``,
    ``w_dt`` and ``conv_bc`` compute whole.  Where the rank runs its own
    heads, B and C enter the SSD through ``copy_in`` after ``conv_bc``, so
    that the heads' partial gradients reach both whole leaves summed; dt
    (after ``dt_bias``), A and D are cut to the rank's heads with ``slice_``,
    whose backward gathers their gradients whole; the gated norm sums its
    statistic over ``model`` (``_split_gated_norm``) and ``w_out``'s
    partial output is summed.  Where the heads do not divide ``model``, z
    and the convolved x are gathered, every rank runs all heads with B, C,
    dt, A and D as they are, the gated norm takes the gathered
    ``norm_scale`` (the RMSNorm kernel, whole rows), and ``w_out`` takes the
    rank's rows of its input and its output is summed.
    The hybrid's split (``w_z`` and ``w_x`` on d): they take the rank's
    columns of x (one ``slice_`` for both) and their partial outputs are
    summed over ``model``; where ``conv_x`` is split on its taps the rank
    convolves ``copy_in(xs)`` with its taps at their global offsets and the
    partial sums are summed over ``model`` before the SiLU."""
    s = cfg.ssm
    B_, T, d = x.shape
    d_in = d * s.expand
    route, taps = _mamba_split(cfg)
    by_heads = route in ("heads", "cut")

    if route == "rows":  # the plan splits w_z and w_x on d, their contracting dim
        xr = tp.slice_(x, -1)
        z, xs = tp.reduce_out(dense(params["w_z"], xr)), tp.reduce_out(dense(params["w_x"], xr))
    else:
        xc = tp.copy_in(x) if by_heads else x
        z = dense(params["w_z"], xc)
        xs = dense(params["w_x"], xc)
    bc = dense(params["w_bc"], x)
    dt = dense(params["w_dt"], x)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])  # (H,)
    D = params["D"]

    cx = state["conv_x"] if state is not None else None
    cb = state["conv_bc"] if state is not None else None
    if taps:
        W = s.conv_width
        new_cx = xs[:, T - W + 1:] if T >= W - 1 else F.pad(xs, (0, 0, W - 1 - T, 0))  # the last W-1 inputs
        xs = F.silu(tp.reduce_out(_conv_taps(tp.copy_in(xs), params["conv_x"], tp.first(W), W)))
    else:
        xs, new_cx = _causal_conv(xs, params["conv_x"], cx)
    bc, new_cb = _causal_conv(bc, params["conv_bc"], cb)
    if route == "heads":  # the rank's heads read the whole B, C, dt, A and D
        bc = tp.copy_in(bc)
        dt, A, D = tp.slice_(dt, -1), tp.slice_(A, 0), tp.slice_(D, 0)
    elif route == "cut":  # every rank runs all the heads
        z, xs = tp.gather(z, -1), tp.gather(xs, -1)
    Bmat, Cmat = bc.chunk(2, dim=-1)
    xh = xs.reshape(B_, T, -1, s.head_dim)

    if T > 1 or state is None:
        h0 = state["ssm"] if state is not None else None
        pad = (-T) % s.chunk
        if pad:
            def padded(a):
                return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
            y, h_new = _ssd_chunked(padded(xh), padded(Bmat), padded(Cmat), padded(dt), A, s.chunk, h0)
            y = y[:, :T]
        else:
            y, h_new = _ssd_chunked(xh, Bmat, Cmat, dt, A, s.chunk, h0)
    else:  # one step of the recurrence
        h_prev = state["ssm"]  # (B, H, P, N)
        a = torch.exp(dt[:, 0] * A)  # (B, H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0].float(), Bmat[:, 0].float())
        h_new = h_prev * a[:, :, None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", h_new, Cmat[:, 0].float())[:, None]

    y = y + D[None, None, :, None] * xh.float()
    y = y.reshape(B_, T, -1).to(x.dtype)
    # the gated RMS norm (Mamba2's): an RMSNorm of y * silu(z), eps 1e-6
    if route == "heads":
        yz = _split_gated_norm(params["norm_scale"], y * F.silu(z), d_in)
    else:
        yz = rmsnorm(tp.gather(params["norm_scale"], 0) if route == "cut" else params["norm_scale"], y * F.silu(z))
    if state is None:
        state = {"ssm": h_new, "conv_x": new_cx, "conv_bc": new_cb}
    else:
        state["ssm"].copy_(h_new)
        state["conv_x"].copy_(new_cx)
        state["conv_bc"].copy_(new_cb)
    if by_heads:  # w_out split on its rows
        return tp.reduce_out(dense(params["w_out"], yz if route == "heads" else tp.slice_(yz, -1))), state
    return dense(params["w_out"], yz), state


_KEYS = ("w_z", "w_x", "conv_x", "w_bc", "w_dt", "conv_bc", "A_log", "D", "dt_bias", "w_out", "norm_scale")
# the plan's dims where it splits the pure stack by heads (its (L,) leaves), the rest whole
_HEADS = {**dict.fromkeys(_KEYS), "w_z": 1, "w_x": 1, "conv_x": 1, "w_out": 0, "norm_scale": 0}


def _mamba_split(cfg: ModelConfig) -> Tuple[Optional[str], bool]:
    """(the route of the current tensor-parallel context, whether it splits
    ``conv_x`` on its taps): None, nothing split; "heads", the pure stack's
    head split (``_HEADS``) where ``model`` divides the heads; "cut", that
    split where it divides d_inner and not the heads; "rows", the plan's
    placement of the hybrid's (G, M) leaves, ``w_z`` and ``w_x`` on d and
    ``conv_x`` on its taps or whole.  Raises on any other split."""
    dims = {n: tp.split_dim(n) for n in _KEYS}
    if all(v is None for v in dims.values()):
        return None, False
    if dims == _HEADS:
        return ("heads" if tp.divides(cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim) else "cut"), False
    if dims == {**dict.fromkeys(_KEYS), "w_z": 0, "w_x": 0, "conv_x": dims["conv_x"]} and dims["conv_x"] in (0, None):
        return "rows", dims["conv_x"] == 0
    raise NotImplementedError(
        f"{cfg.name}: Mamba2 split as {dims} over the mesh {tp.mesh_shape()}: the port splits the pure stack by "
        "heads (w_z, w_x, conv_x on d_inner, w_out and norm_scale on their rows) and the hybrid's w_z and w_x on d "
        "with conv_x on its taps, as the plan places them")


def mamba2_state_shape(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    d_in = cfg.d_model * s.expand
    nheads = d_in // s.head_dim
    return {
        "ssm": ((batch, nheads, s.head_dim, s.d_state), torch.float32),
        "conv_x": ((batch, s.conv_width - 1, d_in), cfg.dtype),
        "conv_bc": ((batch, s.conv_width - 1, 2 * s.d_state), cfg.dtype),
    }
