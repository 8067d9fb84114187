"""Mixture-of-Experts FFN (``repro/models/moe.py``): shared + routed experts,
top-k, capacity dispatch.

Dispatch is sort-based and per sequence, as the reference's: a stable argsort
of the flat expert ids, each assignment's position within its expert, and an
expert buffer (B, E, C, d) that holds at most C tokens an expert; assignments
past C are dropped.  Every expert then runs over its whole buffer (the dense
emulation), so a decode step reads every expert's weights.

Nothing here syncs with the host: the dropped assignments are written to one
extra slot an expert that is cut away, and the combine sums each token's K
contributions in a fixed order (ascending expert id, the reference's slot
order), with no float atomics; the dispatch's backward sums them in the same
order (``_TokenRows``), so two identical calls give the same bits on the card
too.

Under tensor parallelism (``parallel/tensor_parallel.py``) the experts are
split over ``model`` as the reference's ``MOE_RULES`` place them, and the
computation follows the placement, as the reference's ``constrain``s lay it
out (``repro/models/moe.py:103-111``): the router, the routes and the aux stay whole on
every rank; with the expert dim split (expert parallelism) a rank runs its
E / TP experts on its rows of the buffer and ``out_buf`` is gathered over
``model`` before the combine; with the features split (the expert count does
not divide ``model``) every rank runs every expert on its f / TP features and
``out_buf`` is the sum of the ranks' partial products.  The shared expert's
matrices are split on their first dim (``w_gate`` and ``w_up`` on d,
``w_down`` on its features): each product takes the rank's columns of its
input and sums its output over ``model``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.modules import ModelConfig, Params, dense, dense_init
from repro_torch.parallel import batch_mean
from repro_torch.parallel import tensor_parallel as tp


def moe_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int, dtype=None) -> Params:
    """Layer-stacked expert weights in ``dtype`` (default ``cfg.param_dtype``);
    the router is f32 whatever the dtype, as the reference makes it."""
    m, d, L = cfg.moe, cfg.d_model, n_layers
    pdt = dtype or cfg.param_dtype
    E, f = m.num_experts, m.expert_d_ff
    p = {
        "router": dense_init(gen, (L, d, E), torch.float32),
        "w_gate": dense_init(gen, (L, E, d, f), pdt),
        "w_up": dense_init(gen, (L, E, d, f), pdt),
        "w_down": dense_init(gen, (L, E, f, d), pdt),
    }
    if m.num_shared_experts:
        sf = m.num_shared_experts * f
        p["shared"] = {
            "w_gate": dense_init(gen, (L, d, sf), pdt),
            "w_up": dense_init(gen, (L, d, sf), pdt),
            "w_down": dense_init(gen, (L, sf, d), pdt),
        }
    return p


def capacity(num_tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert takes per sequence: ceil(T K / E cf), at least 8, a multiple of 8."""
    m = cfg.moe
    c = math.ceil(num_tokens * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, in
    ``jax.lax.top_k``'s order: descending, ties to the lower index.
    ``torch.topk`` promises no order among ties; a stable sort does."""
    values, indices = torch.sort(gates, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def moe_apply(params: Params, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (y (B, T, d) in x's dtype, the f32 aux loss).

    Capacity is enforced within each sequence, so pads of a ragged batch take
    slots in their own sequence, as in the reference.

    **The gate weights are paired as the reference pairs them**
    (``repro/models/moe.py:113``): the token-major ``flat_w`` multiplies the
    expert outputs in expert-sorted slot order, so a slot's output is scaled by
    the gate weight of another (token, k) pair wherever the sort moved it.  A
    per-token top-k MoE would take ``flat_w`` through ``order`` first.  The port
    mirrors the reference, because parity with it is what the port is held to
    (ROADMAP Queue 3 (e)).

    Under tensor parallelism (the module docstring) the router reads ``x``
    itself, so that its gradient into ``x`` is whole on every rank, and the
    dispatch reads ``tp.copy_in(x)``, whose gradient, partial on each rank,
    is summed over ``model``.  With no context, or a ``model`` axis of 1,
    this computes what it computes on one process, bit for bit."""
    m = cfg.moe
    B, T, d = x.shape
    E, K = m.num_experts, m.top_k
    NK = T * K

    gates = torch.softmax(x.float() @ params["router"], dim=-1)  # (B, T, E) f32
    top_w, top_i = top_k(gates, K)  # (B, T, K)

    # ---- load-balance auxiliary loss (Switch-style) ----
    me = gates.mean(dim=(0, 1))  # mean router probability an expert
    ce = F.one_hot(top_i, E).float().sum(dim=2).mean(dim=(0, 1)) / K  # fraction routed
    # the whole batch's where a data axis splits it (parallel/batch_mean.py)
    me, ce = batch_mean.means(me, ce)
    aux = E * torch.sum(me * ce) * m.router_aux_weight

    # ---- sort-based dispatch, batched over B ----
    C = capacity(T, cfg)
    flat_e = top_i.reshape(B, NK)
    flat_w = top_w.reshape(B, NK)
    order = torch.argsort(flat_e, dim=1, stable=True)  # (B, NK)
    sorted_e = flat_e.gather(1, order)
    # an expert's first slot in the sorted row: the cumsum of the counts less the counts
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=x.device).expand(B, E).contiguous())
    pos_in_e = torch.arange(NK, device=x.device)[None] - starts.gather(1, sorted_e)
    token_idx = order // K  # (B, NK)
    keep = pos_in_e < C
    # each token's K slots in ascending slot order (= ascending expert id): the dispatch's backward and the
    # combine sum a token's K parts in this order
    slot_of = torch.argsort(order, dim=1).reshape(B, T, K).sort(dim=-1).values

    split = _expert_split()
    xs = x if split is None else tp.copy_in(x)
    bidx = torch.arange(B, device=x.device)[:, None]
    # rows of a (B, E, C + 1) buffer; a dropped assignment goes to slot C, which is cut away
    dest = (bidx * E + sorted_e) * (C + 1) + torch.where(keep, pos_in_e, C)
    src = _TokenRows.apply(xs, token_idx, slot_of)  # (B, NK, d)
    buf = xs.new_zeros((B * E * (C + 1), d)).index_copy(0, dest.reshape(-1), src.reshape(-1, d))
    buf = buf.reshape(B, E, C + 1, d)[:, :, :C]
    if split == "experts":  # this rank's experts: its rows of the buffer
        buf = tp.part(buf, 1)

    h = F.silu(torch.einsum("becd,edf->becf", buf, params["w_gate"].to(x.dtype)))
    h = h * torch.einsum("becd,edf->becf", buf, params["w_up"].to(x.dtype))
    out_buf = torch.einsum("becf,efd->becd", h, params["w_down"].to(x.dtype))
    if split == "experts":  # every expert's rows, for a combine on the whole buffer
        out_buf = tp.gather(out_buf, 1)
    elif split == "features":  # the sum of the ranks' parts of each expert's features
        out_buf = tp.reduce_out(out_buf)

    w = (flat_w * keep.float()).to(x.dtype)  # token-major weights against sorted slots (see above)
    vals = out_buf.reshape(B, E * C, d).gather(
        1, (sorted_e * C + torch.clamp(pos_in_e, max=C - 1))[..., None].expand(B, NK, d))
    vals = torch.where(keep[..., None], vals, torch.zeros((), dtype=vals.dtype, device=x.device))
    contrib = (vals * w[..., None]).float()  # (B, NK, d), rounded to x's dtype before the f32 sum

    parts = contrib.gather(1, slot_of.reshape(B, NK)[..., None].expand(B, NK, d)).reshape(B, T, K, d)
    y = parts[:, :, 0]
    for j in range(1, K):
        y = y + parts[:, :, j]
    y = y.to(x.dtype)

    if m.num_shared_experts:
        y = y + _shared_expert(params["shared"], x)
    return y, aux


class _TokenRows(torch.autograd.Function):
    """Each sorted slot's token row, ``x.gather(1, token)`` (B, NK, d).  A
    gather's own backward scatter-adds a token's K gradients, with float
    atomics on the card, in an order that changes from call to call; this
    one gathers them from their slots ``slot_of`` (B, T, K) and sums them in
    that order, as the CPU's scatter-add does, bit for bit."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, token: torch.Tensor, slot_of: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(slot_of)
        return x.gather(1, token[..., None].expand(*token.shape, x.shape[-1]))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (slot_of,) = ctx.saved_tensors
        B, T, K = slot_of.shape
        gx = g.gather(1, slot_of[..., 0, None].expand(B, T, g.shape[-1]))
        for k in range(1, K):
            gx = gx + g.gather(1, slot_of[..., k, None].expand(B, T, g.shape[-1]))
        return gx, None, None


def _expert_split():
    """How the current tensor-parallel context splits the routed experts:
    "experts" (their expert dim), "features" (``w_gate`` and ``w_up`` on f,
    ``w_down`` on its rows f) or None (whole)."""
    dims = tuple(tp.split_dim(f"moe/{n}") for n in ("w_gate", "w_up", "w_down"))
    layouts = {(None, None, None): None, (0, 0, 0): "experts", (2, 2, 1): "features"}
    if dims not in layouts:
        raise ValueError(f"routed experts split on dims {dims} over model {tp.mesh_shape()}: not MOE_RULES' placement")
    return layouts[dims]


def _shared_expert(s: Params, x: torch.Tensor) -> torch.Tensor:
    """The shared expert on ``x``; under tensor parallelism each matrix is
    split on its first dim (the plan's first ``MOE_RULES`` candidate on a
    stacked 3-D leaf): ``w_gate`` and ``w_up`` take the rank's columns of
    ``x`` and ``w_down`` the rank's of their product, and each output is
    summed over ``model``."""
    dims = tuple(tp.split_dim(f"moe/shared/{n}") for n in ("w_gate", "w_up", "w_down"))
    if dims == (None, None, None):
        return dense(s["w_down"], F.silu(dense(s["w_gate"], x)) * dense(s["w_up"], x))
    if dims != (0, 0, 0):
        raise ValueError(f"the shared expert split on dims {dims} over model {tp.mesh_shape()}: not the plan's")
    xs = tp.slice_(x, -1)
    h = F.silu(tp.reduce_out(dense(s["w_gate"], xs))) * tp.reduce_out(dense(s["w_up"], xs))
    return tp.reduce_out(dense(s["w_down"], tp.slice_(h, -1)))
