"""RWKV-6 "Finch" block (``repro/models/rwkv.py``): token-shift time mix with
data-dependent decay (arXiv:2404.05892) and the channel mix, pre-normed.

Per head (dim D), with per-channel decay w_t in (0, 1):
    S_t   = diag(w_t) S_{t-1} + k_tᵀ v_t
    out_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)

The recurrence goes through ``kernels.ops.wkv6`` for every T, prefill and
decode alike: the WKV kernel on the card, its plain chunked version on the CPU;
differentiated (the loss), through ``WKV6Fn`` and the WKV-6 backward.
The reference's one-token einsum branch is the same recurrence over a single
step, and the kernel takes any T, so the prefill is not padded to a chunk.

Parameters are layer-stacked (leading ``L`` axis) with the reference's keys;
the state, where given, is updated in place.  The loss differentiates the
block with no state: then it starts from zeros and writes nothing.

Under tensor parallelism (``parallel/tensor_parallel.py``, the loss only) the
plan splits the time mix by heads where ``model`` divides d: ``wr``, ``wk``,
``wv``, ``wg`` and ``w_lora_b`` on their output dim, ``w0`` on d, ``wo`` on
its rows, and ``u`` on its heads where ``model`` divides them too; the
channel mix's ``ck`` on its output dim and ``cv`` on its rows where ``model``
divides d_ff, ``cr`` on its output dim where it divides d.  The ``mu_*``,
``ln_scale`` and ``w_lora_a`` stay whole.  A rank runs the WKV-6 recurrence
on its H / TP heads, or, where the plan cuts inside a head (d divides
``model``, H does not), on all H heads from the gathered projections.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.modules import ModelConfig, Params, dense, dense_init, rmsnorm
from repro_torch.parallel import tensor_parallel as tp

LORA = 64  # rank of the decay's data-dependent LoRA
# leaves the reference makes f32 whatever cfg.param_dtype
F32_KEYS = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "w0", "u", "ln_scale")


def rwkv6_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int, dtype=None) -> Params:
    """Layer-stacked block parameters, the reference's keys and shapes: the
    matrices in ``dtype`` (default ``cfg.param_dtype``), ``F32_KEYS`` in f32."""
    L, d, hd = n_layers, cfg.d_model, cfg.rwkv.head_dim
    H = d // hd
    dev, pdt = gen.device, dtype or cfg.param_dtype

    def full(shape, value):
        return torch.full((L,) + shape, value, dtype=torch.float32, device=dev)

    return {
        "mu_r": full((d,), 0.5),
        "mu_k": full((d,), 0.5),
        "mu_v": full((d,), 0.5),
        "mu_w": full((d,), 0.5),
        "mu_g": full((d,), 0.5),
        "wr": dense_init(gen, (L, d, d), pdt),
        "wk": dense_init(gen, (L, d, d), pdt),
        "wv": dense_init(gen, (L, d, d), pdt),
        "wg": dense_init(gen, (L, d, d), pdt),
        "wo": dense_init(gen, (L, d, d), pdt),
        "w0": full((d,), -2.0),
        "w_lora_a": dense_init(gen, (L, d, LORA), pdt),
        "w_lora_b": dense_init(gen, (L, LORA, d), pdt, scale=0.1),
        "u": full((H, hd), 0.0),
        "ln_scale": full((d,), 1.0),
        "mu_ck": full((d,), 0.5),
        "ck": dense_init(gen, (L, d, cfg.d_ff), pdt),
        "cv": dense_init(gen, (L, cfg.d_ff, d), pdt),
        "cr": dense_init(gen, (L, d, d), pdt),
    }


def _token_shift(x: torch.Tensor, mu: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """lerp(x_{t-1}, x_t, mu) in x's dtype; prev (B, d) is the last token of
    the previous segment (decode state), zeros at the start of a sequence."""
    first = prev[:, None, :] if prev is not None else torch.zeros_like(x[:, :1])
    xm1 = torch.cat([first, x[:, :-1]], dim=1)
    mu = mu.to(x.dtype)
    return x * mu + xm1 * (1.0 - mu)


def rwkv6_apply(
    params: Params, cfg: ModelConfig, x: torch.Tensor, state: Optional[Params] = None,
) -> Tuple[torch.Tensor, Params]:
    """One block (time mix + channel mix).  x (B, T, d).

    state: {"wkv": (B,H,D,D) f32, "shift_t": (B,d), "shift_c": (B,d)}, read
    and then overwritten in place with the state after x; None starts from
    zeros.  Returns (out, the state after x); differentiated with no state (the
    loss, as the reference's), (out, None): nothing is made or written in
    place, which a rematerialised block must not do.  A call under grad that
    differentiates nothing (x and params need no grad) still gets the state.

    Under tensor parallelism (``_rwkv_split``) each of ``xr``, ``xk``,
    ``xv``, ``xg`` and the decay LoRA's ``tanh`` (after the whole
    ``w_lora_a``) enters its split product through ``copy_in``, so that the
    gradients of the whole ``mu_*`` and ``w_lora_a`` are summed over
    ``model``; ``wo``'s output is summed over ``model``.  On the local route
    the rank runs its own heads.  On the cut route (H does not divide
    ``model``) r, k, v and g are gathered after their products and the
    log-decay, formed from the rank's columns of ``w0`` and of the LoRA's
    output, is gathered; every rank runs all H heads with the whole ``u``,
    and ``wo`` takes the rank's rows of its input.  In the channel mix
    ``xk2`` enters the split ones of ``ck`` and ``cr`` through one
    ``copy_in`` (a whole one takes ``xk2`` itself), ``cv``'s partial output
    is summed, and the rank's columns of the receptance are gathered before
    the product."""
    B, T, d = x.shape
    hd = cfg.rwkv.head_dim
    route, up, rec = _rwkv_split(cfg)
    H = params["u"].shape[-2] if route != "cut" else d // hd  # this rank's heads: all of them but on "local"
    dh = H * hd

    # ---- time mix ----
    xn = rmsnorm(params["ln_scale"], x)
    prev_t = state["shift_t"] if state is not None else None
    xr = _token_shift(xn, params["mu_r"], prev_t)
    xk = _token_shift(xn, params["mu_k"], prev_t)
    xv = _token_shift(xn, params["mu_v"], prev_t)
    xw = _token_shift(xn, params["mu_w"], prev_t)
    xg = _token_shift(xn, params["mu_g"], prev_t)

    if route:  # each whole input's gradient, partial on each rank (its columns'), is summed before its mu's
        xr, xk, xv, xg = (tp.copy_in(t) for t in (xr, xk, xv, xg))

    r, k, v = dense(params["wr"], xr), dense(params["wk"], xk), dense(params["wv"], xv)
    g = F.silu(dense(params["wg"], xg))
    if route == "cut":  # every rank runs all the heads
        r, k, v, g = (tp.gather(t, -1) for t in (r, k, v, g))
    r, k, v = (t.reshape(B, T, H, hd) for t in (r, k, v))

    lora = torch.tanh(dense(params["w_lora_a"], xw))
    if route:  # after w_lora_a, as MLA's latent: w_lora_a's gradient is then whole
        lora = tp.copy_in(lora)
    w_dd = dense(params["w_lora_b"], lora).float()
    logw = -torch.exp(params["w0"] + w_dd)  # f32, <= 0
    logw = (tp.gather(logw, -1) if route == "cut" else logw).reshape(B, T, H, hd)

    loss_path = state is None and kops._differentiated(x, *params.values())
    if state is None and not loss_path:
        state = {"wkv": torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device),
                 "shift_t": torch.zeros((B, d), dtype=x.dtype, device=x.device),
                 "shift_c": torch.zeros((B, d), dtype=x.dtype, device=x.device)}
    y = kops.wkv6(r, k, v, logw, params["u"], None if loss_path else state["wkv"], chunk=cfg.rwkv.chunk)
    if not loss_path:
        state["shift_t"].copy_(xn[:, -1])

    y = y.reshape(B, T, dh).to(x.dtype) * g.to(x.dtype)
    if route:  # wo split on its rows
        o = tp.reduce_out(dense(params["wo"], y if route == "local" else tp.slice_(y, -1)))
    else:
        o = dense(params["wo"], y)
    x = x + o
    del o  # not kept alive through the channel mix: a prefill's peak counts it

    # ---- channel mix ----
    xn2 = rmsnorm(params["ln_scale"], x)  # the reference shares the scale
    xk2 = _token_shift(xn2, params["mu_ck"], None if loss_path else state["shift_c"])
    if not loss_path:
        state["shift_c"].copy_(xn2[:, -1])
    xs = tp.copy_in(xk2) if up or rec else xk2
    h = torch.square(torch.relu(dense(params["ck"], xs if up else xk2)))
    kv, rr = dense(params["cv"], h), torch.sigmoid(dense(params["cr"], xs if rec else xk2))
    if up:
        kv = tp.reduce_out(kv)
    if rec:
        rr = tp.gather(rr, -1)
    cm = kv * rr
    del kv, rr  # not kept alive through the residual's sum
    return x + cm, state


# the plan's dims where it splits the time mix by heads; ``u``'s only where model divides H too
_TIME = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "wo": 0, "w0": 0, "w_lora_a": None, "w_lora_b": 1}


def _rwkv_split(cfg: ModelConfig) -> Tuple[Optional[str], bool, bool]:
    """(the time mix's route, whether ``ck`` and ``cv`` are split on d_ff,
    whether ``cr`` is split on its output dim) in the current tensor-parallel
    context, as the plan splits them where ``model`` divides the dim: the
    route None where the time mix is whole, "local" where it is split by
    heads and ``u`` on its heads (H divides ``model``), "cut" where it is
    split and ``u`` whole (H does not divide it).  Raises on any other
    split."""
    dims = {n: tp.split_dim(n) for n in tuple(_TIME) + ("u", "ck", "cv", "cr")}
    time = {n: dims[n] for n in _TIME}
    up, rec = (dims["ck"], dims["cv"]), dims["cr"]
    if time not in (_TIME, dict.fromkeys(_TIME)) or dims["u"] not in ((0, None) if time["wr"] else (None,)) \
            or up not in ((1, 0), (None, None)) or rec not in (1, None):
        raise NotImplementedError(
            f"{cfg.name}: RWKV-6 split as {dims} over the mesh {tp.mesh_shape()}: the plan splits the time mix "
            "by heads (u where the heads divide model), ck and cv on d_ff and cr on its output dim")
    route = None if time["wr"] is None else ("local" if dims["u"] == 0 else "cut")
    return route, up == (1, 0), rec == 1


def rwkv6_state_shape(cfg: ModelConfig, batch: int):
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    H = d // hd
    return {
        "wkv": ((batch, H, hd, hd), torch.float32),
        "shift_t": ((batch, d), cfg.dtype),
        "shift_c": ((batch, d), cfg.dtype),
    }
