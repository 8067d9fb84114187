"""Attention (``repro/models/attention.py``): MHA/GQA/MQA with RoPE or
Qwen2-VL's M-RoPE, causal or bidirectional, with an optional sliding window,
and DeepSeek-V2's MLA, over explicit position ids, so that one code path serves
prefill (q_pos == kv_pos) and single-token decode against a ring KV cache.

Layout conventions (the reference's):
  q           (B, T, Hq,  Dh)
  k, v        (B, S, Hkv, Dh)
  positions   (B, T), or (3, B, T) under M-RoPE (temporal, height, width)
  kv cache    {"k": (B, S, Hkv, Dh), "v": ..., "pos": (B, S) int32 (-1 = empty)}
  MLA cache   {"ckv": (B, S, kv_lora), "k_rope": (B, S, rope_dim), "pos": (B, S)}

GQA goes through the flash and decode kernels; MLA is plain torch, as the
reference computes it (no kernel of the reference takes the latent form).  A
windowed prefill takes the masked plain ``sdpa`` (the flash kernel has no
window, as the reference's kernel route requires ``window is None``); a
windowed decode step goes to the decode kernel, which takes the window.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.modules import ModelConfig, Params, dense, dense_init
from repro_torch.parallel import tensor_parallel as tp

NEG_INF = -2.0**30

# implementation switch: "kernel" (the hand-written kernels on the card, their
# plain versions on the CPU) or "torch" (the position-masked sdpa below).
_IMPL = "kernel"

# calls of the masked plain sdpa, counted beside the kernels' launch counters
sdpa_masked_calls = 0


def set_attention_impl(impl: str) -> None:
    global _IMPL
    if impl not in ("kernel", "torch"):
        raise ValueError(f"unknown attention impl {impl!r}")
    _IMPL = impl


def get_attention_impl() -> str:
    return _IMPL


@contextlib.contextmanager
def force_impl(impl: str):
    """Pin the attention impl for the duration.

    The flash kernel takes no positions, so any caller whose positions are not
    dense 0..T-1 (serving's left-padded prefill, pad slots at position -1) must
    run under ``force_impl("torch")`` to keep the position mask."""
    global _IMPL
    prev = _IMPL
    set_attention_impl(impl)
    try:
        yield
    finally:
        _IMPL = prev


def check_supported(cfg: ModelConfig) -> None:
    """Raises for a config the attention cannot run: M-RoPE on MLA (the
    reference rotates MLA's keys with plain RoPE over (B, T) positions, so
    it has no such path either), or M-RoPE sections that do not split the
    rotary half of the head (the reference asserts it when it traces)."""
    if cfg.mrope_sections is None:
        return
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: M-RoPE on MLA has no reference path")
    if sum(cfg.mrope_sections) != cfg.resolved_head_dim // 2:
        raise ValueError(f"{cfg.name}: M-RoPE sections {cfg.mrope_sections} do not sum to half the head "
                         f"size {cfg.resolved_head_dim}")


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., head_dim // 2) in f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    return positions.float()[..., None] * freqs


def _rotate_half(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D) rotated by ang (B, T, 1, D/2) in the rotate-half form, in f32."""
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D), positions (B, T) -> rotated x (rotate-half form)."""
    return _rotate_half(x, _rope_angles(positions, x.shape[-1], theta)[..., None, :])


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, sections: Tuple[int, int, int], theta: float) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x (B, T, H, D), positions (3, B, T), the
    temporal, height and width ids (text tokens carry (t, t, t), and then this
    is ``apply_rope``).  ``sections`` split the rotary half of D; section i
    takes its angles from positions[i]."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    ang_all = _rope_angles(positions, x.shape[-1], theta)  # (3, B, T, half)
    bounds = [0, sections[0], sections[0] + sections[1], half]
    ang = torch.cat([ang_all[i, ..., bounds[i]:bounds[i + 1]] for i in range(3)], dim=-1)
    return _rotate_half(x, ang[..., None, :])


def _rotate(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.mrope_sections is not None:
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# scaled dot-product attention over explicit positions
# ---------------------------------------------------------------------------


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention. q (B,T,Hq,D); k/v (B,S,Hkv,D).

    q_pos (B, T), kv_pos (B, S); kv_pos < 0 marks empty cache slots.  Under the
    "kernel" impl a prefill over dense positions goes to the flash kernel and
    a single query to the decode kernel; everything else, and everything under
    "torch", takes the position-masked plain path below.
    """
    global sdpa_masked_calls
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D**-0.5

    if _IMPL == "kernel" and T > 1 and window is None and q_pos.shape == kv_pos.shape:
        return kops.flash_attention(q, k, v, causal=causal, scale=scale)
    if _IMPL == "kernel" and T == 1:
        return kops.decode_attention(q, k, v, q_pos, kv_pos, window=window, scale=scale)

    sdpa_masked_calls += 1
    qf = (q.float() * scale).reshape(B, T, Hkv, G, D)
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    mask = (kv_pos[:, None, :] >= 0).expand(B, T, S)
    if causal:
        mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        mask = mask & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    scores = torch.where(mask[:, None, None, :, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(B, T, Hq, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block (with optional cache)
# ---------------------------------------------------------------------------


def gqa_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int, dtype=None) -> Params:
    """Layer-stacked projection weights (leading ``n_layers`` axis) in ``dtype``
    (default ``cfg.param_dtype``)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    pdt = dtype or cfg.param_dtype
    return {
        "wq": dense_init(gen, (n_layers, d, cfg.num_heads * hd), pdt),
        "wk": dense_init(gen, (n_layers, d, cfg.num_kv_heads * hd), pdt),
        "wv": dense_init(gen, (n_layers, d, cfg.num_kv_heads * hd), pdt),
        "wo": dense_init(gen, (n_layers, cfg.num_heads * hd, d), pdt),
    }


def gqa_apply(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """x (B, T, d), positions (B, T), or (3, B, T) under M-RoPE, whose
    temporal row ``positions[0]`` is what the mask and the ring see.

    With ``cache``: a prefill (T > 1) attends causally (whatever
    ``cfg.causal``, as the reference) over the prompt's own full-resolution
    K/V and only then writes the last S tokens into the ring at slots
    ``pos % S``; a decode step (T == 1) writes first and then attends over the
    ring.  **The cache's tensors are updated in place** and returned.  The
    slots are distinct only where the positions are (the reference assumes
    it): a VLM batch's image patches, all at temporal position 0, all write
    slot 0, which keeps one of them, which one unspecified (ROADMAP Queue 3).

    Under tensor parallelism (``parallel/tensor_parallel.py``, no cache) the
    plan splits ``wq``, ``wk`` and ``wv`` on their output dim and ``wo`` on
    its contracting dim.  Where every rank's columns are whole heads that line
    up (H and Hkv divide over ``model``), the rank attends with its own H/TP
    heads and ``wo``'s output is summed over ``model``.  Where the plan cuts
    inside a head (Granite's one kv head, Qwen2-VL's 28 heads at TP 16), each
    split projection's output is gathered before the rotary embedding, every
    rank attends with all heads, and ``wo`` takes the rank's rows of its input:
    the re-layout GSPMD makes there.
    """
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    split = {n: tp.split_dim(n) for n in ("wq", "wk", "wv", "wo")}
    cols = [n for n in ("wq", "wk", "wv") if split[n] == 1]
    local = len(cols) == 3 and tp.divides(cfg.num_heads) and tp.divides(cfg.num_kv_heads)
    xs = tp.copy_in(x) if cols else x

    def project(name: str) -> torch.Tensor:
        if split[name] != 1:
            return dense(params[name], x)
        y = dense(params[name], xs)
        return y if local else tp.gather(y, -1)

    q = project("wq").reshape(B, T, -1, hd)
    k = project("wk").reshape(B, T, -1, hd)
    v = project("wv").reshape(B, T, -1, hd)
    scalar_pos = positions if positions.dim() == 2 else positions[0]
    q = _rotate(cfg, q, positions)
    k = _rotate(cfg, k, positions)

    if cache is None:
        out = sdpa(q, k, v, scalar_pos, scalar_pos, causal=cfg.causal, window=cfg.window)
        new_cache = None
    else:
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        S = ck.shape[1]
        if T > 1:
            out = sdpa(q, k, v, scalar_pos, scalar_pos, causal=True, window=cfg.window)
            kw, vw, pw = k[:, -S:], v[:, -S:], scalar_pos[:, -S:]
        else:
            kw, vw, pw = k, v, scalar_pos
        # the non-negative remainder: pads (position -1) all land in slot S-1,
        # which keeps pos = -1 and so stays masked whichever pad wrote last
        slots = torch.remainder(pw, S).long()
        bidx = torch.arange(B, device=x.device)[:, None]
        ck[bidx, slots] = kw
        cv[bidx, slots] = vw
        cpos[bidx, slots] = pw.to(cpos.dtype)
        if T == 1:
            out = sdpa(q, ck, cv, scalar_pos, cpos, causal=True, window=cfg.window)
        new_cache = {"k": ck, "v": cv, "pos": cpos}

    out = out.reshape(B, T, -1)
    if split["wo"] == 0:
        return tp.reduce_out(dense(params["wo"], out if local else tp.slice_(out, -1))), new_cache
    return dense(params["wo"], tp.gather(out, -1) if local else out), new_cache


def gqa_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    """Per-layer cache shapes. Sliding window bounds the ring size."""
    S = min(max_len, cfg.window) if cfg.window else max_len
    hd = cfg.resolved_head_dim
    return {
        "k": ((batch, S, cfg.num_kv_heads, hd), cfg.dtype),
        "v": ((batch, S, cfg.num_kv_heads, hd), cfg.dtype),
        "pos": ((batch, S), torch.int32),
    }


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------

# the up-projections MLA applies in f32 (``mla_apply`` casts them up, so the
# computing copy keeps them as made)
MLA_F32_KEYS = ("w_uk", "w_uv")


def _last_writer(slots: torch.Tensor, S: int) -> torch.Tensor:
    """slots (B, T) of a ring of S -> (B, T): for each t, the last t' of its row
    that writes the same slot.  Writing the value of t' at every t makes a
    write with repeated slots (a ragged row's pads, all at slot S-1; a prompt
    longer than the ring) keep the last value, as the reference's scatter
    does, whatever order the device applies repeated writes in."""
    B, T = slots.shape
    t = torch.arange(T, device=slots.device).expand(B, T)
    last = torch.full((B, S), -1, dtype=t.dtype, device=slots.device).scatter_reduce(1, slots, t, "amax")
    return last.gather(1, slots)


def mla_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int, dtype=None) -> Params:
    """Layer-stacked MLA weights: the projections in ``dtype`` (default
    ``cfg.param_dtype``), the up-projections ``MLA_F32_KEYS`` in
    ``cfg.param_dtype`` whatever ``dtype``."""
    m, d, H, L = cfg.mla, cfg.d_model, cfg.num_heads, n_layers
    pdt = dtype or cfg.param_dtype
    return {
        # queries: full-rank (V2-Lite has no q-LoRA)
        "wq": dense_init(gen, (L, d, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)), pdt),
        # down-projection to the shared latent + decoupled rope key
        "w_dkv": dense_init(gen, (L, d, m.kv_lora_rank + m.qk_rope_head_dim), pdt),
        # up-projections from the latent
        "w_uk": dense_init(gen, (L, m.kv_lora_rank, H * m.qk_nope_head_dim), cfg.param_dtype),
        "w_uv": dense_init(gen, (L, m.kv_lora_rank, H * m.v_head_dim), cfg.param_dtype),
        "wo": dense_init(gen, (L, H * m.v_head_dim, d), pdt),
    }


def mla_apply(
    params: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """MLA with latent-space ("weight absorbed") attention, in f32:
        score = ((q_nope W_uk)ᵀ c_kv + q_ropeᵀ k_rope) scale
        out   = (probs c_kv) W_uv
    The cache holds only the latent and the shared rope key.  With ``cache``,
    the T new latents are written at slots ``positions % S`` first (a pad at
    position -1 lands in slot S-1 and keeps pos -1; of writes to one slot the
    last is kept, ``_last_writer``) and the queries attend over the ring, the
    pads' queries (no valid slot) over all of it; **the cache's tensors are
    updated in place** and returned.

    Under tensor parallelism (``parallel/tensor_parallel.py``, no cache) the
    plan splits ``wq``, ``w_uk`` and ``w_uv`` on their output dim, whose
    columns are head-major, and ``wo`` on its rows, each where ``model``
    divides that dim; ``w_dkv`` stays whole.  Where all three are split and
    H divides ``model`` (``_mla_split``'s local route), the rank attends with
    its H / TP heads: its queries from ``copy_in(x)``, the whole latent, and
    ``wo``'s output summed over ``model``.  The latent goes through
    ``copy_in`` after its product, so that its gradient, partial on each rank
    (its heads'), is summed over ``model`` before ``w_dkv``'s gradient is
    formed from it: ``w_dkv`` is then whole and the same on every rank.
    Where the plan cuts inside a head (the columns divide, H does not), the
    re-layout GSPMD makes there: ``wq``'s output, where split, is gathered
    after its product from ``copy_in(x)``; ``w_uk`` and ``w_uv``, where
    split, are gathered themselves (``gather``'s backward takes the rank's
    block of their gradient); every rank attends with all H heads from the
    same whole latent, which therefore takes no ``copy_in``; and ``wo``,
    where split, takes the rank's rows of its input and its output is summed
    over ``model``."""
    m = cfg.mla
    B, T, _ = x.shape
    dn, dr = m.qk_nope_head_dim, m.qk_rope_head_dim
    scale = (dn + dr) ** -0.5
    split, local = _mla_split(cfg)
    cut = {n: split[n] == 1 and not local for n in ("wq", "w_uk", "w_uv")}  # gathered: every rank runs all heads
    H = params["wq"].shape[-1] // (dn + dr) if local else cfg.num_heads  # this rank's heads

    q = dense(params["wq"], tp.copy_in(x) if split["wq"] == 1 else x)
    q = (tp.gather(q, -1) if cut["wq"] else q).reshape(B, T, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    # absorb W_uk into the query: (B,T,H,dn) x (lora,H,dn) -> (B,T,H,lora)
    w_uk = (tp.gather(params["w_uk"], -1) if cut["w_uk"] else params["w_uk"]).reshape(m.kv_lora_rank, H, dn)
    q_lat = torch.einsum("bthd,rhd->bthr", q_nope.float(), w_uk.float())

    dkv = dense(params["w_dkv"], x)
    if local:  # every rank's heads read the whole latent: its gradient is summed before w_dkv's
        dkv = tp.copy_in(dkv)
    ckv, k_rope = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if cache is None:
        kv_pos, ckv_all, k_rope_all = positions, ckv, k_rope
        new_cache = None
    else:
        ckv_all, k_rope_all, kv_pos = cache["ckv"], cache["k_rope"], cache["pos"]
        S = ckv_all.shape[1]
        slots = torch.remainder(positions, S).long()
        bidx = torch.arange(B, device=x.device)[:, None]
        new_ckv, new_k_rope, new_pos = ckv, k_rope, positions
        if T > 1:
            src = _last_writer(slots, S)
            new_ckv = ckv.gather(1, src[..., None].expand(B, T, ckv.shape[-1]))
            new_k_rope = k_rope.gather(1, src[..., None].expand(B, T, k_rope.shape[-1]))
            new_pos = positions.gather(1, src)
        ckv_all[bidx, slots] = new_ckv
        k_rope_all[bidx, slots] = new_k_rope
        kv_pos[bidx, slots] = new_pos.to(kv_pos.dtype)
        new_cache = {"ckv": ckv_all, "k_rope": k_rope_all, "pos": kv_pos}

    scores = torch.einsum("bthr,bsr->bhts", q_lat, ckv_all.float())
    scores = scores + torch.einsum("bthd,bsd->bhts", q_rope.float(), k_rope_all.float())
    scores = scores * scale
    mask = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= positions[:, :, None])
    scores = torch.where(mask[:, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    lat_out = torch.einsum("bhts,bsr->bthr", probs, ckv_all.float())
    w_uv = (tp.gather(params["w_uv"], -1) if cut["w_uv"] else params["w_uv"]).reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bthr,rhv->bthv", lat_out, w_uv.float())
    out = out.reshape(B, T, H * m.v_head_dim).to(x.dtype)
    if split["wo"] == 0:
        return tp.reduce_out(dense(params["wo"], out if local else tp.slice_(out, -1))), new_cache
    return dense(params["wo"], tp.gather(out, -1) if local else out), new_cache


def _mla_split(cfg: ModelConfig) -> Tuple[dict, bool]:
    """(the dim of each of ``wq``, ``w_uk``, ``w_uv`` and ``wo`` that the
    current tensor-parallel context splits, whether the rank attends with its
    own heads): the plan splits each of the first three on its output dim
    and ``wo`` on its rows where ``model`` divides that dim, and ``w_dkv``
    never; the heads are the rank's own where the first three are split and
    H divides ``model``.  Raises on any other split."""
    dims = {n: tp.split_dim(n) for n in ("wq", "w_uk", "w_uv", "wo")}
    if any(dims[n] not in (1, None) for n in ("wq", "w_uk", "w_uv")) or dims["wo"] not in (0, None) \
            or tp.split_dim("w_dkv") is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA split as {dims} (w_dkv: {tp.split_dim('w_dkv')}) over the mesh {tp.mesh_shape()}: "
            "the plan splits wq, w_uk and w_uv on their output dim and wo on its rows, and leaves w_dkv whole")
    return dims, all(dims[n] == 1 for n in ("wq", "w_uk", "w_uv")) and tp.divides(cfg.num_heads)


def mla_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    m = cfg.mla
    S = min(max_len, cfg.window) if cfg.window else max_len
    return {
        "ckv": ((batch, S, m.kv_lora_rank), cfg.dtype),
        "k_rope": ((batch, S, m.qk_rope_head_dim), cfg.dtype),
        "pos": ((batch, S), torch.int32),
    }
