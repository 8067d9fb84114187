"""``repro/models/transformer.py``: the transformer (``_build_transformer``;
the dense decoder, the MoE with GQA or MLA attention, the VLM over precomputed
embeddings and M-RoPE positions, and the bidirectional audio encoder) as
``Model``, with ``init``, ``cast_params``, ``loss``, ``prefill``,
``decode_step`` and ``cache_shape``; the RWKV-6 stack (``_build_rwkv``) as
``RWKVModel``, with the same methods (its loss through the WKV-6 backward); the
pure Mamba2 stack (``_build_ssm``) as ``SSMModel`` and the Zamba2 hybrid
(``_build_hybrid``: groups of Mamba2 layers, each followed by one *shared*
transformer block) as ``HybridModel``, both with the same methods;
``build_model`` dispatches as the reference's does; ``build_pipeline_parts``
gives the per-layer view that the cross-pod pipeline
(``repro_torch/parallel/pipeline.py``) runs, from the same layer functions as
the backbones.

Parameters are layer-stacked (leading ``L`` axis; the hybrid's Mamba2 layers
``(G, M)``) as in the reference; the reference's ``lax.scan`` over the stack is
a Python loop here, and its ``jax.checkpoint`` of the scanned body
(``cfg.remat``) a ``torch.utils.checkpoint`` of each block (of each group in the
hybrid).  Under FSDP (``repro_torch/parallel/fsdp.py``) each block gathers its
leaves over ``data`` inside the function that remat wraps, so a checkpointed
block keeps only its blocks and gathers again when it is recomputed; a leaf
split over ``data`` on the stack's own axis is gathered once, before the
stack is taken apart (``_layers``).  Under tensor parallelism a hybrid group
gathers the Mamba2 leaves the plan splits on M over ``model``
(``tensor_parallel.gather_stacked``), inside its remat.  A cache
is a flat dict of tensors: the hybrid's nested tree reads
``mamba/ssm``, ``mamba/conv_x``, ``mamba/conv_bc``, ``attn/k``, ``attn/v`` and
``attn/pos``, with the reference's shapes leaf for leaf.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.modules import (
    ModelConfig,
    Params,
    dense,
    embed_init,
    ffn_apply,
    ffn_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.parallel import fsdp
from repro_torch.parallel import tensor_parallel as tp

NORM_KEYS = ("ln1", "ln2", "final_norm")  # f32 scales: RMSNorm runs in f32 whatever cfg.dtype
# the leaves the computing copy keeps as made: the norm scales, the MoE router
# (the reference contracts it in f32) and MLA's up-projections (applied in f32)
KEEP_KEYS = NORM_KEYS + ("router",) + attn.MLA_F32_KEYS
LOSS_CHUNK = 256  # sequence chunk for the big-vocabulary cross entropy (bounds the f32 logits)

# the products whose outputs remat "dots" keeps (the reference's
# dots_with_no_batch_dims_saveable: matrix products without batch dims)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _recompute_as_run(contexts: Optional[Callable] = None):
    """``context_fn`` of a checkpoint: the recomputation in the backward runs
    under the attention impl that the forward ran under (a batch that
    ``_inputs_to_embeds`` pins to the masked plain ``sdpa`` leaves that pin
    before its backward), inside ``contexts``' pair where given."""
    forward, recompute = contexts() if contexts else (contextlib.nullcontext(), contextlib.nullcontext())
    return forward, _entered(recompute, attn.force_impl(attn.get_attention_impl()))


def _remat(fn: Callable, policy: str) -> Callable:
    """``fn`` as the reference's ``_remat`` wraps it: "none" keeps every
    activation, "full" keeps only the inputs and recomputes the rest in the
    backward, "dots" keeps the matrix products' outputs as well."""
    if policy == "none":
        return fn
    if policy == "dots":
        context = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=functools.partial(_recompute_as_run, context))
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, context_fn=_recompute_as_run)
    raise ValueError(f"unknown remat policy {policy!r}")


def _unstack(tree: Any, n: int) -> list:
    """The ``n`` layers of a layer-stacked tree, each leaf taken apart once by
    ``unbind``: views, so a cache written in place is written in the stack.
    Differentiated, its backward stacks the n gradients in one copy, where
    slicing layer by layer would give every layer's gradient a zero-filled
    leaf of the whole stack to be added up."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def _layers(params: Params, key: str, n: int) -> list:
    """The ``n`` layers (or groups) of the stack ``params[key]``, each leaf
    that FSDP splits over ``data`` on the stack's axis gathered whole first
    (``fsdp.gather_stack``: once a step, outside remat)."""
    return _unstack(fsdp.gather_stack(params[key], key), n)


def _block_init(gen: torch.Generator, cfg: ModelConfig, n_layers: int, dtype) -> Params:
    """``n_layers`` transformer blocks, layer-stacked: the norm scales in f32,
    the attention and the FFN (or the MoE) in ``dtype``."""
    p: Params = {
        "ln1": rmsnorm_init((n_layers, cfg.d_model), gen.device),
        "ln2": rmsnorm_init((n_layers, cfg.d_model), gen.device),
        "attn": (attn.mla_init if cfg.mla is not None else attn.gqa_init)(gen, cfg, n_layers, dtype),
    }
    if cfg.moe is not None:
        p["moe"] = moe_lib.moe_init(gen, cfg, n_layers, dtype)
    else:
        p["ffn"] = ffn_init(gen, n_layers, cfg.d_model, cfg.d_ff, cfg.ffn_activation, dtype)
    return p


def _block_apply(params: Params, cfg: ModelConfig, x, positions, cache, gate=None):
    """One transformer block. Returns (x, new_cache, aux): aux is the MoE's
    load-balance loss, None for a dense block.  ``gate`` (a 0-d tensor,
    optional) multiplies the residual deltas, cast to the activation dtype as
    the reference casts it: the hybrid's per-group gate on its shared block."""
    g = None if gate is None else gate.to(cfg.dtype)
    h = rmsnorm(params["ln1"], x)
    attend = attn.mla_apply if cfg.mla is not None else attn.gqa_apply
    a, new_cache = attend(params["attn"], cfg, h, positions, cache)
    x = x + (a if g is None else a * g)
    h = rmsnorm(params["ln2"], x)
    if cfg.moe is not None:
        f, aux = moe_lib.moe_apply(params["moe"], cfg, h)
    else:
        f, aux = ffn_apply(params["ffn"], h, cfg.ffn_activation), None
    return x + (f if g is None else f * g), new_cache, aux


def _rwkv_layer(lp: Params, cfg: ModelConfig, x, cache=None):
    """One RWKV-6 block (time mix and channel mix, each with its residual);
    the state ``cache``, where given, is updated in place."""
    return rwkv_lib.rwkv6_apply(lp, cfg, x, cache)[0]


def _mamba_layer(lp: Params, cfg: ModelConfig, x, cache=None):
    """One pre-normed Mamba2 layer with its residual."""
    y, _ = ssm_lib.mamba2_apply(lp["mamba"], cfg, rmsnorm(lp["ln"], x), cache)
    return x + y


def _hybrid_group(gp: Params, shared: Params, cfg: ModelConfig, x, positions, cache=None):
    """One Zamba2 group: its ``attn_period - 1`` Mamba2 layers, then the shared
    block with the group's ``gate`` (a gate of 0 makes the block the identity).
    ``cache`` None or (the group's Mamba2 states, its attention ring).
    Returns (x, aux) as ``_block_apply``."""
    M = cfg.attn_period - 1
    mcaches = [None] * M if cache is None else _unstack(cache[0], M)
    for lp, lc in zip(_unstack(tp.gather_stacked(gp["mamba"]), M), mcaches):  # the leaves split on M, whole
        x = _mamba_layer(lp, cfg, x, lc)
    return _block_apply(shared, cfg, x, positions, None if cache is None else cache[1], gate=gp["gate"])[::2]


def _embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of the tokens, cast; under tensor parallelism, whose plan
    splits ``embed`` on its features, this rank's columns of them gathered
    over ``model`` (under FSDP the table is first gathered over ``data``)."""
    x = fsdp.gather_leaf(params["embed"], "embed")[tokens.long()].to(cfg.dtype)  # gather, then cast
    return tp.gather(x, -1) if tp.split_dim("embed") == 1 else x


def _head_weight(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The (d, V) head weight, gathered over ``data`` under FSDP."""
    if cfg.tie_embeddings:
        return fsdp.gather_leaf(params["embed"], "embed").T  # (d, V)
    return fsdp.gather_leaf(params["lm_head"], "lm_head")


def _head_split(cfg: ModelConfig) -> Optional[int]:
    """The dim of the (d, V) head weight that tensor parallelism splits over
    ``model``: ``lm_head``'s (the vocabulary), or for a tied embedding, split
    on its features, the contracting dim 0; None where it is whole."""
    if not cfg.tie_embeddings:
        return tp.split_dim("lm_head")
    return None if tp.split_dim("embed") is None else 1 - tp.split_dim("embed")


def _cast_tree(params: Params, dtype: torch.dtype, keep: Tuple[str, ...]) -> Params:
    """Every leaf but those under a key in ``keep`` in ``dtype``; a leaf that
    already has its dtype is shared, not copied."""

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return tree if key in keep else tree.to(dtype)

    return walk(params)


def _default_positions(shape, device) -> torch.Tensor:
    B, T = shape
    return torch.arange(T, dtype=torch.int32, device=device)[None].expand(B, T)


def _inputs_to_embeds(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """(x, positions, route) of a batch, as the reference's ``inputs_to_embeds``:
    ``embeds`` (a VLM's or an audio model's precomputed frontend) cast to
    ``cfg.dtype``, else the tokens embedded; the batch's ``positions``, else
    the default 0..T-1, broadcast to (3, B, T) under M-RoPE.

    ``route`` is the context to run the batch's layers in: the masked plain
    ``sdpa`` (``force_impl("torch")``) for a batch of ``embeds`` with
    positions of its own, the current impl for any other.  That is the
    pipeline's VLM batch, whose image patches share temporal position 0 and
    attend one another both ways under the reference's position mask, which the
    flash kernel (causal by index, no positions) cannot give.  The choice
    follows from the batch's keys alone, with no look at the positions and so
    no host sync; a decode step never makes it.  Token batches keep the kernel
    (the serving engine pins its ragged ones itself), as do ``embeds`` without
    positions (an audio batch: dense by construction)."""
    if "embeds" in batch:
        x = batch["embeds"].to(cfg.dtype)
    else:
        x = _embed_tokens(params, cfg, batch["tokens"])
    return x, _batch_positions(cfg, batch, x.shape[:2], x.device), _batch_route(batch)


def _batch_positions(cfg: ModelConfig, batch: Dict[str, torch.Tensor], shape, device) -> torch.Tensor:
    """The batch's ``positions``, else the default 0..T-1 over ``shape``
    (B, T), broadcast to (3, B, T) under M-RoPE."""
    positions = batch.get("positions")
    if positions is None:
        positions = _default_positions(shape, device)
        if cfg.mrope_sections is not None:
            positions = positions[None].expand(3, *positions.shape)
    return positions


def _batch_route(batch: Dict[str, torch.Tensor]):
    """The context a batch's layers run in (``_inputs_to_embeds``)."""
    pinned = "embeds" in batch and "positions" in batch
    return attn.force_impl("torch") if pinned else contextlib.nullcontext()


def _lm_loss_chunked(x: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, split: Optional[int] = None) -> torch.Tensor:
    """Next-token cross entropy in sequence chunks of ``min(LOSS_CHUNK, T)``.

    x (B, T, d) already final-normed; labels (B, T) the targets at each
    position (shifted by the caller); mask (B, T) optional.  T is padded to a
    multiple of the chunk with mask 0; each chunk's logits are computed in x's
    dtype, then taken to f32.  Returns sum(nll * mask) / max(sum(mask), 1).

    ``split`` (``_head_split``) is the dim of ``w_head`` that tensor
    parallelism splits: 1, this rank's columns of the vocabulary, whose logits
    stay local and whose cross entropy is taken over the ranks
    (``tp.vocab_parallel_nll``); 0, its rows, whose partial logits are summed."""
    B, T, d = x.shape
    if split is not None:
        x = tp.copy_in(x) if split == 1 else tp.slice_(x, -1)
    chunk = min(LOSS_CHUNK, T)
    pad = (-T) % chunk
    pad_mask = torch.ones((B, T), dtype=torch.float32, device=x.device) if mask is None else mask.float()
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        pad_mask = torch.nn.functional.pad(pad_mask, (0, pad))
    w = w_head.to(x.dtype)
    total = x.new_zeros((), dtype=torch.float32)
    for c0 in range(0, T + pad, chunk):
        logits = x[:, c0:c0 + chunk] @ w
        logits = (tp.reduce_out(logits) if split == 0 else logits).float()
        if split == 1:
            nll = tp.vocab_parallel_nll(logits, labels[:, c0:c0 + chunk])
        else:
            gold = logits.gather(-1, labels[:, c0:c0 + chunk].long()[..., None])[..., 0]
            nll = torch.logsumexp(logits, dim=-1) - gold
        total = total + (nll * pad_mask[:, c0:c0 + chunk]).sum()
    return total / torch.clamp(pad_mask.sum(), min=1.0)


def _next_token_targets(tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(targets, mask) of a language model: the next token at each position,
    the last position (which has none) masked."""
    targets = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    mask = torch.ones(targets.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return targets, mask


def _loss_targets(batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(targets, mask) of a batch's loss, as the reference's: its ``labels``
    with its ``mask`` (None: every position counts), else the next tokens."""
    if "labels" in batch:
        return batch["labels"], batch.get("mask")
    return _next_token_targets(batch["tokens"])


class Model:
    """Functional model object: the methods take the parameters explicitly."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "moe", "vlm", "audio") or (cfg.family == "moe") != (cfg.moe is not None) \
                or cfg.ssm is not None or cfg.rwkv is not None:
            raise NotImplementedError(f"{cfg.name}: Model takes the transformer families (dense, MoE with its "
                                      f"MoEConfig, VLM, audio), not family {cfg.family!r} with these sub-configs; "
                                      "build_model gives RWKV-6, Mamba2 and the hybrid their own classes")
        attn.check_supported(cfg)
        self.cfg = cfg

    def init(self, gen: torch.Generator, dtype: Optional[torch.dtype] = None) -> Params:
        """Random parameters on the generator's device, in ``cfg.param_dtype``.
        With ``dtype``, every leaf that ``cast_params`` casts is made in
        ``dtype`` instead, each drawn in f32 and cast as it is made: with
        ``dtype=cfg.dtype`` the result is bit for bit ``cast_params(init(gen))``
        without the f32 master ever being held (how a 14-16B MoE fits one card)."""
        cfg, L = self.cfg, self.cfg.num_layers
        pdt = dtype or cfg.param_dtype
        layers = _block_init(gen, cfg, L, pdt)  # drawn before the embedding, as before
        p: Params = {
            "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), pdt),
            "final_norm": rmsnorm_init((cfg.d_model,), gen.device),
            "layers": layers,
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), pdt)
        return p

    def cast_params(self, params: Params) -> Params:
        """The copy the forward pass computes with: every matrix in ``cfg.dtype``
        (``dense`` casts its weight to the activation dtype before the product,
        so casting once beforehand gives the same bits), the leaves of
        ``KEEP_KEYS`` as they are (the norm scales, the f32 router, MLA's
        up-projections).  A leaf that already has its dtype is shared, not copied."""
        return _cast_tree(params, self.cfg.dtype, KEEP_KEYS)

    def _backbone(self, params: Params, x, positions, cache):
        """Loop over the blocks. cache None or a stacked (L, ...) tree, updated
        in place.  Differentiated (a loss), each block runs under ``cfg.remat``.
        Returns (normed x, cache, the aux losses summed over the layers)."""
        cfg, L = self.cfg, self.cfg.num_layers

        def block(lp, h, lc):  # (x, aux); under FSDP the layer gathers inside remat
            return _block_apply(fsdp.gather_layer(lp, "layers"), cfg, h, positions, lc)[::2]

        if torch.is_grad_enabled() and cache is None:
            block = _remat(block, cfg.remat)
        caches = [None] * L if cache is None else _unstack(cache, L)
        aux = torch.zeros((), device=x.device)
        for lp, lc in zip(_layers(params, "layers", L), caches):
            x, a = block(lp, x, lc)
            if a is not None:
                aux = aux + a
        return rmsnorm(params["final_norm"], x), cache, aux

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch {"tokens" (B,T) int32 or "embeds" (B,T,d), optional
        "positions" (B,T) or (3,B,T), optional "labels" (B,T) with "mask"
        (B,T)}.  Takes the f32 master parameters: ``dense`` casts each weight
        to the activation dtype, so autograd gives f32 gradients on the f32
        leaves.  Returns (ce + aux, {"ce", "aux"}); aux is the MoE load-balance
        loss summed over the layers, 0 for the other families.  A decoder
        without labels takes the next tokens as targets, the last position
        masked; the encoder (``cfg.causal`` False) classifies every frame
        against ``labels``, weighted by ``mask``.  A batch of ``embeds`` with
        its own positions runs under the masked plain ``sdpa``
        (``_inputs_to_embeds``)."""
        cfg = self.cfg
        x, positions, route = _inputs_to_embeds(params, cfg, batch)
        with route:
            x, _, aux = self._backbone(params, x, positions, None)
        ce = _lm_loss_chunked(x, _head_weight(params, cfg), *_loss_targets(batch), split=_head_split(cfg))
        return ce + aux, {"ce": ce, "aux": aux}

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], cache) -> Tuple[torch.Tensor, Any]:
        """batch {"tokens" (B,T) int32 or "embeds" (B,T,d), optional
        "positions" (B,T) or (3,B,T) int32}.  Returns (last-token logits f32
        (B,V), cache); the cache, where given, is updated in place, and with
        one the attention is causal whatever ``cfg.causal`` (the reference's
        rule).  A batch of ``embeds`` with its own positions runs under the
        masked plain ``sdpa`` (``_inputs_to_embeds``)."""
        cfg = self.cfg
        x, positions, route = _inputs_to_embeds(params, cfg, batch)
        with route:
            x, cache, _ = self._backbone(params, x, positions, cache)
        logits = dense(_head_weight(params, cfg), x[:, -1])
        return logits.float(), cache

    def decode_step(self, params: Params, cache, tokens: torch.Tensor, pos: torch.Tensor):
        """tokens (B,) int32; pos (B,) int32 absolute positions, broadcast to
        (3, B, 1) under M-RoPE.  Returns (logits f32 (B,V), cache); the cache
        is updated in place."""
        cfg = self.cfg
        x = _embed_tokens(params, cfg, tokens[:, None])
        positions = pos[:, None].contiguous()
        if cfg.mrope_sections is not None:
            positions = positions[None].expand(3, *positions.shape)
        x, cache, _ = self._backbone(params, x, positions, cache)
        logits = dense(_head_weight(params, cfg), x[:, 0])
        return logits.float(), cache

    def cache_shape(self, batch: int, max_len: int):
        """{name: (shape, dtype)} of the layer-stacked cache: the KV ring, or
        MLA's latent ring."""
        cache_shape = attn.mla_cache_shape if self.cfg.mla is not None else attn.gqa_cache_shape
        per = cache_shape(self.cfg, batch, max_len)
        return {k: ((self.cfg.num_layers,) + s, d) for k, (s, d) in per.items()}


class RWKVModel:
    """The RWKV-6 stack (``repro/models/transformer.py::_build_rwkv``): the same
    methods as ``Model``, over a recurrent state instead of a KV ring."""

    # f32 in the computing copy: RMSNorm takes an f32 scale, and the reference
    # adds w0 to an f32 term and casts u to f32.  The mu_* are cast: the
    # reference casts them to the activation dtype on every use.
    KEEP_F32 = ("ln_scale", "final_norm", "w0", "u")

    def __init__(self, cfg: ModelConfig):
        if cfg.rwkv is None:
            raise ValueError(f"{cfg.name}: not an RWKV config")
        self.cfg = cfg

    def init(self, gen: torch.Generator, dtype: Optional[torch.dtype] = None) -> Params:
        """Random parameters in ``cfg.param_dtype`` (the reference's f32 leaves
        f32).  With ``dtype``, the matrices are made in it and the result is
        ``cast_params``'d: bit for bit ``cast_params(init(gen))`` for
        ``dtype=cfg.dtype``, as ``Model.init``."""
        cfg = self.cfg
        pdt = dtype or cfg.param_dtype
        p: Params = {
            "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), pdt),
            "final_norm": rmsnorm_init((cfg.d_model,), gen.device),
            "layers": rwkv_lib.rwkv6_init(gen, cfg, cfg.num_layers, pdt),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), pdt)
        return p if dtype is None else self.cast_params(p)

    def cast_params(self, params: Params) -> Params:
        """Every leaf but ``KEEP_F32`` in ``cfg.dtype``; a leaf that already has
        its dtype is shared, not copied."""
        return _cast_tree(params, self.cfg.dtype, self.KEEP_F32)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch {"tokens" (B,T) int32}: the next-token cross entropy, the last
        position masked.  Returns (ce, {"ce"}), as the reference."""
        tokens = batch["tokens"]
        x, _ = self._backbone(params, _embed_tokens(params, self.cfg, tokens), None)
        targets, mask = _next_token_targets(tokens)
        ce = _lm_loss_chunked(x, _head_weight(params, self.cfg), targets, mask, split=_head_split(self.cfg))
        return ce, {"ce": ce}

    def _backbone(self, params: Params, x, cache):
        """Loop over the blocks. cache None or the layer-stacked state, updated
        in place; each block under ``cfg.remat`` when differentiated.  Returns
        (normed x, cache)."""
        L = self.cfg.num_layers
        block = lambda lp, h, lc: _rwkv_layer(fsdp.gather_layer(lp, "layers"), self.cfg, h, lc)  # noqa: E731
        if torch.is_grad_enabled() and cache is None:
            block = _remat(block, self.cfg.remat)
        caches = [None] * L if cache is None else _unstack(cache, L)
        for lp, lc in zip(_layers(params, "layers", L), caches):
            x = block(lp, x, lc)
        return rmsnorm(params["final_norm"], x), cache

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], cache) -> Tuple[torch.Tensor, Any]:
        """batch {"tokens" (B,T) int32}; positions, where given, are not read.
        Returns (last-token logits f32 (B,V), cache); the cache is updated in place."""
        x = _embed_tokens(params, self.cfg, batch["tokens"])
        x, cache = self._backbone(params, x, cache)
        return dense(_head_weight(params, self.cfg), x[:, -1]).float(), cache

    def decode_step(self, params: Params, cache, tokens: torch.Tensor, pos: torch.Tensor):
        """tokens (B,) int32; pos is not read (the state carries the history)."""
        x = _embed_tokens(params, self.cfg, tokens[:, None])
        x, cache = self._backbone(params, x, cache)
        return dense(_head_weight(params, self.cfg), x[:, 0]).float(), cache

    def cache_shape(self, batch: int, max_len: int):
        """{name: (shape, dtype)} of the layer-stacked state; no slot ring."""
        per = rwkv_lib.rwkv6_state_shape(self.cfg, batch)
        return {k: ((self.cfg.num_layers,) + s, d) for k, (s, d) in per.items()}


class SSMModel:
    """The pure Mamba2 stack (``repro/models/transformer.py::_build_ssm``):
    ``init``, ``cast_params``, ``loss``, ``prefill``, ``decode_step`` and
    ``cache_shape``, over a recurrent state (the cache leaves ``ssm``,
    ``conv_x``, ``conv_bc``, layer-stacked) instead of a KV ring."""

    # f32 in the computing copy: the norm scales (RMSNorm takes an f32 scale)
    # and the leaves Mamba2 reads in f32 (A_log, D, dt_bias), and the hybrid's
    # gate, which the block casts to the activation dtype where it is used
    KEEP_F32 = NORM_KEYS + ("ln", "gate") + ssm_lib.F32_KEYS

    def __init__(self, cfg: ModelConfig):
        if cfg.ssm is None or cfg.rwkv is not None:
            raise ValueError(f"{cfg.name}: not a Mamba2 config")
        self.cfg = cfg

    def _head(self, gen: torch.Generator, pdt) -> Params:
        cfg = self.cfg
        p: Params = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), pdt),
                     "final_norm": rmsnorm_init((cfg.d_model,), gen.device)}
        if not cfg.tie_embeddings:
            p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), pdt)
        return p

    def _mamba_layers(self, gen: torch.Generator, lead: Tuple[int, ...], pdt) -> Params:
        return {"ln": rmsnorm_init(lead + (self.cfg.d_model,), gen.device),
                "mamba": ssm_lib.mamba2_init(gen, self.cfg, lead, pdt)}

    def init(self, gen: torch.Generator, dtype: Optional[torch.dtype] = None) -> Params:
        """Random parameters in ``cfg.param_dtype`` (the reference's f32 leaves
        f32).  With ``dtype``, the matrices are made in it and the result is
        ``cast_params``'d, as ``RWKVModel.init``."""
        pdt = dtype or self.cfg.param_dtype
        p = self._head(gen, pdt)
        p["layers"] = self._mamba_layers(gen, (self.cfg.num_layers,), pdt)
        return p if dtype is None else self.cast_params(p)

    def cast_params(self, params: Params) -> Params:
        """Every leaf but ``KEEP_F32`` in ``cfg.dtype``; a leaf that already has
        its dtype is shared, not copied."""
        return _cast_tree(params, self.cfg.dtype, self.KEEP_F32)

    def _mamba(self, lp: Params, x, lc):
        """One pre-normed Mamba2 layer with its residual (``_mamba_layer``),
        its leaves gathered over ``data`` under FSDP."""
        return _mamba_layer(fsdp.gather_layer(lp, "layers"), self.cfg, x, lc)

    def _backbone(self, params: Params, x, positions, cache):
        """Loop over the layers (positions are not read). cache None or the
        layer-stacked state, updated in place; each layer under ``cfg.remat``
        when differentiated.  Returns (normed x, cache)."""
        L = self.cfg.num_layers
        layer = self._mamba
        if torch.is_grad_enabled() and cache is None:
            layer = _remat(layer, self.cfg.remat)
        caches = [None] * L if cache is None else _unstack(cache, L)
        for lp, lc in zip(_layers(params, "layers", L), caches):
            x = layer(lp, x, lc)
        return rmsnorm(params["final_norm"], x), cache

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch {"tokens" (B,T) int32}: the next-token cross entropy, the last
        position masked.  Returns (ce, {"ce"}), as the reference."""
        tokens = batch["tokens"]
        x = _embed_tokens(params, self.cfg, tokens)
        x, _ = self._backbone(params, x, _default_positions(tokens.shape, x.device), None)
        targets, mask = _next_token_targets(tokens)
        ce = _lm_loss_chunked(x, _head_weight(params, self.cfg), targets, mask, split=_head_split(self.cfg))
        return ce, {"ce": ce}

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], cache) -> Tuple[torch.Tensor, Any]:
        """batch {"tokens" (B,T) int32}.  The positions are 0..T-1 whatever the
        batch holds, as the reference's (the engine serves a recurrent family's
        ragged batch one request at a time).  Returns (last-token logits f32
        (B,V), cache); the cache is updated in place."""
        tokens = batch["tokens"]
        x = _embed_tokens(params, self.cfg, tokens)
        x, cache = self._backbone(params, x, _default_positions(tokens.shape, x.device), cache)
        return dense(_head_weight(params, self.cfg), x[:, -1]).float(), cache

    def decode_step(self, params: Params, cache, tokens: torch.Tensor, pos: torch.Tensor):
        """tokens (B,) int32; pos (B,) int32 absolute positions (read by the
        hybrid's attention only).  Returns (logits f32 (B,V), cache); the cache
        is updated in place."""
        x = _embed_tokens(params, self.cfg, tokens[:, None])
        x, cache = self._backbone(params, x, pos[:, None].contiguous(), cache)
        return dense(_head_weight(params, self.cfg), x[:, 0]).float(), cache

    def cache_shape(self, batch: int, max_len: int):
        """{name: (shape, dtype)} of the layer-stacked state; no slot ring."""
        per = ssm_lib.mamba2_state_shape(self.cfg, batch)
        return {k: ((self.cfg.num_layers,) + s, d) for k, (s, d) in per.items()}


class HybridModel(SSMModel):
    """Zamba2's hybrid stack (``repro/models/transformer.py::_build_hybrid``):
    G = num_layers / attn_period groups, each of M = attn_period - 1 Mamba2
    layers and then the one shared transformer block, whose residual deltas
    the group's ``gate`` multiplies.  Parameters ``groups/mamba/...`` (G, M,
    ...), ``groups/gate`` (G,) and ``shared_attn/...`` (one block, no layer
    axis); the cache ``mamba/*`` (G, M, B, ...) and ``attn/*`` (G, B, S, ...)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        if not cfg.attn_period or cfg.num_layers % cfg.attn_period:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole groups of {cfg.attn_period}")
        attn.check_supported(cfg)
        self.groups, self.m_per = cfg.num_layers // cfg.attn_period, cfg.attn_period - 1

    def init(self, gen: torch.Generator, dtype: Optional[torch.dtype] = None) -> Params:
        pdt = dtype or self.cfg.param_dtype
        p = self._head(gen, pdt)
        p["groups"] = {"mamba": self._mamba_layers(gen, (self.groups, self.m_per), pdt),
                       # a gate of 0 makes a group's shared block the identity
                       "gate": torch.ones((self.groups,), dtype=torch.float32, device=gen.device)}
        block = _block_init(gen, self.cfg, 1, pdt)
        p["shared_attn"] = _unstack(block, 1)[0]
        return p if dtype is None else self.cast_params(p)

    def _backbone(self, params: Params, x, positions, cache):
        """Loop over the groups: the group's Mamba2 layers, then the shared
        block with the group's gate and attention cache.  Differentiated, each
        group runs under ``cfg.remat``.  Returns (normed x, cache)."""
        cfg, G = self.cfg, self.groups
        shared = params["shared_attn"]

        def group(gp, h, gc):  # under FSDP the group and the shared block gather inside remat, the latter G times
            return _hybrid_group(fsdp.gather_layer(gp, "groups"), fsdp.gather_layer(shared, "shared_attn"), cfg, h,
                                 positions, gc)[0]

        if torch.is_grad_enabled() and cache is None:
            group = _remat(group, cfg.remat)
        if cache is None:
            caches = [None] * G
        else:
            part = {s: {k.split("/", 1)[1]: v for k, v in cache.items() if k.startswith(s + "/")}
                    for s in ("mamba", "attn")}
            caches = list(zip(_unstack(part["mamba"], G), _unstack(part["attn"], G)))
        for gp, gc in zip(_layers(params, "groups", G), caches):
            x = group(gp, x, gc)
        return rmsnorm(params["final_norm"], x), cache

    def cache_shape(self, batch: int, max_len: int):
        """{name: (shape, dtype)}: ``mamba/*`` (G, M, B, ...), ``attn/*`` (G, B, S, ...)."""
        G, M = self.groups, self.m_per
        out = {f"mamba/{k}": ((G, M) + s, d) for k, (s, d) in ssm_lib.mamba2_state_shape(self.cfg, batch).items()}
        out.update({f"attn/{k}": ((G,) + s, d) for k, (s, d) in attn.gqa_cache_shape(self.cfg, batch, max_len).items()})
        return out


@dataclasses.dataclass
class PipelineParts:
    """Uniform per-layer view of a model for the cross-pod pipeline
    (``repro_torch/parallel/pipeline.py``), as the reference's: ``layer`` is
    the same function for every slice of the stacked layer parameters, so
    every stage runs the same code on its own slice.  A batch's layers run
    under ``_batch_route(batch)``, as ``Model.loss`` runs them."""

    layer_key: str  # the params key holding the (L, ...) stacked layer params
    embed: Callable[[Params, Dict], Tuple[torch.Tensor, torch.Tensor]]  # (params, batch) -> (x, positions)
    layer: Callable[..., Tuple[torch.Tensor, Optional[torch.Tensor]]]
    # (layer_params, full_params, x, positions) -> (x, aux): aux the MoE's
    # load-balance loss, None for a layer that has none (the reference's 0.0)
    final_loss: Callable[..., torch.Tensor]  # (full_params, x, targets, mask) -> scalar CE


def build_pipeline_parts(cfg: ModelConfig) -> PipelineParts:
    """``repro/models/transformer.py::build_pipeline_parts``: the embedding,
    one layer of the stack (an RWKV-6 block; a Zamba2 group of Mamba2 layers
    and the gated shared block; a Mamba2 layer; a transformer block) and the
    final norm with the chunked cross entropy, each through the function the
    model's own backbone runs."""

    def embed(params, batch):
        return _inputs_to_embeds(params, cfg, batch)[:2]

    def final_loss(params, x, targets, mask):  # under tensor parallelism over the vocabulary's ranks, as Model.loss
        return _lm_loss_chunked(rmsnorm(params["final_norm"], x), _head_weight(params, cfg), targets, mask,
                                split=_head_split(cfg))

    if cfg.rwkv is not None:
        def layer(lp, params, x, positions):
            return _rwkv_layer(lp, cfg, x), None

        return PipelineParts("layers", embed, layer, final_loss)

    if cfg.family == "hybrid":
        def layer(gp, params, x, positions):
            return _hybrid_group(gp, params["shared_attn"], cfg, x, positions)

        return PipelineParts("groups", embed, layer, final_loss)

    if cfg.family == "ssm":
        def layer(lp, params, x, positions):
            return _mamba_layer(lp, cfg, x), None

        return PipelineParts("layers", embed, layer, final_loss)

    def layer(lp, params, x, positions):
        return _block_apply(lp, cfg, x, positions, None)[::2]

    return PipelineParts("layers", embed, layer, final_loss)


def build_model(cfg: ModelConfig):
    if cfg.rwkv is not None:
        return RWKVModel(cfg)
    if cfg.family == "hybrid":
        return HybridModel(cfg)
    if cfg.family == "ssm":
        return SSMModel(cfg)
    return Model(cfg)
