"""Parameters between the JAX package's tree and the port's state.

The reference's parameters are a nested dict of arrays whose ``"/"``-joined
paths (``repro/ckpt/checkpoint.py::_flatten``) read ``embed``, ``final_norm``,
``lm_head``, ``layers/ln1``, ``layers/attn/wq``, ``layers/ffn/w_up``, ...; the
layers are stacked on a leading ``L`` axis (the hybrid's ``groups/mamba/...`` on
(G, M), its ``groups/gate`` (G,), and ``shared_attn/...``, one block with no
layer axis).  The port keeps the same keys and
the same stacking, so conversion is one to one and exact.  numpy has no bf16:
such leaves travel as f32, which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.modules import ModelConfig, Params
from repro_torch.models.rwkv import F32_KEYS as RWKV_F32_KEYS
from repro_torch.models.rwkv import LORA as RWKV_LORA
from repro_torch.models.transformer import NORM_KEYS, SSMModel

_SEP = "/"


def _rwkv_layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.rwkv.head_dim
    shapes = {f"layers/{m}": (L, d) for m in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "w0", "ln_scale", "mu_ck")}
    shapes.update({f"layers/{w}": (L, d, d) for w in ("wr", "wk", "wv", "wg", "wo", "cr")})
    shapes.update({
        "layers/w_lora_a": (L, d, RWKV_LORA),
        "layers/w_lora_b": (L, RWKV_LORA, d),
        "layers/u": (L, d // hd, hd),
        "layers/ck": (L, d, cfg.d_ff),
        "layers/cv": (L, cfg.d_ff, d),
    })
    return shapes


def _attn_shapes(cfg: ModelConfig, pre: str, lead: tuple) -> Dict[str, tuple]:
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    if cfg.mla is not None:
        m = cfg.mla
        shapes = {
            "wq": (d, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
            "w_dkv": (d, m.kv_lora_rank + m.qk_rope_head_dim),
            "w_uk": (m.kv_lora_rank, H * m.qk_nope_head_dim),
            "w_uv": (m.kv_lora_rank, H * m.v_head_dim),
            "wo": (H * m.v_head_dim, d),
        }
    else:
        shapes = {"wq": (d, H * hd), "wk": (d, cfg.num_kv_heads * hd), "wv": (d, cfg.num_kv_heads * hd),
                  "wo": (H * hd, d)}
    return {f"{pre}attn/{k}": lead + s for k, s in shapes.items()}


def _ffn_shapes(cfg: ModelConfig, pre: str, lead: tuple) -> Dict[str, tuple]:
    d = cfg.d_model
    if cfg.moe is not None:
        m = cfg.moe
        E, f = m.num_experts, m.expert_d_ff
        shapes = {"moe/router": (d, E), "moe/w_gate": (E, d, f), "moe/w_up": (E, d, f), "moe/w_down": (E, f, d)}
        if m.num_shared_experts:
            sf = m.num_shared_experts * f
            shapes.update({"moe/shared/w_gate": (d, sf), "moe/shared/w_up": (d, sf), "moe/shared/w_down": (sf, d)})
    else:
        shapes = {"ffn/w_up": (d, cfg.d_ff), "ffn/w_down": (cfg.d_ff, d)}
        if cfg.ffn_activation == "swiglu":
            shapes["ffn/w_gate"] = (d, cfg.d_ff)
    return {f"{pre}{k}": lead + s for k, s in shapes.items()}


def _block_shapes(cfg: ModelConfig, pre: str, lead: tuple) -> Dict[str, tuple]:
    """A transformer block's leaves under ``pre``, with leading axes ``lead``."""
    shapes = {f"{pre}ln1": lead + (cfg.d_model,), f"{pre}ln2": lead + (cfg.d_model,)}
    shapes.update(_attn_shapes(cfg, pre, lead))
    shapes.update(_ffn_shapes(cfg, pre, lead))
    return shapes


def _mamba_shapes(cfg: ModelConfig, pre: str, lead: tuple) -> Dict[str, tuple]:
    """A pre-normed Mamba2 layer's leaves (``ln`` and ``mamba/*``) under ``pre``."""
    s, d = cfg.ssm, cfg.d_model
    d_in = d * s.expand
    H, n2 = d_in // s.head_dim, 2 * s.d_state
    shapes = {"ln": (d,), "mamba/w_z": (d, d_in), "mamba/w_x": (d, d_in), "mamba/w_bc": (d, n2),
              "mamba/w_dt": (d, H), "mamba/conv_x": (s.conv_width, d_in), "mamba/conv_bc": (s.conv_width, n2),
              "mamba/A_log": (H,), "mamba/D": (H,), "mamba/dt_bias": (H,), "mamba/w_out": (d_in, d),
              "mamba/norm_scale": (d_in,)}
    return {f"{pre}{k}": lead + v for k, v in shapes.items()}


def expected_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Path -> shape of every leaf of a decoder's (dense or MoE, GQA or MLA), an
    RWKV-6 stack's, a Mamba2 stack's or the hybrid's state."""
    L, d = cfg.num_layers, cfg.d_model
    shapes = {"embed": (cfg.vocab_size, d), "final_norm": (d,)}
    if cfg.rwkv is not None:
        shapes.update(_rwkv_layer_shapes(cfg))
    elif cfg.family == "hybrid":
        G = L // cfg.attn_period
        shapes.update(_mamba_shapes(cfg, "groups/mamba/", (G, cfg.attn_period - 1)))
        shapes["groups/gate"] = (G,)
        shapes.update(_block_shapes(cfg, "shared_attn/", ()))
    elif cfg.family == "ssm":
        shapes.update(_mamba_shapes(cfg, "layers/", (L,)))
    else:
        shapes.update(_block_shapes(cfg, "layers/", (L,)))
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, cfg.vocab_size)
    return shapes


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a/b/c": leaf}, the paths the reference's checkpoints use."""
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten(v, path))
        else:
            flat[path] = v
    return flat


def tree_map(fn, tree: Any) -> Any:
    """``fn`` of every leaf of a nested dict, in a nested dict of the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def from_reference(params_numpy: Dict[str, Any], cfg: ModelConfig, device="cpu") -> Params:
    """The reference's tree (nested dict of numpy arrays) as the port's state on
    ``device``: matrices in ``cfg.param_dtype``, norm scales (and RWKV's mix
    coefficients, w0 and u, the MoE router, Mamba2's A_log, D and dt_bias and
    the hybrid's gate) in f32, as the reference initialises them.  Raises on a
    missing, extra or misshapen leaf."""
    flat = flatten(params_numpy)
    want = expected_shapes(cfg)
    f32_keys = NORM_KEYS + ("router",) + (RWKV_F32_KEYS if cfg.rwkv is not None else
                                          SSMModel.KEEP_F32 if cfg.ssm is not None else ())
    if set(flat) != set(want):
        raise ValueError(f"parameter paths differ: missing {sorted(set(want) - set(flat))}, extra {sorted(set(flat) - set(want))}")
    out = {}
    for path, leaf in flat.items():
        arr = np.asarray(leaf)
        if tuple(arr.shape) != want[path]:
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, expected {want[path]}")
        dtype = torch.float32 if path.split(_SEP)[-1] in f32_keys else cfg.param_dtype
        out[path] = torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)  # a copy: the state never aliases the caller's arrays
    return unflatten(out)


def to_reference(params: Params) -> Dict[str, Any]:
    """The port's state as a nested dict of numpy arrays (bf16 leaves as f32)."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return unflatten({path: leaf(t) for path, t in flatten(params).items()})
