"""Configs, initialisers and primitive layers (``repro/models/modules.py``).

Parameters are nested dicts of tensors with the reference's keys and its
layer-stacked layout (leading ``L`` axis), so a converted checkpoint maps one to
one; every layer is a plain function ``f(params, x, ...) -> y``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.parallel import tensor_parallel as tp

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# config dataclasses (fields and defaults as the reference's)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    num_shared_experts: int = 0
    expert_d_ff: int = 1408
    capacity_factor: float = 1.25
    first_moe_layer: int = 0
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) settings."""

    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    max_seq_len: int = 8192
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    window: Optional[int] = None
    mla: Optional[MLAConfig] = None
    causal: bool = True
    ffn_activation: str = "swiglu"  # swiglu | relu2 | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    attn_period: int = 0
    shared_attn_block: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    tie_embeddings: bool = False
    remat: str = "full"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count, term for term as the reference counts it."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        if self.rwkv is not None:
            per = 6 * d * d + 2 * d * self.d_ff + d * self.d_ff
            return L * per + 2 * self.vocab_size * d
        attn = d * (self.num_heads * hd) * 2 + d * (self.num_kv_heads * hd) * 2
        if self.mla is not None:
            m = self.mla
            attn = (
                d * self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.num_heads * m.v_head_dim * d
            )
        glu = 3 if self.ffn_activation == "swiglu" else 2
        ffn = glu * d * self.d_ff
        per_layer = attn + ffn
        if self.family == "hybrid" and self.ssm is not None:
            n_attn = L // self.attn_period if self.attn_period else 0
            n_ssm = L - n_attn
            d_in = d * self.ssm.expand
            ssm_per = d * (2 * d_in + 2 * self.ssm.d_state) + d_in * d
            total = n_ssm * ssm_per + (1 if self.shared_attn_block else n_attn) * per_layer
        elif self.family == "ssm" and self.ssm is not None:
            d_in = d * self.ssm.expand
            total = L * (d * (2 * d_in + 2 * self.ssm.d_state) + d_in * d)
        elif self.moe is not None:
            e_ffn = 3 * d * self.moe.expert_d_ff  # experts use swiglu
            shared = self.moe.num_shared_experts * e_ffn
            router = d * self.moe.num_experts
            n_moe = L - self.moe.first_moe_layer
            n_dense = self.moe.first_moe_layer
            total = n_moe * (attn + self.moe.num_experts * e_ffn + shared + router) + n_dense * per_layer
        else:
            total = L * per_layer
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        e_ffn = 3 * self.d_model * self.moe.expert_d_ff
        n_moe = self.num_layers - self.moe.first_moe_layer
        return self.param_count() - n_moe * (self.moe.num_experts - self.moe.top_k) * e_ffn


# ---------------------------------------------------------------------------
# initialisers (explicit generator; the generator's device is the tensor's)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Sequence[int], dtype=torch.float32, scale: float = 1.0) -> torch.Tensor:
    """N(0, scale^2 / fan_in) drawn in f32, then cast: the same bits in any dtype
    as the f32 draw cast afterwards.  A layer-stacked leaf (three axes or more,
    the leading one the layers) is made in ``dtype`` first and drawn one layer
    at a time into it, in every dtype alike, so that making it costs one f32
    layer beside the leaf, not an f32 copy of the whole stack (DeepSeek-Coder
    33B's FFN leaf is 34 GB in f32)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    if len(shape) < 3:
        return torch.randn(tuple(shape), generator=gen, device=gen.device).mul_(std).to(dtype)
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    for layer in out:
        layer.copy_(torch.randn(tuple(shape[1:]), generator=gen, device=gen.device).mul_(std))
    return out


def embed_init(gen: torch.Generator, shape: Sequence[int], dtype=torch.float32) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device).mul_(0.02).to(dtype)


def rmsnorm_init(shape: Sequence[int], device, dtype=torch.float32) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def ffn_init(gen: torch.Generator, n_layers: int, d_model: int, d_ff: int, activation: str, dtype) -> Params:
    """Layer-stacked FFN weights (leading ``n_layers`` axis; fan-in is still d_in)."""
    p = {
        "w_up": dense_init(gen, (n_layers, d_model, d_ff), dtype),
        "w_down": dense_init(gen, (n_layers, d_ff, d_model), dtype),
    }
    if activation == "swiglu":
        p["w_gate"] = dense_init(gen, (n_layers, d_model, d_ff), dtype)
    return p


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Goes through the RMSNorm kernel on the card, its plain version on the CPU."""
    return kops.rmsnorm(x, scale, eps=eps)


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., d_in), w (d_in, d_out): the product runs in x's dtype.  The cast
    is a no-op for weights that were cast once beforehand (``Model.cast_params``)."""
    return x @ w.to(x.dtype)


def ffn_apply(params: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    """Under tensor parallelism (``parallel/tensor_parallel.py``) the plan
    splits ``w_gate`` and ``w_up`` on their output dim (this rank's columns of
    h) and ``w_down`` on its contracting dim (its output summed over ``model``);
    where it leaves one whole, h is gathered or sliced to match."""
    up, down = tp.split_dim("w_up"), tp.split_dim("w_down")
    x = tp.copy_in(x) if up == 1 else x
    if activation == "swiglu":
        h = F.silu(dense(params["w_gate"], x)) * dense(params["w_up"], x)
    elif activation == "relu2":
        h = torch.square(torch.relu(dense(params["w_up"], x)))
    elif activation == "gelu":
        h = F.gelu(dense(params["w_up"], x), approximate="tanh")  # the reference's gelu is the tanh form
    else:
        raise ValueError(f"unknown activation {activation}")
    if (up == 1) != (down == 0):
        h = tp.gather(h, -1) if up == 1 else tp.slice_(h, -1)
    y = dense(params["w_down"], h)
    return tp.reduce_out(y) if down == 0 else y


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross entropy; logits (..., V) upcast to f32.  With a mask,
    the sum over the mask divided by max(mask sum, 1)."""
    logits = logits.float()
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels.long()[..., None])[..., 0]
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
