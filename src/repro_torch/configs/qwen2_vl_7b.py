"""Qwen2-VL 7B — M-RoPE, dynamic resolution [arXiv:2409.12191].

28L, d_model=3584, 28H (GQA kv=4), d_ff=18944, vocab=152064.
M-RoPE sections (16, 24, 24) over the 64-dim rotary half.

Vision frontend (ViT + projector) is a STUB per the assignment carve-out:
``input_specs`` supplies precomputed sequence embeddings (text tokens and
image patches interleaved, already projected to d_model) plus the 3-row
(temporal/height/width) M-RoPE position ids.  Decode consumes text tokens.
"""
from repro_torch.models.modules import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    ffn_activation="swiglu",
    source="arXiv:2409.12191 (Qwen2-VL)",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    mrope_sections=(8, 12, 12),
    ffn_activation="swiglu",
    remat="none",
    source="reduced qwen2-vl-7b",
)
