"""HuBERT-XLarge — encoder-only speech model [arXiv:2106.07447].

48L, d_model=1280, 16H, d_ff=5120, vocab=504 (k-means cluster targets).
The conv/mel frontend is a STUB per the assignment carve-out:
``input_specs`` supplies precomputed frame embeddings (B, T, 1280).
Encoder-only => no autoregressive decode; decode_32k / long_500k are
skipped (DESIGN.md §4).
"""
from repro_torch.models.modules import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,  # bidirectional encoder
    ffn_activation="gelu",
    tie_embeddings=False,  # inputs are frames, head is a classifier
    source="arXiv:2106.07447 (HuBERT)",
)

SMOKE_CONFIG = ModelConfig(
    name="hubert-smoke",
    family="audio",
    num_layers=2,
    d_model=192,
    num_heads=4,
    num_kv_heads=4,
    head_dim=48,
    d_ff=384,
    vocab_size=64,
    causal=False,
    ffn_activation="gelu",
    tie_embeddings=False,
    remat="none",
    source="reduced hubert-xlarge",
)
