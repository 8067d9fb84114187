"""Nemotron-4 15B [arXiv:2402.16819].

32L, d_model=6144, 48H (GQA kv=8), d_ff=24576, vocab=256000,
squared-ReLU FFN (no GLU), RoPE.
"""
from repro_torch.models.modules import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    ffn_activation="relu2",
    source="arXiv:2402.16819 (Nemotron-4 15B)",
)

SMOKE_CONFIG = ModelConfig(
    name="nemotron-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    ffn_activation="relu2",
    remat="none",
    source="reduced nemotron-4-15b",
)
