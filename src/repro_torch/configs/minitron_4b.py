"""Minitron-4B — width-pruned Nemotron-4 [arXiv:2407.14679].

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=9216, vocab=256000.
Nemotron family => squared-ReLU FFN, RoPE.
"""
from repro_torch.models.modules import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    ffn_activation="relu2",
    source="arXiv:2407.14679 (Compact LMs via pruning+distillation)",
)

SMOKE_CONFIG = ModelConfig(
    name="minitron-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    ffn_activation="relu2",
    remat="none",
    source="reduced minitron-4b",
)
