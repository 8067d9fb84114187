"""DeepSeek-Coder 33B — llama-arch code model [arXiv:2401.14196].

62L, d_model=7168, 56H (GQA kv=8), d_ff=19200, vocab=32256.
"""
from repro_torch.models.modules import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    ffn_activation="swiglu",
    source="arXiv:2401.14196 (DeepSeek-Coder)",
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-coder-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=8,
    num_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    ffn_activation="swiglu",
    remat="none",
    source="reduced deepseek-coder-33b",
)
