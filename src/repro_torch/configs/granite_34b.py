"""Granite-34B-Code — llama-arch code model, extreme MQA [arXiv:2405.04324].

88L, d_model=6144, 48 heads with kv=1 (MQA), d_ff=24576, vocab=49152.
kv=1 cannot shard across the 16-way model axis: KV projections replicate
(handled by the divisibility-aware sharding rules).
"""
from repro_torch.models.modules import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    ffn_activation="swiglu",
    source="arXiv:2405.04324 (Granite Code Models)",
)

SMOKE_CONFIG = ModelConfig(
    name="granite-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=1,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    ffn_activation="swiglu",
    remat="none",
    source="reduced granite-34b",
)
