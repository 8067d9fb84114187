"""GPT-B — the paper's §3 larger testbed model: context 6K, hidden 8K,
~1.2B params/layer (4·H² + 2·H·d_ff = 268M + 940M with d_ff=57344).
"""
from repro_torch.models.modules import ModelConfig

CONFIG = ModelConfig(
    name="gpt-b",
    family="dense",
    num_layers=16,
    d_model=8192,
    num_heads=64,
    num_kv_heads=64,
    head_dim=128,
    d_ff=57344,
    vocab_size=50304,
    max_seq_len=6144,
    ffn_activation="gelu",
    source="paper §3 baseline model (GPT-B)",
)

SMOKE_CONFIG = ModelConfig(
    name="gpt-b-smoke",
    family="dense",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=1024,
    vocab_size=512,
    ffn_activation="gelu",
    remat="none",
    source="reduced gpt-b",
)
