"""GPT-A — the paper's §3 testbed model: "similar to GPT-3", context 4K,
hidden 4K, ~412M params/layer.  Layer size ≈ 4·H² (attn) + 2·H·d_ff with
d_ff chosen to land near the paper's 412M figure.
"""
from repro_torch.models.modules import ModelConfig

CONFIG = ModelConfig(
    name="gpt-a",
    family="dense",
    num_layers=24,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=16384,  # 4·H² + 2·H·d_ff ≈ 67M + 134M... paper counts fp16 bytes; see note
    vocab_size=50304,
    ffn_activation="gelu",
    source="paper §3 baseline model (GPT-A)",
)

SMOKE_CONFIG = ModelConfig(
    name="gpt-a-smoke",
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
    source="reduced gpt-a",
)
