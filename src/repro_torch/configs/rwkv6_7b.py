"""RWKV-6 "Finch" 7B — attention-free, data-dependent decay [arXiv:2404.05892].

32L, d_model=4096, d_ff=14336, vocab=65536.  Linear recurrence => O(1)
decode state: the state a sequence hands from prefill to decode is the same
34,078,720 bytes whatever the prompt length.
"""
from repro_torch.models.modules import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,  # wkv heads = d_model / head_dim
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, chunk=128),
    causal=True,
    source="arXiv:2404.05892 (RWKV-5/6: Eagle & Finch)",
)

SMOKE_CONFIG = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=128,
    num_heads=2,
    num_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    rwkv=RWKVConfig(head_dim=64, chunk=32),
    causal=True,
    remat="none",
    source="reduced rwkv6-7b",
)
