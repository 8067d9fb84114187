"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54L, d_model=2560, Mamba2 ssm_state=64; a single *shared* transformer block
(32H GQA kv=32, d_ff=10240, heads of 80) applied every 6 layers (9
invocations), each after 5 Mamba2 layers.  The real model adds
per-invocation LoRA deltas on the shared block; the reference shares the
weights exactly (a noted deviation), and so does the port.
2,052,915,200 parameters by ``param_count``: 4.11 GB in bf16.
"""
from repro_torch.models.modules import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128),
    attn_period=6,
    shared_attn_block=True,
    source="arXiv:2411.15242 (Zamba2 suite)",
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk=32),
    attn_period=2,
    shared_attn_block=True,
    remat="none",
    source="reduced zamba2-2.7b",
)
