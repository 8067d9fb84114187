"""Qwen1.5/2-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model=2048, 16H (GQA kv=16), vocab=151936,
MoE: 4 shared + 60 routed experts, top-4, expert d_ff=1408.
14,315,587,584 parameters in the tensors: 28.63 GB in bf16, which one H100
holds; in f32 it does not (57.26 GB, and the bf16 copy beside it).
"""
from repro_torch.models.modules import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        num_shared_experts=4,
        expert_d_ff=1408,
        capacity_factor=1.25,
    ),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B model card",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1, expert_d_ff=128),
    remat="none",
    source="reduced qwen2-moe-a2.7b",
)
