"""DeepSeek-V2-Lite 16B — MLA + fine-grained MoE [arXiv:2405.04434].

27L, d_model=2048, 16H (MLA kv_lora=512), vocab=102400,
MoE: 2 shared + 64 routed experts, top-6, expert d_ff=1408.

Note: the assignment line reads "MoE 64e top-6" while its bracket note
says "2 shared+160 routed"; we follow the primary spec (64 routed), which
also matches the DeepSeek-V2-Lite model card. The real model keeps layer 0
dense; we make all layers MoE to keep the stack scan-homogeneous (noted
deviation).
"""
from repro_torch.models.modules import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,  # routed expert width
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        expert_d_ff=1408,
        capacity_factor=1.25,
    ),
    source="arXiv:2405.04434 (DeepSeek-V2)",
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-v2-lite-smoke",
    family="moe",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32),
    moe=MoEConfig(num_experts=4, top_k=2, num_shared_experts=1, expert_d_ff=128),
    remat="none",
    source="reduced deepseek-v2-lite-16b",
)
