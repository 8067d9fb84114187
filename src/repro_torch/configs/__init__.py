"""Architecture registry of the port: the paper's GPT-A / GPT-B testbed models,
Minitron-4B, the dense decoders DeepSeek-Coder 33B, Granite-34B-Code and
Nemotron-4 15B, Qwen2-VL 7B (M-RoPE over precomputed embeddings), HuBERT-XLarge
(the bidirectional encoder), RWKV-6 7B, the MoE family (Qwen1.5-MoE-A2.7B,
DeepSeek-V2-Lite with MLA) and Zamba2-2.7B (Mamba2 and the hybrid stack): all
twelve of the reference's architectures.

``get_config`` returns the full-size config; ``get_smoke_config`` the reduced
same-family variant the CPU tests use.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.modules import ModelConfig

ARCHS: List[str] = ["rwkv6_7b", "minitron_4b", "zamba2_2p7b", "granite_34b", "hubert_xlarge", "deepseek_v2_lite_16b",
                    "nemotron_4_15b", "deepseek_coder_33b", "qwen2_vl_7b", "qwen2_moe_a2p7b", "gpt_a", "gpt_b"]

# CLI ids (``--arch <id>``) use dashes, and "2.7b" where the module reads "2p7b", as the reference's
CLI_IDS = {a.replace("_", "-").replace("-2p7b", "-2.7b").replace("-a2p7b", "-a2.7b"): a for a in ARCHS}


def canon(arch: str) -> str:
    arch = arch.strip()
    if arch in ARCHS:
        return arch
    if arch in CLI_IDS:
        return CLI_IDS[arch]
    alt = arch.replace("-", "_").replace(".", "p")
    if alt in ARCHS:
        return alt
    raise KeyError(f"unknown arch {arch!r}; known: {sorted(CLI_IDS)}")


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{canon(arch)}").CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{canon(arch)}").SMOKE_CONFIG
