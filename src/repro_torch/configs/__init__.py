"""Architecture registry of the port: the paper's GPT-A / GPT-B testbed models,
Minitron-4B and RWKV-6 7B.  The reference's other eight architectures come with
their families (MoE, MLA, M-RoPE, encoder, Mamba2, hybrid).

``get_config`` returns the full-size config; ``get_smoke_config`` the reduced
same-family variant the CPU tests use.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.modules import ModelConfig

ARCHS: List[str] = ["minitron_4b", "gpt_a", "gpt_b", "rwkv6_7b"]

# CLI ids (``--arch <id>``) use dashes
CLI_IDS = {a.replace("_", "-"): a for a in ARCHS}


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
