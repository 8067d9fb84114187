"""What a kernel costs, and what its wrapper does on ``meta`` tensors.

The card's peaks.  NVIDIA's published dense figures for one H100 SXM at its
full 700 W limit (the H100 data sheet): 3.35 TB/s of HBM3, 989 TFLOP/s of bf16
on the tensor cores, 67 TFLOP/s of f32 on the CUDA cores; 132 SMs.  A kernel's
bound is the larger of its bytes (each input read once, each output written
once) over the memory rate and its operations over the rate of their type.
Each kernel's module gives the bytes and operations of its work
(``rmsnorm.fwd_cost``, ``flash_attention.fwd_cost``, ...); ``chip_smoke.py``'s
bound column and the dry-run read the same functions.

On a ``meta`` tensor a kernel's wrapper runs no kernel and no plain version:
it allocates what the card's wrapper allocates (outputs and scratch), computes
nothing, and ``record``s one launch with its operations and bytes into the
``Recorder`` that ``recording()`` made current, if one is.  The module
counters (``launches``, ``bwd_launches``) count the card's launches only and
are never touched on ``meta``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
SM_COUNT = 132  # an H100 SXM's SMs: what ``decode_attention.split_plan`` sizes its wave by on ``meta``

Cost = Tuple[int, int, float]  # (bytes, operations, the operations' peak rate)


def rate(dtype: torch.dtype) -> float:
    """The peak of the tensor cores for bf16 products, of the CUDA cores for f32."""
    return BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS


def bound(cost: Cost) -> Dict[str, object]:
    """{"bytes", "flops", "bound_ms", "bound_by", "bytes_ms", "operations_ms"}
    of one call's (bytes, operations, rate)."""
    nbytes, flops, peak = cost
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes_ms": bytes_ms, "operations_ms": ops_ms}


class Recorder:
    """The kernels a ``meta`` run launched: ``launches[name]``, and their
    summed ``flops`` and ``bytes``."""

    def __init__(self):
        self.launches: Dict[str, int] = {}
        self.flops = 0
        self.bytes = 0

    def add(self, name: str, cost: Cost) -> None:
        nbytes, flops, _ = cost
        self.launches[name] = self.launches.get(name, 0) + 1
        self.flops += flops
        self.bytes += nbytes


_current: Optional[Recorder] = None


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """A fresh ``Recorder`` that every ``meta`` launch in the block adds to."""
    global _current
    prev, _current = _current, Recorder()
    try:
        yield _current
    finally:
        _current = prev


def record(name: str, cost: Cost) -> None:
    """One ``meta`` launch of kernel ``name``: added to the current recorder, if any."""
    if _current is not None:
        _current.add(name, cost)


def on_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"
