"""Argument checks shared by the kernels' wrappers: a wrapper raises on what
its kernel does not take, before any pointer reaches native code."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # DT_F32, DT_BF16 of csrc/common.cuh
HEAD_DIMS = (32, 64, 128)  # the head sizes the attention kernels are instantiated for


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    require(dev.type == "cuda", f"{name}: the kernel takes CUDA tensors, got one on {dev}")
    require(all(t.device == dev for t in tensors), f"{name}: tensors lie on different devices")
    require(dev.index == torch.cuda.current_device(), f"{name}: tensors lie on {dev}, not on the current device")
    return dev


def require_rows_aligned(name: str, what: str, t: torch.Tensor) -> None:
    """Rows along the last axis are contiguous and start on 16-byte boundaries."""
    per16 = 16 // t.element_size()
    require(t.stride(-1) == 1, f"{name}: {what} needs a unit stride along its last axis")
    require(
        t.data_ptr() % 16 == 0
        and all(s % per16 == 0 for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1),
        f"{name}: rows of {what} must start on 16-byte boundaries (strides {t.stride()})",
    )
