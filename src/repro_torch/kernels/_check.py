"""Argument checks shared by the kernels' wrappers: a wrapper raises on what
its kernel does not take, before any pointer reaches native code."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # DT_F32, DT_BF16 of csrc/common.cuh
# the head sizes each attention kernel is instantiated for; 80 is HuBERT-XLarge's
# (the flash forward and backward) and Zamba2-2.7B's (its shared block's prefill
# and decode step)
FLASH_HEAD_DIMS = (32, 64, 80, 128)
DECODE_HEAD_DIMS = (32, 64, 80, 128)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_no_grad(name: str, *tensors: torch.Tensor) -> None:
    """The kernels compute forward only and write through raw pointers, so an
    output would carry no gradient and nothing would say so: refuse instead."""
    require(
        not (torch.is_grad_enabled() and any(t.requires_grad for t in tensors)),
        f"{name}: the kernel computes no gradients, but an input requires grad; "
        "call it under torch.no_grad() or use a differentiable path",
    )


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    require(dev.type == "cuda", f"{name}: the kernel takes CUDA tensors, got one on {dev}")
    require(all(t.device == dev for t in tensors), f"{name}: tensors lie on different devices")
    require(dev.index == torch.cuda.current_device(), f"{name}: tensors lie on {dev}, not on the current device")
    return dev


def rows_aligned(t: torch.Tensor) -> bool:
    """Every row along the last axis starts on a 16-byte boundary."""
    per16 = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per16 == 0 for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)


def require_rows_aligned(name: str, what: str, t: torch.Tensor) -> None:
    """Rows along the last axis are contiguous and start on 16-byte boundaries."""
    require(t.stride(-1) == 1, f"{name}: {what} needs a unit stride along its last axis")
    require(rows_aligned(t), f"{name}: rows of {what} must start on 16-byte boundaries (strides {t.stride()})")
