"""RMSNorm: the CUDA kernels' wrappers (forward and backward), their plain
versions, their launch counts and ``RMSNormFn``, the autograd Function that
joins them.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm_rows`` (body
``_rmsnorm_kernel``); the backward is the port's counterpart of what XLA
derives for the reference's jnp ``rmsnorm`` when it trains.  Both are bound by
bytes on this card: the forward reads x and writes y, ``2 * N * d *
itemsize``; the backward reads x and dy and writes dx, ``3 * N * d *
itemsize``; see ``csrc/rmsnorm.cu``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._check import DTYPE_CODES, require, require_cuda, require_no_grad

launches = 0  # one more for every forward kernel launch; reset by whoever wants to count a run
bwd_launches = 0  # one more for every backward launch (its two kernels count once)


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,): f32 inside, output in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dscale f32) for x (..., d), scale (d,), dy like x; f32
    inside.  With g = dy * scale and r = rsqrt(mean(x^2) + eps):
    dx = r g - x r^3 mean(g x), dscale = sum over rows of dy x r."""
    x32, dy32 = x.float(), dy.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    g = dy32 * scale.float()
    dx = r * g - x32 * r.pow(3) * (g * x32).mean(dim=-1, keepdim=True)
    dscale = (dy32 * x32 * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (N, d) contiguous f32/bf16 on the card, scale (d,) f32 -> (N, d).  Launches the kernel."""
    global launches
    require_no_grad("rmsnorm", x, scale)
    require_cuda("rmsnorm", x, scale)
    require(x.dtype in DTYPE_CODES, f"rmsnorm: f32 or bf16, got {x.dtype}")
    require(x.dim() == 2 and x.is_contiguous(), f"rmsnorm: x must be (N, d) contiguous, got {tuple(x.shape)} strides {x.stride()}")
    n, d = x.shape
    require(n >= 1 and d >= 1, "rmsnorm: empty input")
    require(scale.dtype == torch.float32 and scale.shape == (d,) and scale.is_contiguous(),
            f"rmsnorm: scale must be ({d},) f32 contiguous, got {tuple(scale.shape)} {scale.dtype}")
    require(d * 4 <= 227 * 1024, f"rmsnorm: a row of {d} does not fit in shared memory")
    y = torch.empty_like(x)
    per16 = 16 // x.element_size()
    vec = int(d % per16 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, y, scale)))
    lib = build.load()
    code = lib.rmsnorm_launch(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), n, d, float(eps), DTYPE_CODES[x.dtype], vec,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(code, "rmsnorm")
    launches += 1
    return y


def bwd_grid(n: int, d: int, dtype: torch.dtype, vec: int) -> Tuple[int, int]:
    """(blocks, threads) of the backward's first kernel for ``n`` rows of
    ``d``: one dscale partial row a block; ``threads`` is a block's of
    ``rmsnorm_bwd_reg_kernel``, 0 where the rows take ``rmsnorm_bwd_kernel``.
    Asked of the C side, which queries the current card once and keeps it."""
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    code = build.load().rmsnorm_bwd_grid(n, d, DTYPE_CODES[dtype], vec, ctypes.byref(blocks), ctypes.byref(threads))
    build.check(code, "rmsnorm_bwd grid")
    return blocks.value, threads.value


def rmsnorm_bwd_rows(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x and dy (N, d) contiguous f32/bf16 on the card, scale (d,) f32 -> (dx
    (N, d) in x's dtype, dscale (d,) f32).  Launches the backward kernel and
    its reduction of the blocks' dscale partials, which runs in a fixed order,
    so two runs give the same bits."""
    global bwd_launches
    require_no_grad("rmsnorm_bwd", x, scale, dy)
    require_cuda("rmsnorm_bwd", x, scale, dy)
    require(x.dtype in DTYPE_CODES and dy.dtype == x.dtype, f"rmsnorm_bwd: x and dy of one type, f32 or bf16, got {x.dtype}, {dy.dtype}")
    require(x.dim() == 2 and x.is_contiguous() and dy.shape == x.shape and dy.is_contiguous(),
            f"rmsnorm_bwd: x and dy must be (N, d) contiguous, got {tuple(x.shape)}, {tuple(dy.shape)}")
    n, d = x.shape
    require(n >= 1 and d >= 1, "rmsnorm_bwd: empty input")
    require(scale.dtype == torch.float32 and scale.shape == (d,) and scale.is_contiguous(),
            f"rmsnorm_bwd: scale must be ({d},) f32 contiguous, got {tuple(scale.shape)} {scale.dtype}")
    require(3 * d * 4 <= 227 * 1024, f"rmsnorm_bwd: a row of {d} does not fit in shared memory")
    dx = torch.empty_like(x)
    per16 = 16 // x.element_size()
    vec = int(d % per16 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, dy, dx, scale)))
    blocks, _ = bwd_grid(n, d, x.dtype, vec)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    code = build.load().rmsnorm_bwd_launch(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(), partial.data_ptr(),
        n, d, float(eps), DTYPE_CODES[x.dtype], vec, blocks, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(code, "rmsnorm_bwd")
    bwd_launches += 1
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """y = rmsnorm(x, scale) with a hand-written backward: on the card both
    directions launch kernels (x is flattened into rows), on the CPU both use
    the plain versions.  Saves x and scale; r is recomputed from x."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        if x.device.type == "cpu":
            return rmsnorm_plain(x, scale, eps)
        return rmsnorm_rows(x.reshape(-1, x.shape[-1]), scale, eps).reshape(x.shape)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, scale = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dscale = rmsnorm_bwd_plain(x, scale, dy, ctx.eps)
        else:
            # autograd may hand over an expanded or strided dy; the kernel reads rows
            d = x.shape[-1]
            dx, dscale = rmsnorm_bwd_rows(x.reshape(-1, d), scale, dy.contiguous().reshape(-1, d), ctx.eps)
            dx = dx.reshape(x.shape)
        return dx, dscale.to(scale.dtype), None
