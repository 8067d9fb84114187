"""RMSNorm: the CUDA kernels' wrappers (forward and backward), their plain
versions, their launch counts and ``RMSNormFn``, the autograd Function that
joins them.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm_rows`` (body
``_rmsnorm_kernel``); the backward is the port's counterpart of what XLA
derives for the reference's jnp ``rmsnorm`` when it trains.  Both are bound by
bytes on this card: the forward reads x and writes y, ``2 * N * d *
itemsize``; the backward reads x and dy and writes dx, ``3 * N * d *
itemsize``; see ``csrc/rmsnorm.cu``.  ``fwd_cost`` and ``bwd_cost`` give
these bytes and operations; on ``meta`` tensors ``rmsnorm_rows_meta`` and
``rmsnorm_bwd_rows_meta`` allocate what the card's wrappers allocate and record
the launch (``cost.py``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, cost
from repro_torch.kernels._check import DTYPE_CODES, require, require_cuda, require_no_grad

launches = 0  # one more for every forward kernel launch; reset by whoever wants to count a run
bwd_launches = 0  # one more for every backward launch (its two kernels count once)
# csrc/rmsnorm.cu's kRegRow and kBwdChunks: the longest row the register
# kernels take, and the 16-byte chunks of x (and of dy) a backward thread holds
REG_ROW = 4096
BWD_CHUNKS = 4
# blocks an SM of the backward's first kernel, by (dtype, threads a block):
# rmsnorm_bwd_kernel (threads 0) runs csrc's kBwdBlocksPerSm; each
# rmsnorm_bwd_reg_kernel<T, NT> as many as the runtime's occupancy gives it on
# an H100 at the registers ptxas gives it (bf16 175, f32 115 and at 256
# threads 122: chip_smoke.py's phase build): a warp's registers come from one
# of an SM's four 16K-register quarters, so bf16 fits 2 warps a quarter and
# f32 4.  ``bwd_grid_at`` sizes the grid from them on ``meta``;
# chip_smoke.py holds it equal to ``bwd_grid``'s on the card.
BWD_BLOCKS_PER_SM = {(torch.bfloat16, 0): 4, (torch.float32, 0): 4,
                     (torch.bfloat16, 32): 8, (torch.bfloat16, 64): 4, (torch.bfloat16, 128): 2,
                     (torch.float32, 32): 16, (torch.float32, 64): 8, (torch.float32, 128): 4, (torch.float32, 256): 2}


def fwd_cost(n: int, d: int, dtype: torch.dtype) -> cost.Cost:
    """x read and y written (N, d), scale read; about four f32 operations an
    element (the square and its sum, the scaling by r and by the scale)."""
    return 2 * n * d * dtype.itemsize + d * 4, 4 * n * d, cost.F32_FLOPS


def bwd_cost(n: int, d: int, dtype: torch.dtype) -> cost.Cost:
    """x and dy read, dx written (N, d); scale read and dscale written; about
    ten f32 operations an element (the sums of x^2 and g x, g, dx, dscale's term)."""
    return 3 * n * d * dtype.itemsize + 2 * d * 4, 10 * n * d, cost.F32_FLOPS


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


def _fwd_call(x: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int, torch.Tensor]:
    """The forward's checks of its shapes and types and its output, which the
    card's wrapper and the meta wrapper share: (n, d, y)."""
    require(x.dtype in DTYPE_CODES, f"rmsnorm: f32 or bf16, got {x.dtype}")
    require(x.dim() == 2 and x.is_contiguous(), f"rmsnorm: x must be (N, d) contiguous, got {tuple(x.shape)} strides {x.stride()}")
    n, d = x.shape
    require(n >= 1 and d >= 1, "rmsnorm: empty input")
    require(scale.dtype == torch.float32 and scale.shape == (d,) and scale.is_contiguous(),
            f"rmsnorm: scale must be ({d},) f32 contiguous, got {tuple(scale.shape)} {scale.dtype}")
    require(d * 4 <= 227 * 1024, f"rmsnorm: a row of {d} does not fit in shared memory")
    return n, d, torch.empty_like(x)


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (N, d) contiguous f32/bf16 on the card, scale (d,) f32 -> (N, d).  Launches the kernel."""
    global launches
    require_no_grad("rmsnorm", x, scale)
    require_cuda("rmsnorm", x, scale)
    n, d, y = _fwd_call(x, scale)
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


def rmsnorm_rows_meta(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm_rows`` on ``meta``: its checks and its output, one launch recorded."""
    require_no_grad("rmsnorm", x, scale)
    n, d, y = _fwd_call(x, scale)
    cost.record("rmsnorm", fwd_cost(n, d, x.dtype))
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


def bwd_threads(d: int, dtype: torch.dtype, vec: int) -> int:
    """csrc's ``bwd_threads``: a block's threads of ``rmsnorm_bwd_reg_kernel``
    for rows of d, or 0 where the rows take ``rmsnorm_bwd_kernel``."""
    if not vec or d > REG_ROW:
        return 0
    nt = 32
    while nt * BWD_CHUNKS * (16 // dtype.itemsize) < d:
        nt *= 2
    return nt


def bwd_grid_at(n: int, d: int, dtype: torch.dtype, vec: int, sms: int) -> Tuple[int, int]:
    """``bwd_grid`` on a card of ``sms`` SMs, by csrc's arithmetic: one wave of
    ``sms * BWD_BLOCKS_PER_SM`` blocks, evened out (each block walks ceil(n /
    wave) rows, the last block fewer)."""
    threads = bwd_threads(d, dtype, vec)
    wave = sms * BWD_BLOCKS_PER_SM[(dtype, threads)]
    per = -(-n // wave)
    return -(-n // per), threads


def _bwd_call(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, grid) -> Tuple:
    """The backward's checks of its shapes and types, its outputs and its
    scratch, which the card's wrapper and the meta wrapper share; ``grid`` is
    ``bwd_grid`` or its arithmetic (``bwd_grid_at``).  Returns (n, d, vec,
    blocks, dx, dscale, partial): ``partial`` holds the blocks' dscale rows."""
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
    blocks, _ = grid(n, d, x.dtype, vec)
    dscale = torch.empty((d,), dtype=torch.float32, device=x.device)
    partial = torch.empty((blocks, d), dtype=torch.float32, device=x.device)
    return n, d, vec, blocks, dx, dscale, partial


def rmsnorm_bwd_rows(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x and dy (N, d) contiguous f32/bf16 on the card, scale (d,) f32 -> (dx
    (N, d) in x's dtype, dscale (d,) f32).  Launches the backward kernel and
    its reduction of the blocks' dscale partials, which runs in a fixed order,
    so two runs give the same bits."""
    global bwd_launches
    require_no_grad("rmsnorm_bwd", x, scale, dy)
    require_cuda("rmsnorm_bwd", x, scale, dy)
    n, d, vec, blocks, dx, dscale, partial = _bwd_call(x, scale, dy, bwd_grid)
    code = build.load().rmsnorm_bwd_launch(
        x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(), partial.data_ptr(),
        n, d, float(eps), DTYPE_CODES[x.dtype], vec, blocks, torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(code, "rmsnorm_bwd")
    bwd_launches += 1
    return dx, dscale


def rmsnorm_bwd_rows_meta(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rmsnorm_bwd_rows`` on ``meta``: its checks, outputs and scratch (the
    dscale partials of ``bwd_grid_at`` at ``cost.SM_COUNT`` SMs), one launch
    recorded."""
    require_no_grad("rmsnorm_bwd", x, scale, dy)
    n, d, _, _, dx, dscale, partial = _bwd_call(
        x, scale, dy, lambda *shape: bwd_grid_at(*shape, cost.SM_COUNT))
    cost.record("rmsnorm_bwd", bwd_cost(n, d, x.dtype))
    del partial
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """y = rmsnorm(x, scale) with a hand-written backward: on the card both
    directions launch kernels (x is flattened into rows), on the CPU both use
    the plain versions, on ``meta`` both take the card's path to its meta
    wrappers.  Saves x and scale; r is recomputed from x."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        if x.device.type == "cpu":
            return rmsnorm_plain(x, scale, eps)
        rows = rmsnorm_rows_meta if cost.on_meta(x) else rmsnorm_rows
        return rows(x.reshape(-1, x.shape[-1]), scale, eps).reshape(x.shape)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, scale = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dscale = rmsnorm_bwd_plain(x, scale, dy, ctx.eps)
        else:
            # autograd may hand over an expanded or strided dy; the kernel reads rows
            d = x.shape[-1]
            rows = rmsnorm_bwd_rows_meta if cost.on_meta(x) else rmsnorm_bwd_rows
            dx, dscale = rows(x.reshape(-1, d), scale, dy.contiguous().reshape(-1, d), ctx.eps)
            dx = dx.reshape(x.shape)
        return dx, dscale.to(scale.dtype), None
