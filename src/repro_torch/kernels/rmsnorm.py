"""RMSNorm: the CUDA kernel's wrapper, its plain version and its launch count.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm_rows`` (body
``_rmsnorm_kernel``).  Bound by bytes on this card: x is read once and written
once, ``2 * N * d * itemsize`` over the memory rate; see ``csrc/rmsnorm.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._check import DTYPE_CODES, require, require_cuda, require_no_grad

launches = 0  # one more for every kernel launch; reset by whoever wants to count a run


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,): f32 inside, output in x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


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
