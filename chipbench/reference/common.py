"""What the plain references share: float32 with TF32 off, the products with
an optional lower precision in place (the controls), RMSNorm, rotary
embeddings, the next-token cross entropy in chunks, and AdamW as
``OptimizerConfig``'s fields define it (a warm-up to ``peak_lr``, a cosine to
``min_lr_ratio`` of it, the clip by the global norm, the bias corrections at
step + 1, the decay on matrices).  Plain PyTorch; nothing of the program."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def exact() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8_round(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """x through float8 e4m3 and back, scaled so that its largest magnitude
    (per row along ``dim``, or the whole tensor) lands on 448."""
    with torch.no_grad():
        amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
        scale = torch.clamp(amax, min=1e-30) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()  # forward in fp8, gradient straight through


class Precision:
    """How a reference's products run: ``"f32"`` exactly, or ``"fp8"``, the
    control for a configuration that computes in bfloat16: both operands
    rounded to float8 e4m3 (activations per row, weights per tensor) and the
    product accumulated in float32."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.name == "fp8":
            x, w = _fp8_round(x, -1), _fp8_round(w, None)
        return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, D) rotated in the rotate-half form: pair (i, i + D/2) by
    the angle position * theta^(-i / (D/2))."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None, None] * freqs  # (B, T, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def next_token_nll_sum(x: torch.Tensor, w_head: torch.Tensor, tokens: torch.Tensor, prec: Precision,
                       chunk: int = 512) -> torch.Tensor:
    """The summed negative log-likelihood of each next token (the last
    position has none) of x (B, T, d) under the head (d, V), in position
    chunks."""
    T = x.shape[1]
    total = x.new_zeros(())
    for c0 in range(0, T - 1, chunk):
        c1 = min(c0 + chunk, T - 1)
        logits = prec.mm(x[:, c0:c1], w_head)
        gold = logits.gather(-1, tokens[:, c0 + 1:c1 + 1].long()[..., None])[..., 0]
        total = total + (torch.logsumexp(logits, -1) - gold).sum()
    return total


def lr_at(opt: Dict[str, float], step: int) -> float:
    peak, warm, total = opt["peak_lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    """AdamW over a list of f32 leaves, updated in place."""

    def __init__(self, opt: Dict[str, float], leaves: List[torch.Tensor]):
        self.opt, self.step = opt, 0
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def update(self, leaves: List[torch.Tensor], grads: List[torch.Tensor]) -> Tuple[float, List[float]]:
        """One update.  Returns the global norm of the gradients and the norm
        of each leaf's gradient as the moments took it (clipped)."""
        o = self.opt
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
        scale = torch.clamp(o["clip_norm"] / (norm + 1e-9), max=1.0)
        self.step += 1
        lr = lr_at(o, self.step)
        b1c, b2c = 1 - o["b1"] ** self.step, 1 - o["b2"] ** self.step
        seen = []
        for p, g, mu, nu in zip(leaves, grads, self.mu, self.nu):
            g = g * scale
            seen.append(float(g.double().norm()))
            mu.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            nu.mul_(o["b2"]).add_((1 - o["b2"]) * g.square())
            upd = (mu / b1c) / ((nu / b2c).sqrt() + o["eps"])
            if p.dim() >= 2:
                upd = upd + o["weight_decay"] * p
            p.sub_(lr * upd)
        return float(norm), seen


def checkpointed(fn: Callable, *args):
    """``fn(*args)`` with its activations recomputed in the backward."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
