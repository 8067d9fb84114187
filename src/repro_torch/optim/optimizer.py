"""AdamW + warm-up-cosine schedule + global-norm clip + gradient accumulation,
with the arithmetic of ``repro/optim/optimizer.py`` (not ``torch.optim.AdamW``,
which differs from it in three ways: it clips with ``+ 1e-6``, it evaluates the
schedule and the bias corrections at ``step``, not ``step + 1``, and its
decoupled decay multiplies the parameter first and reaches every leaf).

Parameters are the model's nested dicts of tensors; the optimizer walks their
leaves in the order of ``convert.flatten``.  Moments are f32.  The updates
happen in place under ``torch.no_grad()``, so a step allocates no second copy
of the parameters (the reference returns new arrays instead).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.convert import flatten, tree_map

Params = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # () int32, the updates made so far
    mu: Params
    nu: Params


def _leaves(tree: Params) -> List[torch.Tensor]:
    return list(flatten(tree).values())


def init_opt_state(params: Params) -> OptState:
    any_leaf = _leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return OptState(torch.zeros((), dtype=torch.int32, device=any_leaf.device), tree_map(zeros, params), tree_map(zeros, params))


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (f32, on step's device): linear warm-up to
    ``peak_lr``, then a cosine to ``min_lr_ratio * peak_lr`` at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in _leaves(tree)))


def _decay_mask(path: str, leaf: torch.Tensor) -> bool:
    """Weight decay on matrices only (no norms, biases or scalars)."""
    return leaf.dim() >= 2


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, grads: Params, params: Params, state: OptState,
                 norm: Callable[[Params], torch.Tensor] = global_norm
                 ) -> Tuple[Params, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``params`` and the moments are updated in place and
    returned; ``grads`` (same structure) may be overwritten.  ``norm`` gives
    the norm the clip sees: the pipeline's is that of the whole model's
    gradient over every stage."""
    gnorm = norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    flat_p = flatten(params)
    for (path, p), g, mu, nu in zip(flat_p.items(), _leaves(grads), _leaves(state.mu), _leaves(state.nu)):
        g32 = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g32.square_())
        upd = (mu / b1c).div_((nu / b2c).sqrt_().add_(cfg.eps))
        if _decay_mask(path, p):
            upd.add_(cfg.weight_decay * p.float())
        p.copy_(p.float() - lr * upd)
        del g32, upd
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}


def gradients(loss: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """d loss / d leaf for each leaf.  A leaf the loss does not read (``embed``
    under a batch of ``embeds``) gets a zero gradient, as ``jax.grad`` gives
    it: its moments stay 0 and only the weight decay moves it."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def accumulated_value_and_grad(loss_fn: Callable[[Params, Dict], Any], params: Params,
                               batch: Dict[str, torch.Tensor], *, loss_has_metrics: bool = True,
                               accum_steps: int = 1) -> Tuple[torch.Tensor, Dict, Dict[str, torch.Tensor]]:
    """(loss, metrics, grads) of ``loss_fn`` at ``params`` (their leaves are
    made to require grad): grads a flat dict in ``flatten(params)``'s order.
    accum_steps > 1 splits the batch on dim 0 into ``accum_steps`` chunks in
    order and sums each chunk's gradients, divided by ``accum_steps``, into f32
    sums (the loss likewise; metrics then empty)."""
    flat = flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    leaves = list(flat.values())

    def value_and_grad(b):
        out = loss_fn(params, b)
        loss, metrics = out if loss_has_metrics else (out, {})
        return loss.detach(), metrics, gradients(loss, leaves)

    if accum_steps == 1:
        loss, metrics, grads = value_and_grad(batch)
        metrics = {k: v.detach() for k, v in metrics.items()}
    else:
        micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + tuple(v.shape[1:])) for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(accum_steps):
            l, _, g = value_and_grad({k: v[i] for k, v in micro.items()})
            for a, gi in zip(acc, g):
                a.add_(gi.float() / accum_steps)
            loss = loss + l / accum_steps
            del g
        grads, metrics = acc, {}
    return loss, metrics, dict(zip(flat.keys(), grads))


def make_train_step(loss_fn: Callable[[Params, Dict], Any], opt_cfg: OptimizerConfig, *,
                    loss_has_metrics: bool = True, accum_steps: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` are updated in place (their leaves are made to require grad).
    accum_steps > 1 splits the batch on dim 0 and sums each microbatch's
    gradients, divided by ``accum_steps``, into f32 sums.

    A ``PipelineLoss`` (``repro_torch/parallel/pipeline.py``) or a
    ``DataParallelLoss`` (``parallel/data_parallel.py``) gives this rank's
    loss and its gradients, already summed over the ranks, in place of
    autograd of a scalar loss; the clip then sees its ``grad_norm``, the norm
    of the whole model's gradient, and each rank updates the leaves it holds."""
    pipelined = hasattr(loss_fn, "grad_norm")

    def train_step(params: Params, opt_state: OptState, batch: Dict[str, torch.Tensor]):
        if pipelined:
            loss, grads = loss_fn(params, batch)
            params, opt_state, om = adamw_update(opt_cfg, grads, params, opt_state, norm=loss_fn.grad_norm)
            return params, opt_state, {**om, "loss": loss}
        loss, metrics, grads = accumulated_value_and_grad(loss_fn, params, batch, loss_has_metrics=loss_has_metrics,
                                                          accum_steps=accum_steps)
        params, opt_state, om = adamw_update(opt_cfg, grads, params, opt_state)
        return params, opt_state, {**metrics, **om, "loss": loss}

    return train_step
