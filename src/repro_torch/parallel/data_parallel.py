"""Data parallelism on the plain (non-pipelined) step: the reference's launcher
on its host mesh (data, model) without ``--pipeline``, over ranks of
``torch.distributed``.

The reference jits one SPMD step over the whole batch, sharded on ``data``
(``repro/parallel/sharding.py::make_batch_shardings``: dim 0 over ``data``, a
VLM's (3, B, T) positions on dim 1, ``P()`` where the axis does not divide the
batch).  Here each rank takes its ``data`` shard of the global batch by the
same plan (``make_batch_shardings`` of ``parallel/sharding.py``; a leaf the
plan leaves whole is replicated) and computes the model's loss on it.

Loss: the global masked mean, as the reference's step computes it over the
whole batch, not a mean of the shards' means.  A rank counts its shard's
mask (``n``, the positions its cross entropy averages over), the counts are
summed over ``data`` (``N``), and the rank's term is its cross entropy times
``n / N``: its masked sum over the global count, so that the terms sum to the
whole batch's masked mean.  A batch the plan leaves whole weighs each rank's
copy 1 / DP.  The MoE load-balance aux, where the model has one, is the
whole batch's, as the reference computes it once over the whole batch's
routing: a product of two batch means, which a shard's does not equal.  While
``data`` splits the batch the loss runs under ``batch_mean.use``, so that
``moe_apply`` averages the two means over ``data`` before their product; each
rank's term weighs that aux 1 / DP, so that the terms sum to it once, and
``batch_mean``'s docstring gives the arithmetic by which the router's
gradients, summed over ``data``, are the reference's.  A batch the plan leaves
whole has the whole batch's aux on every rank already, and each copy weighs
1 / DP.

Gradients: autograd of the rank's term, then summed over ``data`` through the
counted transport, leaf by leaf in place (no second copy of the gradients on
the device), and the loss with them.  Every rank of a ``data`` group then
holds the same bits and applies the same clip and AdamW update
(``make_train_step`` treats this loss as it treats ``PipelineLoss``), so the
replicas stay bit-equal.

Tensor parallelism over ``model`` (``parallel/tensor_parallel.py``): given
the placement ``plan`` of the whole model (``tensor_parallel.model_plan``:
every family, on a ``model`` axis of more than 1), ``params`` are this rank's
shards (``shard_params``) and the loss runs inside the ``model`` context, so
that each product computes on the rank's shard as the plan places it (a MoE's
experts on their expert dim, or on their features where the expert count does
not divide ``model``; attention, MLA, RWKV-6 and the pure Mamba2 stack by
heads, or on all heads where the plan cuts inside one; the hybrid's Mamba2
``w_z`` and ``w_x`` on d and ``conv_x`` on its taps).  Each gradient is then
this rank's block, summed over ``data`` only; a leaf the plan leaves whole
(the norm scales, MLA's latent down-projection, the router, RWKV-6's
``mu_*`` and ``w_lora_a``, the pure stack's ``w_bc``, ``w_dt``, ``conv_bc``
and per-head leaves, the rest of the hybrid's Mamba2 layer) has its whole
gradient on every ``model`` rank, the same bits on each.  ``grad_norm`` sums
the squares of the split leaves over ``model`` and adds those of the whole
leaves once: the clip sees the whole model's norm.  Without a plan the
``model`` ranks are replicas that compute the same numbers.

FSDP over ``data`` (``parallel/fsdp.py``): given the plan with fsdp on
(``model_plan(cfg, mesh, fsdp=True)``, the reference's dry-run's placement of
its train shapes), ``params`` are this rank's ``data`` blocks of its ``model``
shards of the leaves the plan splits over ``data`` as well, and the loss runs
inside the ``data`` context too: each layer gathers its blocks over ``data``
where it runs, inside remat, and their gradients are reduce-scattered over
``data`` in the backward, so that the rank ends with its block of the
gradient summed over ``data``; a stacked leaf that the plan splits on its
layer axis is gathered once, before the layer loop (``fsdp.gather_stack``).  Those leaves are not all-reduced again; the
leaves the plan leaves whole over ``data`` (the norm scales, and the leaves
whose rule names no axis: the router, MLA's ``w_dkv``, RWKV-6's ``w_lora_a``,
the hybrid's ``w_bc`` and ``w_dt``) keep the all-reduce.  ``grad_norm`` sums
each leaf's squares over every axis that splits it (``data``, ``model`` or
both) and adds a whole leaf's once.  AdamW updates the rank's blocks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.convert import flatten
from repro_torch.models.modules import Params
from repro_torch.models.transformer import _loss_targets
from repro_torch.optim.optimizer import global_norm, gradients
from repro_torch.parallel import batch_mean, fsdp
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import make_batch_shardings
from repro_torch.parallel.transport import Transport


def shard_batch(batch: Dict[str, torch.Tensor], mesh) -> Tuple[Dict[str, torch.Tensor], bool]:
    """This rank's ``data`` shard of every leaf of a global batch, by the
    reference's batch plan (a leaf the plan does not split is the whole
    leaf), and whether a ``data`` axis of more than 1 split any leaf."""
    specs = make_batch_shardings(batch, mesh)
    n, i = mesh.shape.get("data", 1), mesh.coords.get("data", 0)
    out, split = {}, False
    for k, v in batch.items():
        dims = [d for d, entry in enumerate(specs[k]) if entry == "data"]
        if not dims:
            out[k] = v
            continue
        rows = v.shape[dims[0]] // n
        out[k] = v.narrow(dims[0], i * rows, rows)
        split = split or n > 1
    return out, split


class DataParallelLoss:
    """``loss(params, batch) -> (loss, grads)`` of this rank over the mesh's
    ``data`` axis: ``params`` the whole model (every rank holds it), or this
    rank's shards of it under ``plan``, ``batch`` the global batch, ``loss``
    the f32 scalar every rank returns alike and ``grads`` a flat dict in
    ``flatten(params)``'s order, summed over ``data`` as the module docstring
    says.  ``model_loss`` is ``Model.loss`` (or any loss returning (loss,
    {"ce", optional "aux"})).  ``transport`` is a ``Transport`` over ``mesh``
    by default; the dry-run gives a ``MetaTransport``.  ``plan`` (a nested
    dict of ``P``s, ``tensor_parallel.model_plan``) turns tensor parallelism
    over ``model`` on where it splits leaves over ``model``, and FSDP over
    ``data`` where it splits leaves over ``data``."""

    def __init__(self, model_loss: Callable[[Params, Dict], Tuple[torch.Tensor, Dict[str, Any]]], mesh,
                 transport: Optional[Transport] = None, plan: Optional[Dict] = None):
        self.model_loss, self.mesh = model_loss, mesh
        self.DP = mesh.shape.get("data", 1)
        self.transport = Transport(mesh) if transport is None else transport
        tp_on = plan is not None and mesh.shape.get(tp.AXIS, 1) > 1  # FSDP's plan on (data, 1) names model too
        self.tp = tp.TPContext(mesh, self.transport, plan) if tp_on else None
        self.fsdp = fsdp.FSDPContext(mesh, self.transport, plan) if plan is not None else None
        self.split = tp.split_paths(plan) if tp_on else set()
        self.scattered = tp.split_paths(plan, fsdp.AXIS) if self.DP > 1 else set()

    def __call__(self, params: Params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        local, split = shard_batch(batch, self.mesh)
        targets, mask = _loss_targets(local)
        n = mask.float().sum() if mask is not None else torch.full((), targets.numel(), dtype=torch.float32,
                                                                    device=targets.device)
        total_n = self.transport.all_reduce(n.clone(), "data")
        flat = flatten(params)
        leaves = list(flat.values())
        for t in leaves:
            t.requires_grad_(True)
        with tp.use(self.tp), fsdp.use(self.fsdp), batch_mean.use(self.transport if split else None):
            _, metrics = self.model_loss(params, local)
            term = metrics["ce"] * (n / torch.clamp(total_n, min=1.0))
            if metrics.get("aux") is not None:
                term = term + metrics["aux"] / self.DP
            grads = dict(zip(flat.keys(), gradients(term, leaves)))
        for p, g in grads.items():
            if p not in self.scattered:  # a data-split leaf's block was reduce-scattered in the backward
                self.transport.all_reduce(g, "data")
        return self.transport.all_reduce(term.detach().float(), "data"), grads

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the summed gradient: every rank holds all of it,
        or under tensor parallelism and FSDP the squares of its blocks of a
        split leaf are summed over each axis that splits it (``model``,
        ``data`` or both) and those of the whole leaves added once."""
        if not self.split and not self.scattered:
            return global_norm(grads)

        def squares(model: bool, data: bool):  # a tensor, or 0 where no leaf is split so
            return sum(g.float().square().sum() for p, g in grads.items()
                       if (p in self.split) == model and (p in self.scattered) == data)

        if not self.scattered:
            return torch.sqrt(self.transport.all_reduce(squares(True, False), "model") + squares(False, False))
        device = next(iter(grads.values())).device
        by_data = self.transport.all_reduce(torch.stack([torch.as_tensor(squares(m, True), dtype=torch.float32,
                                                                         device=device) for m in (True, False)]),
                                            "data")
        return torch.sqrt(self.transport.all_reduce(by_data[0] + squares(True, False), "model")
                          + by_data[1] + squares(False, False))
