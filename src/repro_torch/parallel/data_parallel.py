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
copy 1 / DP.  The MoE load-balance aux, where the model has one, is each
shard's, averaged over ``data``: the reference computes it once over the
whole batch's routing, a product of two batch means, which a shard's does not
equal (ROADMAP.md, "Places where a straightforward port will diverge").

Gradients: autograd of the rank's term, then summed over ``data`` through the
counted transport, leaf by leaf in place (no second copy of the gradients on
the device), and the loss with them.  Every rank of a ``data`` group then
holds the same bits and applies the same clip and AdamW update
(``make_train_step`` treats this loss as it treats ``PipelineLoss``), so the
replicas stay bit-equal.  ``model`` ranks are replicas that compute the same
numbers, as under ``--pipeline``: no tensor parallelism (ROADMAP 7b).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.convert import flatten
from repro_torch.models.modules import Params
from repro_torch.models.transformer import _loss_targets
from repro_torch.optim.optimizer import global_norm, gradients
from repro_torch.parallel.sharding import make_batch_shardings
from repro_torch.parallel.transport import Transport


def shard_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's ``data`` shard of every leaf of a global batch, by the
    reference's batch plan; a leaf the plan does not split is the whole leaf."""
    specs = make_batch_shardings(batch, mesh)
    n, i = mesh.shape.get("data", 1), mesh.coords.get("data", 0)
    out = {}
    for k, v in batch.items():
        dims = [d for d, entry in enumerate(specs[k]) if entry == "data"]
        if not dims:
            out[k] = v
            continue
        rows = v.shape[dims[0]] // n
        out[k] = v.narrow(dims[0], i * rows, rows)
    return out


class DataParallelLoss:
    """``loss(params, batch) -> (loss, grads)`` of this rank over the mesh's
    ``data`` axis: ``params`` the whole model (every rank holds it), ``batch``
    the global batch, ``loss`` the f32 scalar every rank returns alike and
    ``grads`` a flat dict in ``flatten(params)``'s order, summed over ``data``
    as the module docstring says.  ``model_loss`` is ``Model.loss`` (or any
    loss returning (loss, {"ce", optional "aux"})).  ``transport`` is a
    ``Transport`` over ``mesh`` by default; the dry-run gives a
    ``MetaTransport``."""

    def __init__(self, model_loss: Callable[[Params, Dict], Tuple[torch.Tensor, Dict[str, Any]]], mesh,
                 transport: Optional[Transport] = None):
        self.model_loss, self.mesh = model_loss, mesh
        self.DP = mesh.shape.get("data", 1)
        self.transport = Transport(mesh) if transport is None else transport

    def __call__(self, params: Params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        local = shard_batch(batch, self.mesh)
        targets, mask = _loss_targets(local)
        n = mask.float().sum() if mask is not None else torch.full((), targets.numel(), dtype=torch.float32,
                                                                    device=targets.device)
        total_n = self.transport.all_reduce(n.clone(), "data")
        flat = flatten(params)
        leaves = list(flat.values())
        for t in leaves:
            t.requires_grad_(True)
        _, metrics = self.model_loss(params, local)
        term = metrics["ce"] * (n / torch.clamp(total_n, min=1.0))
        if metrics.get("aux") is not None:
            term = term + metrics["aux"] / self.DP
        grads = dict(zip(flat.keys(), gradients(term, leaves)))
        for g in grads.values():
            self.transport.all_reduce(g, "data")
        return self.transport.all_reduce(term.detach().float(), "data"), grads

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the summed gradient (every rank holds all of it)."""
        return global_norm(grads)
