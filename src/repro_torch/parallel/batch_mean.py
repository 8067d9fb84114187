"""A statistic of the whole batch where a ``data`` axis splits it: the mean
over ``data`` of each shard's mean, for the data-parallel plain step
(``parallel/data_parallel.py``).

The reference jits one step over the whole batch, so a statistic that
``moe_apply`` takes over (B, T) (``me``, the mean router probability, and
``ce``, the fraction routed, of its load-balance aux) is the whole batch's.
The aux is their product, which is not linear in the shards: a shard's own
aux, averaged over ``data``, is not the reference's.  Under ``use`` each rank
averages its shard's statistics over ``data`` before the product (the shards
are equal: every rank takes B / DP rows of T positions).

The gradient.  Rank r's term of the loss is ``aux / DP`` (so that the terms
summed over ``data`` are the aux once), with ``aux = c sum_e me[e] ce[e]``,
``me = (1 / DP) sum_r me_r`` and ``ce`` without gradient.  The reference's
gradient is ``c sum_e ce[e] (1 / DP) sum_r dme_r[e]``.  The loss that the
ranks' terms sum to depends on ``me_r`` through every rank's copy of ``me``:
DP terms, each ``c ce / DP`` per unit of ``me``, each ``me`` moving by
``1 / DP`` per unit of ``me_r``, so ``dL / dme_r = c ce / DP``, which is
exactly what rank r's own term gives per unit of ``me``.  The backward of
``means`` is therefore the identity: each rank keeps only its own shard's share
``c ce / DP * dme_r``, and the gradients summed over ``data`` are the
reference's.  Scaling by the mean's own ``1 / DP`` on the way back as well
would make them DP times too small.

A module-level context, not a thread-local one, as ``tensor_parallel.use``:
autograd runs a CUDA backward, and with it a rematerialised forward (which
averages again, with the same result), on a thread of its own.  With no
context every statistic is the shard's, which is the whole batch's on one
rank, a batch that ``data`` leaves whole, and the pipeline's per-microbatch,
per-shard aux (the reference's manual region).  This module imports none of
the port's modules.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

AXIS = "data"


_CURRENT = None  # the transport over whose data axis the means are taken


@contextlib.contextmanager
def use(transport):
    """Take the batch statistics over ``transport``'s whole ``data`` axis
    (None: each shard's own)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = transport
    try:
        yield
    finally:
        _CURRENT = prev


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, transport):
        return transport.all_reduce(x.clone(memory_format=torch.contiguous_format), AXIS) / transport.mesh.shape[AXIS]

    @staticmethod
    def backward(fctx, g):
        return g, None  # the module docstring: the rank's own share, not g / DP


def means(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The means over ``data`` of ``xs`` (tensors of one shape, each a mean
    over this rank's shard of the batch), in one all-reduce; ``xs``
    themselves with no context."""
    transport = _CURRENT
    if transport is None or transport.mesh.shape[AXIS] == 1:
        return xs
    return tuple(_Mean.apply(torch.stack(xs), transport).unbind(0))
