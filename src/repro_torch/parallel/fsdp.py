"""FSDP over the mesh's ``data`` axis on the plain step: the reference's
placement plan with fsdp on (``repro/parallel/sharding.py::_add_fsdp_axis``
through ``make_param_shardings(fsdp=True)``, as its dry-run places the train
shapes' parameters and moments), executed.

The plan puts ``data`` on the largest dim of a leaf of 4 MiB or more that no
other axis splits and that ``data`` divides, so a rank holds its ``data``
block of its ``model`` shard of such a leaf, and AdamW's moments alike.  Its
docstring: "weights are all-gathered on use; params + Adam state memory drops
by the data-axis size".  Here that is one autograd function, ``_Gather``: the
all-gather of a block over ``data`` forward, and the reduce-scatter (sum) of
the whole leaf's gradient backward, so that each rank keeps its block of the
gradient summed over ``data`` and nothing else (``DataParallelLoss`` then
all-reduces only the leaves the plan leaves whole over ``data``).

The models gather a layer's leaves (``gather_layer``) inside the function
that their remat wraps, so that a checkpointed block keeps only the blocks
as its inputs and gathers again when it is recomputed; the embedding and the
head gather theirs where they are read (``gather_leaf``).  A stacked leaf
that the plan splits on its layer (or group) axis (7f-iii: RWKV-6's ``w0``
and the pure Mamba2 stack's ``norm_scale``, whose one feature dim ``model``
takes) has no block in a layer's view: a rank holds some layers of it whole
and none of the others.  Such a leaf is gathered whole once a step, before
the stack is taken apart into layers and outside remat (``gather_stack``,
the same ``_Gather`` on dim 0), and its gradient, summed over the layers,
is reduce-scattered back onto the rank's layers once.  These leaves are
vectors a layer (``w0`` is 32 KiB a layer at RWKV-6 7B's width), so the
gathered stack costs little to keep through the backward.  The context is a
module global (``use``), as ``tensor_parallel``'s is, not a thread-local:
autograd runs a CUDA backward, and with it the recomputation, on a thread of
its own.  With no context, or a ``data`` axis of 1, everything is the
identity and returns its input itself.

The model modules import this one, so it imports none of the port's modules
at its top.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

AXIS = "data"


def data_dims(plan) -> Dict[str, int]:
    """path (``flatten``'s) -> the dim of the whole leaf that ``plan`` splits
    over ``data``, for the leaves it splits so (``_add_fsdp_axis`` puts
    ``data`` on one dim of its own); none without a plan."""
    from repro_torch.convert import flatten

    return {} if plan is None else {p: tuple(spec).index(AXIS) for p, spec in flatten(plan).items() if AXIS in spec}


class FSDPContext:
    """This rank's ``data`` axis of ``mesh`` (``size``), the transport the
    gathers go over, and each data-split leaf's dim and rank (``dims``,
    ``ndim``: the whole leaf's, to find the dim in a leaf that has lost its
    stacked axes)."""

    def __init__(self, mesh, transport, plan):
        from repro_torch.convert import flatten

        self.size = mesh.shape.get(AXIS, 1)
        self.transport = transport
        self.dims = data_dims(plan)
        self.ndim = {p: len(spec) for p, spec in flatten(plan).items()}


_CURRENT: Optional[FSDPContext] = None


@contextlib.contextmanager
def use(ctx: Optional[FSDPContext]):
    """Run the model's functions gathering as ``ctx`` says (None: no gathers)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield
    finally:
        _CURRENT = prev


def _active() -> Optional[FSDPContext]:
    return _CURRENT if _CURRENT is not None and _CURRENT.size > 1 and _CURRENT.dims else None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.ctx, fctx.dim = ctx, dim
        return ctx.transport.all_gather(x.contiguous(), AXIS, dim)

    @staticmethod
    def backward(fctx, g):
        return fctx.ctx.transport.reduce_scatter(g.contiguous(), AXIS, fctx.dim), None, None


def _gather(ctx: FSDPContext, path: str, t: torch.Tensor) -> torch.Tensor:
    dim = ctx.dims.get(path)
    if dim is None:
        return t
    dim -= ctx.ndim[path] - t.dim()  # the stacked axes the leaf has lost (_unstack)
    if dim < 0:  # split on a stacked axis this view has lost: gather_stack gathered it whole before the loop
        return t
    return _Gather.apply(t, dim, ctx)


def gather_leaf(t: torch.Tensor, path: str) -> torch.Tensor:
    """The leaf at ``path`` whole over ``data``: ``t``, this rank's block,
    gathered where the plan splits it so (its gradient reduce-scattered)."""
    ctx = _active()
    return t if ctx is None else _gather(ctx, path, t)


def gather_layer(tree, prefix: str):
    """A layer's tree (``_unstack``'s view of a stacked tree under
    ``prefix``, or a tree with no stacked axis) with each leaf that the plan
    splits over ``data`` gathered whole; the same tree without a context."""
    ctx = _active()
    if ctx is None:
        return tree

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        return _gather(ctx, path, t)

    return walk(tree, prefix)


def gather_stack(tree, prefix: str):
    """A stacked tree (the leaves under ``prefix``, each with its stacked
    axes) with each leaf that the plan splits over ``data`` on its first
    stacked axis gathered whole, its gradient reduce-scattered back onto this
    rank's rows; the same tree without a context.  Called once a step, before
    the stack is taken apart into layers (``_unstack``), outside remat."""
    ctx = _active()
    if ctx is None:
        return tree

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        return _Gather.apply(t, 0, ctx) if ctx.dims.get(path) == 0 else t

    return walk(tree, prefix)
