"""Tensor parallelism over the mesh's ``model`` axis, on the plain step
(``parallel/data_parallel.py``) and inside each stage of the pipeline
(``parallel/pipeline.py``): the products that the reference's GSPMD splits by
the placement plan
(``repro/parallel/sharding.py``'s ``PARAM_RULES`` through
``make_param_shardings``, fsdp off, as ``repro/launch/train.py`` places the
parameters), written out as the model group's four operations.

  * ``copy_in``:    identity forward, all-reduce (sum) of the gradient backward;
  * ``reduce_out``: all-reduce forward, identity backward;
  * ``gather``:     all-gather forward, this rank's slice of the gradient backward;
  * ``slice_``:     this rank's slice forward, all-gather of the gradient backward.

Every one goes over the counted ``Transport`` (``parallel/transport.py``),
whose only reduction is the sum.  The model functions ask ``split_dim(name)``
which dim of a leaf's (per-layer) matrix the plan splits over ``model``, and
apply the rule the plan implies: a product whose weight is split on its output
dim yields this rank's columns (its input goes through ``copy_in``); one whose
weight is split on its contracting dim takes this rank's columns of its input
and reduces its output; a consumer that needs columns whole gathers them.

The operations read a module-level context (``use``), not a thread-local one:
autograd runs a CUDA backward, and with it the rematerialised forward, on a
thread of its own.  With no context, or a ``model`` axis of 1, every operation
is the identity and returns its input itself, and ``split_dim`` is None, so the
single-process step, and a step or pipeline given no plan, compute exactly what
they computed before.
The model modules import this one, so it imports none of the port's modules at
its top.

Every config the port builds splits (``tp_family``), on the plain step and
under ``--pipeline`` alike: the transformers (GQA, MQA or MLA attention, a
dense or a MoE FFN), RWKV-6, the pure Mamba2 stack and the Zamba2 hybrid; no
family keeps whole replicas on its ``model`` ranks.  The MoE leaves split as
``MOE_RULES`` place them: the routed experts on their expert dim (expert
parallelism), or on their feature dim where the expert count does not divide
``model``, and the shared expert's stacked leaves on the first dim of each
matrix.  ``split_dims`` therefore keys a leaf under ``moe`` by its path from
``moe`` (``moe/w_gate``, ``moe/shared/w_gate``) and every other leaf by its
name.  Attention, MLA, RWKV-6's time mix and the pure stack's Mamba2 layers
split by heads where the heads divide ``model``; where the plan cuts columns
inside a head (the columns divide, the heads do not: the reference's
``_fit_spec`` drops an axis only where it does not divide the dim), the
split outputs are gathered and every rank runs all the heads, the re-layout
GSPMD makes there.  RWKV-6's channel mix splits on d_ff and d.  The hybrid
splits as the plan places it, which is not by heads: the plan adds one
leading ``None`` to a stacked leaf's rule, and the hybrid's Mamba2 leaves
carry two stacked axes (G, M), so each rule lands one dim to the left
(ROADMAP Queue 3 (p), mirrored here): ``w_z`` and ``w_x`` split on d, their
contracting dim, ``conv_x`` on its taps where ``model`` divides them, and the
rest of the layer stays whole.  ``split_dims`` strips the stacked axes a leaf
really has (``lead_axes``).  Where ``model`` divides M, the plan puts the
``model`` entry of ``w_out`` and ``norm_scale`` on M, a stacked axis
(``stacked_dims``): every rank computes every Mamba2 layer of a group (the
input of ``w_out`` is whole, ``w_z`` and ``w_x`` being reduced), so each
group gathers its M slices of those leaves inside its remat
(``gather_stacked``: ``gather``, whose backward keeps this rank's slice of a
gradient that is whole on every rank).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

AXIS = "model"
STACKED = ("layers", "groups")


def tp_family(cfg) -> bool:
    """Whether ``cfg`` splits over ``model``: a transformer (GQA, MQA or MLA
    attention, a dense or a MoE FFN), RWKV-6, the pure Mamba2 stack or the
    Zamba2 hybrid, which is every config the port builds."""
    if cfg.rwkv is not None or cfg.ssm is not None:
        return cfg.family in ("ssm", "hybrid")
    return cfg.family in ("dense", "vlm", "audio", "moe")


def model_plan(cfg, mesh, *, fsdp: bool = False, min_bytes: Optional[int] = None) -> Optional[Dict]:
    """The placement plan of ``cfg``'s parameters on ``mesh`` (a nested dict of
    ``P``s) where the plain step and the pipeline's stages split them: fsdp
    off, a ``tp_family`` config on a ``model`` axis of more than 1, None
    otherwise; with ``fsdp`` (the plain step's FSDP over ``data``,
    ``parallel/fsdp.py``), the plan with ``data`` added on any mesh
    (``make_param_shardings(fsdp=True, min_bytes=)``, the reference's 4 MiB
    threshold unless given).  The plan may split a stacked axis: ``model`` on
    a hybrid's M (``stacked_dims``), ``data`` on a layer or group axis
    (``fsdp.gather_stack``)."""
    from repro_torch.convert import expected_shapes, unflatten
    from repro_torch.parallel.sharding import FSDP_MIN_BYTES, make_param_shardings

    if not fsdp and (mesh.shape.get(AXIS, 1) == 1 or not tp_family(cfg)):
        return None
    return make_param_shardings(unflatten(expected_shapes(cfg)), mesh, fsdp=fsdp,
                                min_bytes=FSDP_MIN_BYTES if min_bytes is None else min_bytes)


def is_split(spec, axis: str = AXIS) -> bool:
    """Whether a leaf's ``P`` splits a dim over ``axis``."""
    return any(e == axis or (isinstance(e, tuple) and axis in e) for e in spec)


def split_paths(plan, axis: str = AXIS) -> set:
    """The paths (``flatten``'s) of the leaves that ``plan`` splits over
    ``axis``; none without a plan."""
    from repro_torch.convert import flatten

    return {p for p, spec in flatten(plan).items() if is_split(spec, axis)} if plan is not None else set()


def leaf_key(path: str) -> str:
    """The key ``split_dim`` answers for the leaf at ``path``: a leaf under
    ``moe`` by its path from ``moe`` (the routed ``moe/w_gate`` and the shared
    ``moe/shared/w_gate`` split on different dims), every other by its name."""
    names = path.split("/")
    return "/".join(names[names.index("moe"):]) if "moe" in names[:-1] else names[-1]


def lead_axes(path: str) -> int:
    """The stacked axes ahead of the per-layer tensor of the leaf at
    ``path``: (G, M) for the hybrid's Mamba2 layers (under ``groups/mamba``),
    (L,) or (G,) for any other leaf under ``layers`` or ``groups``, none
    outside them."""
    names = path.split("/")[:-1]
    top = next((i for i, n in enumerate(names) if n in STACKED), None)
    if top is None:
        return 0
    return 2 if names[top] == "groups" and names[top + 1:top + 2] == ["mamba"] else 1


def _dims(plan, axis: str) -> Dict[str, Tuple[bool, Optional[int]]]:
    """leaf key -> (whether the split is on a stacked axis, its dim: of the
    per-layer tensor, or among the leaf's stacked axes; None where whole).
    Raises where two leaves of one key are split on different dims."""
    from repro_torch.convert import flatten

    dims: Dict[str, Tuple[bool, Optional[int]]] = {}
    for path, spec in flatten(plan).items():
        key, lead = leaf_key(path), lead_axes(path)
        dim = next((i for i, e in enumerate(spec) if is_split((e,), axis)), None)
        got = (False, None) if dim is None else (dim < lead, dim if dim < lead else dim - lead)
        if dims.setdefault(key, got) != got:
            raise ValueError(f"{key}: split as {dims[key]} and as {got} (stacked, dim)")
    return dims


def split_dims(plan, axis: str = AXIS) -> Dict[str, Optional[int]]:
    """leaf key (``leaf_key``) -> the dim of its per-layer tensor (a stacked
    leaf without its stacked axes, ``lead_axes``) that ``plan`` splits over
    ``axis``, None where it stays whole, or is split on a stacked axis
    (``stacked_dims``).  Raises if the plan splits two leaves of one key on
    different dims."""
    return {k: (None if stacked else d) for k, (stacked, d) in _dims(plan, axis).items()}


def stacked_dims(plan, axis: str = AXIS) -> Dict[str, int]:
    """leaf key -> which of its stacked axes (0 the first, ``lead_axes``)
    ``plan`` splits over ``axis``, for the leaves it splits so: the hybrid's
    ``w_out`` and ``norm_scale`` on M (1) where ``model`` divides M."""
    return {k: d for k, (stacked, d) in _dims(plan, axis).items() if stacked}


class TPContext:
    """This rank's place on the ``model`` axis of ``mesh`` (``size``,
    ``index``), the transport the operations go over, ``dims``
    (``split_dims`` of the plan) and ``stacked`` (``stacked_dims``)."""

    def __init__(self, mesh, transport, plan):
        self.size, self.index, self.mesh_shape = mesh.shape[AXIS], mesh.coords[AXIS], dict(mesh.shape)
        self.transport = transport
        self.dims = split_dims(plan)
        self.stacked = stacked_dims(plan)


_CURRENT: Optional[TPContext] = None


@contextlib.contextmanager
def use(ctx: Optional[TPContext]):
    """Run the model's functions split as ``ctx`` says (None: whole)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = ctx
    try:
        yield
    finally:
        _CURRENT = prev


def _active() -> Optional[TPContext]:
    return _CURRENT if _CURRENT is not None and _CURRENT.size > 1 else None


def split_dim(name: str) -> Optional[int]:
    """The dim of the per-layer matrix of the leaf of key ``name``
    (``leaf_key``) that is split over ``model`` in the current context; None
    without one or where it is whole."""
    ctx = _active()
    return None if ctx is None else ctx.dims.get(name)


def first(n: int) -> int:
    """The first index of this rank's part of a dim of length ``n`` split over
    ``model``; 0 without a context."""
    ctx = _active()
    return 0 if ctx is None else ctx.index * (n // ctx.size)


def divides(n: int) -> bool:
    """Whether ``n`` (a head count) splits evenly over the ``model`` ranks."""
    ctx = _active()
    return ctx is None or n % ctx.size == 0


def mesh_shape() -> Optional[Dict[str, int]]:
    """The current context's mesh (axis -> size), for messages; None without one."""
    ctx = _active()
    return None if ctx is None else ctx.mesh_shape


def _my_part(ctx: TPContext, t: torch.Tensor, dim: int) -> torch.Tensor:
    n = t.shape[dim] // ctx.size
    return t.narrow(dim, ctx.index * n, n)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.ctx.transport.all_reduce(g.clone(memory_format=torch.contiguous_format), AXIS), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        return ctx.transport.all_reduce(x.clone(memory_format=torch.contiguous_format), AXIS)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.ctx, fctx.dim = ctx, dim
        return ctx.transport.all_gather(x.contiguous(), AXIS, dim)

    @staticmethod
    def backward(fctx, g):
        return _my_part(fctx.ctx, g, fctx.dim).contiguous(), None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, dim, ctx):
        fctx.ctx, fctx.dim = ctx, dim
        return _my_part(ctx, x, dim).contiguous()

    @staticmethod
    def backward(fctx, g):
        return fctx.ctx.transport.all_gather(g.contiguous(), AXIS, fctx.dim), None, None


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """``x`` (whole on every rank) entering a product split on its output dim."""
    ctx = _active()
    return x if ctx is None else _CopyIn.apply(x, ctx)


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ``model`` ranks of their partial ``x``."""
    ctx = _active()
    return x if ctx is None else _ReduceOut.apply(x, ctx)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' parts of ``x`` concatenated along ``dim`` in ``model`` order."""
    ctx = _active()
    return x if ctx is None else _Gather.apply(x, dim % x.dim(), ctx)


def slice_(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's part of ``x`` (whole on every rank) along ``dim``."""
    ctx = _active()
    return x if ctx is None else _Slice.apply(x, dim % x.dim(), ctx)


def part(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's part of ``x`` along ``dim``, a view with no collective: its
    gradient is zero outside the part, for an ``x`` that a ``copy_in``
    upstream sums over ``model`` on the way back."""
    ctx = _active()
    return x if ctx is None else _my_part(ctx, x, dim)


def gather_stacked(tree):
    """``tree`` (a group's or a layer's view of a stacked tree, which has lost
    the first stacked axis; its leaves keyed by name) with each leaf that the
    plan splits on a stacked axis over ``model`` gathered whole (``gather``);
    the same tree without a context or where the plan splits none so.  The
    rules never split a stacked leaf's first axis (``param_spec_candidates``
    puts ``None`` there), so the split axis is one that the view keeps, one
    dim to the left."""
    ctx = _active()
    if ctx is None or not ctx.stacked:
        return tree

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else (gather(v, ctx.stacked[k] - 1) if k in ctx.stacked else v)
                for k, v in t.items()}

    return walk(tree)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The cross entropy (B, c) in f32 of f32 ``logits`` (B, c, V / TP), this
    rank's columns of the vocabulary, against ``labels`` (B, c) in the whole
    vocabulary: logsumexp - the gold logit, over the ranks.  The row maxima
    are gathered (the transport only sums) and their largest taken; the sums
    of exponentials and the gold logits, each from the rank that owns its
    label, are summed over ``model`` in one all-reduce."""
    ctx = _active()
    n = logits.shape[-1]
    with torch.no_grad():
        top = ctx.transport.all_gather(logits.amax(-1)[None].contiguous(), AXIS, 0).amax(0)
    local = labels.long() - ctx.index * n
    inside = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0].masked_fill(~inside, 0)
    sums = reduce_out(torch.stack([torch.exp(logits - top[..., None]).sum(-1), gold]))
    return torch.log(sums[0]) + top - sums[1]
