"""The placement plan: which mesh axis each dim of each leaf is split over,
as ``repro/parallel/sharding.py`` decides it.

The production layout (DESIGN.md §5) follows the paper's placement:
  - ``pod``   axis: pipeline stages (paper: PP across DCs)
  - ``data``  axis: data parallelism (paper: DP rings intra-DC)
  - ``model`` axis: tensor/expert parallelism (paper: TP/EP on NVLink)

Pure functions over shapes and a mesh's axis sizes (anything with a
``shape`` mapping axis names to sizes): each returns a ``P``, one entry per
dim (None, an axis name or a tuple of names), or a tree of them.  The dry-run's
shapes read this plan, and ``shard_params`` applies it: each rank keeps its
block of every leaf (``NamedSharding(mesh, spec).shard_shape`` of the
reference), over ``model`` for tensor parallelism
(``parallel/tensor_parallel.py``) and, with fsdp, over ``data`` as well
(``parallel/fsdp.py``); ``unshard`` puts the ranks' blocks back together, one
axis a call.

Not ported: the reference's ``constrain``, ``constraints_disabled`` and
``_ambient_mesh``.  They only steer XLA's partitioner, which the port does not
have, and the reference never lets them change the arithmetic (its pipeline
runs the model with them switched off).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.convert import flatten, tree_map, unflatten


class P(tuple):
    """A partition spec: ``P(None, "model")`` splits dim 1 over ``model``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):  # pickled (a plan handed to spawned ranks) as its entries, not as one tuple
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


def _axes(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def _fit_spec(shape: Tuple[int, ...], spec: P, mesh) -> Optional[P]:
    """Drop axes that don't divide the dim; None if nothing remains."""
    axes = _axes(mesh)
    fitted = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            fitted.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        ok = [n for n in names if n in axes]
        size = 1
        for n in ok:
            size *= axes[n]
        if ok and dim % size == 0:
            fitted.append(tuple(ok) if len(ok) > 1 else ok[0])
        else:
            fitted.append(None)
    if all(f is None for f in fitted):
        return None
    return P(*fitted)


# logical rules: tensor-name suffix -> P (applied by best effort)
PARAM_RULES: Dict[str, P] = {
    # attention projections: shard the head (output-feature) dim
    "wq": P(None, "model"),
    "wk": P(None, "model"),
    "wv": P(None, "model"),
    "wo": P("model", None),
    # MLA
    "w_dkv": P(None, None),
    "w_uk": P(None, "model"),
    "w_uv": P(None, "model"),
    # FFN
    "w_gate": P(None, "model"),
    "w_up": P(None, "model"),
    "w_down": P("model", None),
    # embedding table: shard the feature dim; LM head: shard the vocab dim
    "embed": P(None, "model"),
    "lm_head": P(None, "model"),
    "router": P(None, None),
    # mamba2: head-sharded TP
    "w_z": P(None, "model"),
    "w_x": P(None, "model"),
    "w_bc": P(None, None),
    "w_dt": P(None, None),
    "conv_x": P(None, "model"),
    "conv_bc": P(None, None),
    "w_out": P("model", None),
    "norm_scale": P("model"),
    # rwkv6: head-sharded time-mix, model-sharded channel-mix
    "wr": P(None, "model"),
    "wg": P(None, "model"),
    "w0": P("model"),
    "w_lora_a": P(None, None),
    "w_lora_b": P(None, "model"),
    "u": P("model", None),
    "ck": P(None, "model"),
    "cv": P("model", None),
    "cr": P(None, "model"),
    # norms / scalars replicated
}

MOE_RULES: Dict[str, Tuple[P, ...]] = {
    # routed experts: shard the expert dim (EP); when the expert count does
    # not divide the model axis (qwen2-moe: 60 experts on 16), fall back to
    # sharding the FFN feature dim so the weights never replicate
    "w_gate": (P("model", None, None), P(None, None, "model")),
    "w_up": (P("model", None, None), P(None, None, "model")),
    "w_down": (P("model", None, None), P(None, "model", None)),
}


def param_spec_candidates(path: Tuple[str, ...], shape: Tuple[int, ...], stacked: bool) -> Tuple[P, ...]:
    """Candidate specs for a parameter leaf, best first.  ``stacked`` =>
    leading layer axis.  The caller picks the first that fits the mesh."""
    name = path[-1]
    in_moe = any(p in ("moe", "experts") for p in path[:-1]) and name in MOE_RULES and len(shape) >= 3
    cands = MOE_RULES[name] if in_moe else (PARAM_RULES.get(name, P()),)
    if stacked:
        cands = tuple(P(None, *c) for c in cands)
    return cands


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], stacked: bool) -> P:
    return param_spec_candidates(path, shape, stacked)[0]


FSDP_MIN_BYTES = 2**22  # _add_fsdp_axis's default: a leaf of 4 MiB or more in f32


def _add_fsdp_axis(spec: P, shape: Tuple[int, ...], mesh, min_bytes: int = FSDP_MIN_BYTES) -> P:
    """ZeRO/FSDP-style 2D sharding: also shard a large, still-unsharded dim of
    big matrices over the ``data`` axis (weights are all-gathered on use;
    params + Adam state memory drops by the data-axis size)."""
    axes = _axes(mesh)
    if "data" not in axes:
        return spec
    n = 1
    for d in shape:
        n *= d
    if n * 4 < min_bytes or len(shape) < 2:
        return spec
    entries = list(tuple(spec) + (None,) * (len(shape) - len(spec)))
    dp = axes["data"]
    # pick the largest unsharded dim divisible by the data axis
    cands = [(shape[i], i) for i, e in enumerate(entries) if e is None and shape[i] % dp == 0 and shape[i] > 1]
    if not cands:
        return spec
    _, i = max(cands)
    entries[i] = "data"
    return P(*entries)


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's or array's ``shape``, a (shape, dtype) pair
    as the models' ``cache_shape`` gives, or a tuple of ints."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if leaf and isinstance(leaf[0], (tuple, list)):
        return tuple(leaf[0])
    return tuple(leaf)


def _leaf_plan(names: Tuple[str, ...], shape: Tuple[int, ...], mesh, stacked: bool, fsdp: bool,
               min_bytes: int) -> P:
    for spec in param_spec_candidates(names or ("",), shape, stacked):
        fitted = _fit_spec(shape, spec, mesh)
        if fitted is not None:
            if fsdp:
                fitted2 = _fit_spec(shape, _add_fsdp_axis(fitted, shape, mesh, min_bytes), mesh)
                if fitted2 is not None:
                    return fitted2
            return fitted
    return P()


def make_param_shardings(params_shape: Any, mesh, stacked_prefixes=("layers", "groups"), *, fsdp: bool = False,
                         min_bytes: int = FSDP_MIN_BYTES):
    """The plan of a params(-shape) tree: the same nested dicts, a ``P`` at
    each leaf (the reference returns ``NamedSharding``s of these specs).
    ``min_bytes`` is ``_add_fsdp_axis``'s threshold under ``fsdp``: the
    reference's 4 MiB, lowered only by tests that split small leaves."""

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + (str(k),)) for k, v in tree.items()}
        stacked = any(n in stacked_prefixes for n in names)
        return _leaf_plan(names, _shape(tree), mesh, stacked, fsdp, min_bytes)

    return walk(params_shape, ())


def _block(entry, mesh) -> Tuple[int, int]:
    """(blocks, this rank's block) of a dim whose plan entry is ``entry``: an
    axis name, or a tuple of names split in row-major order, as JAX splits."""
    n, i = 1, 0
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.coords[a]
    return n, i


def axis_blocks(entry, mesh) -> int:
    """The blocks that a dim whose plan entry is ``entry`` is split into (1
    for None)."""
    return 1 if entry is None else _block(entry, mesh)[0]


def local_block(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view).  Raises where an
    axis does not divide its dim."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            n, i = _block(entry, mesh)
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} is not split into {n} blocks ({spec})")
            size = t.shape[dim] // n
            t = t.narrow(dim, i * size, size)
    return t


def shard_params(params: Any, mesh, plan: Any = None) -> Any:
    """This rank's share of a whole model's parameters under ``plan``
    (``make_param_shardings(params, mesh)`` by default): its block of each
    leaf the plan splits, a copy outside any graph (so that the whole leaf can
    be freed), and every leaf the plan leaves whole, shared with ``params``.
    Each spec is fitted to the leaf it is given (``_fit_spec``), so that a
    pipeline stage's rows (``stage_params``) that an axis of the whole
    model's plan does not divide stay whole, as the stage's plan has them
    (``pipeline.stage_plan``)."""
    plan = make_param_shardings(params, mesh) if plan is None else plan
    specs = flatten(plan)

    def cut(p: str, t: torch.Tensor) -> torch.Tensor:
        spec = _fit_spec(tuple(t.shape), specs[p], mesh)
        if spec is None:
            return t
        return local_block(t, spec, mesh).detach().clone(memory_format=torch.contiguous_format)

    return unflatten({p: cut(p, t) for p, t in flatten(params).items()})


def unshard(shards, plan: Any, axis: str = "model") -> Any:
    """The inverse of ``shard_params`` over ``axis``: each leaf the plan
    splits over ``axis`` concatenated from ``shards`` (the trees of the ranks
    along ``axis`` in order, at one place on every other axis) on that dim,
    every other leaf from ``shards[0]``.  A leaf split over two axes (fsdp's
    ``data`` block of a ``model`` shard) is put back together one axis a call:
    over ``data`` at each ``model`` index, then over ``model``."""
    specs = flatten(plan)
    flats = [flatten(s) for s in shards]
    out = {}
    for p, t in flats[0].items():
        dims = [d for d, e in enumerate(specs[p]) if e == axis]
        out[p] = torch.cat([f[p] for f in flats], dims[0]) if dims else t
    return unflatten(out)


def batch_spec(ndim: int) -> P:
    """Shard the batch (dim 0) over data; rest replicated."""
    return P("data", *([None] * (ndim - 1)))


def _is_int32(leaf) -> bool:
    dtype = leaf[1] if isinstance(leaf, tuple) and len(leaf) == 2 else getattr(leaf, "dtype", "")
    return str(dtype).endswith("int32")


def make_batch_shardings(batch_shape: Any, mesh):
    """A batch's plan: dim 0 over ``data``; VLM positions (3, B, T) int32 on dim 1."""

    def one(leaf):
        shape = _shape(leaf)
        spec = batch_spec(len(shape))
        if len(shape) == 3 and shape[0] == 3 and _is_int32(leaf):
            spec = P(None, "data", None)
        fitted = _fit_spec(shape, spec, mesh)
        return fitted if fitted is not None else P()

    return tree_map(one, batch_shape)


def make_cache_shardings(cache_shape: Any, mesh):
    """KV caches: batch on data, head/feature dims on model where they fit."""

    def one(leaf):
        shape = _shape(leaf)
        if len(shape) == 5:  # (L, B, S, Hkv, Dh)
            spec = P(None, "data", None, "model", None)
        elif len(shape) == 4:  # (L, B, S, d) latent / conv state
            spec = P(None, "data", None, None)
        elif len(shape) == 3:  # (L, B, S) positions
            spec = P(None, "data", None)
        else:
            spec = P()
        fitted = _fit_spec(shape, spec, mesh)
        return fitted if fitted is not None else P()

    return tree_map(one, cache_shape)
