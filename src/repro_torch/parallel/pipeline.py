"""Cross-pod pipeline parallelism: the paper's "PP across DCs", as
``repro/parallel/pipeline.py`` runs it, over ranks of ``torch.distributed``.

The ``pod`` mesh axis carries pipeline stages, ``data`` carries DP within a
pod, ``model`` carries TP.  Each rank holds its stage's layers (the rows
[s Lp/S, (s+1) Lp/S) of the layer stack padded to Lp, those below L being
real) and a copy of every leaf outside the stack (``rest``, replicated as the
reference's ``P()``), and runs this data shard of each microbatch.

The schedule is an explicit fill-drain (GPipe) one: the forward of each of
the ``n_micro`` microbatches in order (stage 0 embeds, the others receive
from the previous pod), then the backward in reverse order (the last stage
starts from ``final_loss``, the others receive the output's gradient from the
next pod, run ``torch.autograd.backward`` and send the input's gradient back).
That is the reverse rotation that autodiff of the reference's scan over
``n_micro + S - 1`` steps gives.  The reference computes the bubble steps, in
which a stage has no valid microbatch, and multiplies their results by 0; the
port skips them.

Boundary modes, the paper's two transports:
  * ``direct``  (Varuna / one-TCP): every ``model`` rank sends the whole
    activation (backward, the whole gradient) to the same ``model`` rank of
    the next (previous) pod: TP times the unique bytes cross the WAN.
  * ``striped`` (Atlas multi-TCP): ``model`` rank j sends slice j of the
    feature axis (the reference's ``P(None, None, "model")``), and the
    receiving pod all-gathers the slices over its ``model`` group: each rank
    carries 1/TP of the unique bytes over the WAN.
  The numbers are the same in both; only the bytes on each link differ
  (``Transport.bytes``).

Tensor parallelism over ``model`` inside each stage (``plan``, the whole
model's placement plan, ``tensor_parallel.model_plan``: every family, on a
``model`` axis of more than 1), as the reference's partial-auto
region has GSPMD place the parameters of its ``--pipeline`` launcher
(``make_param_shardings``, fsdp off): each rank holds its stage's rows of its
``model`` block of every stacked leaf and its block of ``embed`` and
``lm_head`` (``stage_params``, then ``shard_params``), and the whole step runs
inside the ``model`` context (``tensor_parallel.use``): the embedding gathers
its feature columns, each layer's products compute on the rank's shards, and
the last stage takes the cross entropy over the vocabulary's ranks.  The
residual stream stays whole on every ``model`` rank, so the boundaries carry
what they carry without a plan, and the input's gradient that a stage sends
back is the ``copy_in`` all-reduce's, the same bits on every ``model`` rank.
A routed expert's leaf is 4-D, (layers, E, d, f), and split on its expert dim
(dim 1 of the stack) or its features: ``stage_params`` cuts the stage's rows
first and ``shard_params`` the block of those; the hybrid's ``groups`` leaves
likewise, the Mamba2 ones (G, M, ...) cut on G and then on the dim the plan
splits, and its ``shared_attn`` block, outside the stack, by the plan alone.
Without a plan the ``model`` ranks compute the same numbers, as the
reference's fully manual fall-back does ("the model axis carrying
replicas").

FSDP over ``data`` inside the stages (a ``plan`` that splits leaves over
``data`` as well, ``model_plan(cfg, mesh, fsdp=True)``, the reference's
dry-run's placement of its train shapes, on a ``data`` axis of more than 1):
each rank holds its ``data`` block of its ``model`` shard of its stage's rows
of such a leaf, and of ``embed``, ``lm_head`` and the hybrid's
``shared_attn`` where the plan splits them.  The reference's region is manual
over ``{pod, data}`` and takes its layers as ``P("pod")`` and ``rest`` as
``P()``, so over ``data`` it sees each stage whole: GSPMD gathers each
data-split leaf once a call, where the region is entered, and the gradient
leaves it as the sum over ``data``, put back on the fsdp spec.  So here: once
a step, before the first microbatch, each such leaf is all-gathered over
``data`` outside autograd, and the gathered leaves are what the microbatches
read and what their gradients accumulate into; after the last microbatch's
backward each one's gradient is reduce-scattered over ``data`` to this rank's
block, one call a leaf.  Not a layer's gather inside remat, as on the plain
step (``parallel/fsdp.py``): here that would gather each layer twice a
microbatch and reduce-scatter once a microbatch.  The models' own gathers
(``fsdp.gather_layer``, ``gather_leaf``) stay the identity, as no ``fsdp``
context is entered.  A ``model`` axis of 1, which the fsdp plan names too,
splits nothing over ``model``.  Where the plan puts ``data`` on the stack's
own axis (7f-iii: a stacked vector whose one feature dim ``model``'s rule
takes), a stage's rows are split over ``data`` where ``data`` divides them
and kept whole in the stage otherwise (``stage_plan``; ``shard_params``
fits each spec to the stage's rows alike), and the once-a-step gather takes
them with the rest.

Loss and gradients: the loss is the sum over this rank's microbatches of
``final_loss`` (last stage only) plus the layers' aux, summed over ``pod``
and ``data`` and divided by n_micro * DP.  Layer gradients are summed over
``data``; the gradients of ``rest`` over ``data`` and ``pod`` (the transpose
of the replicated input).  Under a plan each is this rank's block; a leaf the
plan leaves whole (the norm scales) has its whole gradient on every ``model``
rank, the same bits on each; under FSDP a data-split leaf's block is its
part of the reduce-scatter, the same sums as the all-reduce's.  Gradients are
f32, as the f32 parameters.

Non-divisible layer counts (deepseek-v2-lite: 27, zamba2: 9 groups) are
padded with exact-identity zero layers (residual blocks with zero weights add
exactly 0; zamba2's shared block is switched off by its zero-padded per-group
gate).  Padding happens inside the loss, as the reference's: padded layers
are not parameters (no gradient, no moments, never saved).  A zero MoE layer
still adds the load-balance aux of a uniform router to the loss, a constant
with no gradient, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.convert import flatten, tree_map, unflatten
from repro_torch.models.modules import ModelConfig, Params
from repro_torch.models.transformer import (
    _batch_positions,
    _batch_route,
    _loss_targets,
    _remat,
    _unstack,
    build_pipeline_parts,
)
from repro_torch.optim.optimizer import OptState
from repro_torch.parallel import fsdp
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import P, axis_blocks, unshard
from repro_torch.parallel.transport import Transport

BOUNDARIES = ("striped", "direct")


def _pad_rows(layers, rows: int):
    """The layer-stacked tree with zero rows appended up to ``rows``."""

    def pad(leaf):
        n = rows - leaf.shape[0]
        if n == 0:
            return leaf
        return torch.cat([leaf, leaf.new_zeros((n,) + tuple(leaf.shape[1:]))], 0)

    return tree_map(pad, layers)


def pad_layer_stack(layers, num_stages: int):
    """Zero-pad the leading (layer) axis to a multiple of num_stages.

    Zero weights make a residual block an exact identity (attn/FFN/Mamba
    deltas are 0), so padding does not change the function."""
    return _pad_rows(layers, padded_num_layers(_lead(layers), num_stages))


def padded_num_layers(num_layers: int, num_stages: int) -> int:
    return num_layers + ((-num_layers) % num_stages)


def stack_length(cfg: ModelConfig) -> int:
    """The rows of the layer stack: layers, or the hybrid's groups."""
    return cfg.num_layers // cfg.attn_period if cfg.family == "hybrid" else cfg.num_layers


def stage_layer_range(num_layers: int, num_stages: int, stage: int) -> Tuple[int, int]:
    """[lo, hi) of the padded stack that ``stage`` runs; rows below
    ``num_layers`` are real, the rest padding."""
    per = padded_num_layers(num_layers, num_stages) // num_stages
    return stage * per, (stage + 1) * per


def stage_params(params: Params, cfg: ModelConfig, mesh) -> Params:
    """This rank's share of a whole model's parameters: the real layers of
    its stage (copies outside any graph, so the whole stack can be freed and
    each is a leaf of its own) and every leaf outside the stack (shared with
    ``params``)."""
    key = build_pipeline_parts(cfg).layer_key
    L = stack_length(cfg)
    lo, hi = stage_layer_range(L, mesh.shape["pod"], mesh.coords["pod"])
    lo, hi = min(lo, L), min(hi, L)
    return {k: (tree_map(lambda t: t[lo:hi].detach().clone(), v) if k == key else v) for k, v in params.items()}


def assemble_params(stages: Sequence[Params], cfg: ModelConfig) -> Params:
    """The inverse of ``stage_params``: the whole model from the stages' trees
    in ``pod`` order, the rows of the stack concatenated in layer order, every
    leaf outside it from stage 0."""
    key = build_pipeline_parts(cfg).layer_key
    layers = [flatten(s[key]) for s in stages]
    whole = unflatten({p: torch.cat([f[p] for f in layers], 0) for p in layers[0]})
    return {k: (whole if k == key else v) for k, v in stages[0].items()}


def stage_plan(plan: Optional[Dict], cfg: ModelConfig, mesh, stage: Optional[int] = None) -> Optional[Dict]:
    """The plan of stage ``stage``'s share (``stage_params``; this rank's
    stage by default) under the whole model's ``plan``: a stacked leaf that
    the plan splits over ``data`` on its layer (or group) axis (7f-iii) has
    its stage's real rows split over ``data`` where ``data`` divides them, and
    whole in the stage otherwise, as ``_fit_spec`` drops an axis that does
    not divide a dim (RWKV-6's smoke ``w0``, one row a stage on (2, 2, 2),
    stays whole); every other leaf's spec is the plan's.  Over ``data`` the
    numbers are the reference's either way: its region sees each stage whole.
    None for None."""
    if plan is None:
        return None
    key = build_pipeline_parts(cfg).layer_key
    L = stack_length(cfg)
    lo, hi = (min(i, L) for i in stage_layer_range(L, mesh.shape["pod"],
                                                   mesh.coords["pod"] if stage is None else stage))

    def fit(path: str, spec: P) -> P:
        if path.split("/", 1)[0] != key or not spec or spec[0] is None:
            return spec
        return spec if hi > lo and (hi - lo) % axis_blocks(spec[0], mesh) == 0 else P(None, *spec[1:])

    return unflatten({p: fit(p, spec) for p, spec in flatten(plan).items()})


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns summed as int64: equal tensors give equal sums."""
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.detach().contiguous().reshape(-1).view(view).sum(dtype=torch.int64)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True).contiguous()


def gather_train_state(params: Params, opt_state, cfg: ModelConfig, mesh,
                       plan: Optional[Dict] = None) -> Optional[Dict[str, Any]]:
    """The whole, unpadded train state ``{"params", "opt"}`` of a pipelined
    run (a mesh with a ``pod`` axis), of a tensor-parallel one, of an FSDP
    one (``plan``, the whole model's placement plan, with fsdp on or off), or
    of any of them together, on rank 0's host; None on every other rank.
    Every rank must call it.

    The ranks hold the pieces: stage s's rows of the stack on the ranks of
    ``pod`` s (``stage_plan`` gives each stage's plan), block j of each leaf
    the plan splits over ``model`` on the ranks of ``model`` j, and block i of
    each leaf it splits over ``data`` on the ranks of ``data`` i.  Rank 0
    receives from each of them, in (stage, model, data) order, the pieces it
    lacks (``_pieces``: the stack's rows from every stage, the split leaves'
    blocks from every ``model`` and every ``data`` rank, and nothing twice),
    on the host (``gloo`` point to point, CPU tensors, nothing through the
    card); it puts each stage's blocks together over ``data`` at each
    ``model`` index, then over ``model`` (``unshard``), and the stages in
    layer order (``assemble_params``).  Every other leaf, its moments and
    ``.step`` are rank 0's.  The leaves that are not gathered are replicated:
    before the gather every rank's sums of their bit patterns are held equal
    over the world (all-reduced as a minimum and a maximum), and a rank that
    differs raises on every rank."""
    trees = {"params": params, "mu": opt_state.mu, "nu": opt_state.nu}
    S, DP, TP = (mesh.shape.get(a, 1) for a in ("pod", "data", "model"))
    staged, plans = _pieces(cfg, mesh, plan)
    model_split = [tp.split_paths(q, "model") if TP > 1 else set() for q in plans]  # an axis of 1 splits nothing
    data_split = [tp.split_paths(q, fsdp.AXIS) if DP > 1 else set() for q in plans]
    replicated = [opt_state.step] + [t for tree in trees.values() for p, t in flatten(tree).items()
                                     if not staged(p) and p not in model_split[0] and p not in data_split[0]]
    if mesh.size > 1:
        sums = torch.stack([_bits(t).cpu() for t in replicated])
        lo, hi = sums.clone(), sums.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        if not torch.equal(lo, hi):
            raise RuntimeError(f"rank {mesh.rank}: the replicated leaves or the step differ across the ranks")

    def needed(p: str, s: int, i: int, j: int) -> bool:  # whether rank (pod s, data i, model j) holds a piece rank 0 lacks
        return ((s, i, j) != (0, 0, 0) and (s == 0 or staged(p)) and (i == 0 or p in data_split[s])
                and (j == 0 or p in model_split[s]))

    me = tuple(mesh.coords.get(a, 0) for a in ("pod", "data", "model"))
    if me != (0, 0, 0):
        for tree in trees.values():
            for p, t in flatten(tree).items():
                if needed(p, *me) and t.numel():
                    dist.send(_host(t), mesh.rank_at(**_at(mesh, 0, 0, 0)))
        return None
    L = stack_length(cfg)
    out = {}
    for name, tree in trees.items():
        own = {p: _host(t) for p, t in flatten(tree).items()}
        stages = []
        for s in range(S):
            lo_s, hi_s = (min(i, L) for i in stage_layer_range(L, S, s))
            blocks = []
            for j in range(TP):
                by_data = []
                for i in range(DP):
                    if (s, i, j) == (0, 0, 0):
                        by_data.append(own)
                        continue
                    got = {}
                    for p, t in own.items():
                        if needed(p, s, i, j):
                            rows = hi_s - lo_s if staged(p) else None
                            got[p] = torch.empty(_piece_shape(p, t, plans[s], mesh, rows), dtype=t.dtype)
                            if got[p].numel():
                                dist.recv(got[p], mesh.rank_at(**_at(mesh, s, i, j)))
                    by_data.append(got)
                trees_i = [unflatten(b) for b in by_data]
                blocks.append(trees_i[0] if plan is None else unshard(trees_i, plans[s], fsdp.AXIS))
            stages.append(blocks[0] if plan is None else unshard(blocks, plans[s], "model"))
        out[name] = assemble_params(stages, cfg) if S > 1 else stages[0]
    return {"params": out["params"], "opt": OptState(_host(opt_state.step), out["mu"], out["nu"])}


def _piece_shape(path: str, own: torch.Tensor, plan: Optional[Dict], mesh, rows: Optional[int]) -> Tuple[int, ...]:
    """The shape of another rank's piece of the leaf at ``path``, of which
    rank 0 holds ``own``: its stage's ``rows`` of the stack (None outside
    it), split over ``data`` where that stage's ``plan`` splits them, and
    every other dim as rank 0's block."""
    if rows is None:
        return tuple(own.shape)
    spec = flatten(plan)[path] if plan is not None else ()
    return (rows // axis_blocks(spec[0] if spec else None, mesh),) + tuple(own.shape[1:])


def _pieces(cfg: ModelConfig, mesh, plan: Optional[Dict]):
    """(whether a leaf is cut into stages, each stage's plan) for
    ``gather_train_state``: on a mesh with a ``pod`` axis the stacked leaves
    are staged and each stage has its own plan (``stage_plan``)."""
    if "pod" not in mesh.shape:
        return (lambda p: False), [plan]
    key = build_pipeline_parts(cfg).layer_key
    return (lambda p: p.split("/", 1)[0] == key), [stage_plan(plan, cfg, mesh, s) for s in range(mesh.shape["pod"])]


def _at(mesh, pod: int, data: int, model: int) -> Dict[str, int]:
    """The coordinates of (``pod``, ``data``, ``model``), for the axes the mesh has."""
    return {a: c for a, c in (("pod", pod), ("data", data), ("model", model)) if a in mesh.shape}


def _microbatch(batch: Dict[str, torch.Tensor], rows: slice) -> Dict[str, torch.Tensor]:
    """``rows`` of every leaf of a batch: of (3, B, T) positions on dim 1,
    of the rest on dim 0."""
    return {k: (v[:, rows] if k == "positions" and v.dim() == 3 else v[rows]) for k, v in batch.items()}


def _lead(tree) -> int:
    return next(iter(flatten(tree).values())).shape[0]


class PipelineLoss:
    """``loss(params, batch) -> (loss, grads)`` of this rank, over the mesh's
    ``pod`` axis: ``params`` are this rank's (``stage_params``), ``batch`` the
    global batch, ``loss`` the f32 scalar every rank returns alike and
    ``grads`` a flat dict in ``flatten(params)``'s order, summed over the
    ranks as the module docstring says.  ``grad_norm(grads)`` is the global
    norm of the whole (unpadded) model's gradient; ``transport.bytes`` counts
    what this rank has sent.  ``transport`` is a ``Transport`` over ``mesh``
    by default; the dry-run gives a ``MetaTransport``.  ``plan`` (the whole
    model's, ``tensor_parallel.model_plan``) turns tensor parallelism over
    ``model`` on inside the stages where it splits leaves over a ``model``
    axis of more than 1, and FSDP over ``data`` where it splits leaves over a
    ``data`` axis of more than 1: ``params`` are then this rank's shards of
    its stage (``shard_params`` of ``stage_params``), and the loss reads the
    stage's plan (``stage_plan``)."""

    def __init__(self, cfg: ModelConfig, mesh, n_micro: int = 4, boundary: str = "striped",
                 transport: Optional[Transport] = None, plan: Optional[Dict] = None):
        if boundary not in BOUNDARIES:
            raise ValueError(f"boundary {boundary!r}: one of {BOUNDARIES}")
        if cfg.tie_embeddings:
            raise ValueError("the pipeline requires untied embeddings: a tied table is read on the first stage "
                             "and the last, as the reference requires")
        self.cfg, self.mesh, self.n_micro, self.boundary = cfg, mesh, n_micro, boundary
        self.parts = build_pipeline_parts(cfg)
        self.S, self.DP, self.TP = (mesh.shape[a] for a in ("pod", "data", "model"))
        if boundary == "striped" and cfg.d_model % self.TP:
            raise ValueError(f"striped boundary: d_model {cfg.d_model} is not split by the model axis {self.TP}")
        self.transport = Transport(mesh) if transport is None else transport
        plan = stage_plan(plan, cfg, mesh)  # this rank's stage's
        tp_on = plan is not None and self.TP > 1  # the fsdp plan on (pod, data, 1) names model too
        self.tp = tp.TPContext(mesh, self.transport, plan) if tp_on else None
        self.split = tp.split_paths(plan) if tp_on else set()
        self.gathered = fsdp.data_dims(plan) if self.DP > 1 else {}  # path -> its dim split over data

    # ---- the stage boundary ----------------------------------------------

    def _send(self, t: torch.Tensor, step: int) -> None:
        if self.boundary == "striped":
            w = t.shape[-1] // self.TP
            j = self.mesh.coords["model"]
            t = t[..., j * w:(j + 1) * w]
        self.transport.send(t, "pod", step)

    def _recv(self, shape, dtype, device, step: int) -> torch.Tensor:
        if self.boundary == "striped":
            part = self.transport.recv(shape[:-1] + (shape[-1] // self.TP,), dtype, device, "pod", step)
            return self.transport.all_gather(part, "model", dim=-1)
        return self.transport.recv(shape, dtype, device, "pod", step)

    # ---- the step ----------------------------------------------------------

    def __call__(self, params: Params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg, parts, n_micro, S, DP = self.cfg, self.parts, self.n_micro, self.S, self.DP
        stage, shard = self.mesh.coords["pod"], self.mesh.coords["data"]
        inp = batch["embeds"] if "embeds" in batch else batch["tokens"]
        B, T = inp.shape[:2]
        if B % (n_micro * DP):
            raise ValueError(f"batch {B} is not split into {n_micro} microbatches of {DP} data shards")
        rows_per = B // (n_micro * DP)

        def rows(m: int) -> slice:  # microbatch m's data shard: chunk m * DP + shard of the batch
            k = m * DP + shard
            return slice(k * rows_per, (k + 1) * rows_per)

        flat = flatten(params)
        if self.gathered:  # once a step, where the reference's region is entered; the gathered leaves take the grads
            with torch.no_grad():
                flat = {p: self.transport.all_gather(t, "data", self.gathered[p]) if p in self.gathered else t
                        for p, t in flat.items()}
            params = unflatten(flat)
        for t in flat.values():
            t.requires_grad_(True)
            t.grad = None
        key = parts.layer_key
        rest = {k: v for k, v in params.items() if k != key}
        per = padded_num_layers(stack_length(cfg), S) // S
        layers = _unstack(_pad_rows(params[key], per), per)  # padding: zeros made here, not parameters
        layer = _remat(parts.layer, cfg.remat)
        scale = 1.0 / (n_micro * DP)
        dev = inp.device
        act = (rows_per, T, cfg.d_model)

        total = torch.zeros((), dtype=torch.float32, device=dev)
        saved: List[Optional[Tuple]] = []
        with tp.use(self.tp), _batch_route(batch):
            for m in range(n_micro):
                mb = _microbatch(batch, rows(m))
                if stage == 0:
                    x, pos = parts.embed(rest, mb)
                else:
                    x = self._recv(act, cfg.dtype, dev, -1).requires_grad_(True)
                    pos = _batch_positions(cfg, mb, act[:2], dev)
                h, aux = x, None
                for lp in layers:
                    h, a = layer(lp, rest, h, pos)
                    if a is not None:
                        aux = a if aux is None else aux + a
                outs = []
                if stage == S - 1:
                    ce = parts.final_loss(rest, h, *_loss_targets(mb))
                    outs.append(ce * scale)
                    total = total + ce.detach()
                else:
                    self._send(h.detach(), +1)
                    outs.append(h)
                if aux is not None:
                    outs.append(aux * scale)
                    total = total + aux.detach()
                saved.append((x, outs))

            for m in reversed(range(n_micro)):
                x, outs = saved[m]
                douts: List[Optional[torch.Tensor]] = [None] * len(outs)
                if stage < S - 1:
                    douts[0] = self._recv(act, cfg.dtype, dev, +1)
                pairs = [(o, g) for o, g in zip(outs, douts) if o.requires_grad]
                if pairs:
                    torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
                if stage > 0:
                    gx = x.grad if x.grad is not None else torch.zeros_like(x)
                    self._send(gx, -1)
                saved[m] = None

        grads = {}
        for path, t in flat.items():
            grads[path] = t.grad if t.grad is not None else torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            t.grad = None
        self._reduce(grads, key)
        for axis in ("data", "pod"):
            self.transport.all_reduce(total, axis)
        return total * scale, grads

    def _reduce(self, grads: Dict[str, torch.Tensor], key: str) -> None:
        """Under FSDP each gathered leaf's gradient reduce-scattered over
        ``data`` to this rank's block, one call a leaf.  Then the layer
        gradients whole over ``data`` summed over it; ``rest``'s over
        ``data`` (those whole over it), then all of ``rest``'s over ``pod``.
        Each set travels as one flat buffer, ``rest``'s whole leaves first."""
        for p, dim in self.gathered.items():
            grads[p] = self.transport.reduce_scatter(grads[p], "data", dim)
        layer_paths = [p for p in grads if p.split("/", 1)[0] == key and p not in self.gathered]
        rest_paths = sorted((p for p in grads if p.split("/", 1)[0] != key), key=lambda p: p in self.gathered)
        for paths, axes in ((layer_paths, ("data",)), (rest_paths, ("data", "pod"))):
            if not paths or all(self.mesh.shape[a] == 1 for a in axes):
                continue
            buf = torch.cat([grads[p].reshape(-1) for p in paths])
            whole = sum(grads[p].numel() for p in paths if p not in self.gathered)
            for axis in axes:
                part = buf[:whole] if axis == "data" and whole < buf.numel() else buf
                if part.numel():
                    self.transport.all_reduce(part, axis)
            for p, piece in zip(paths, buf.split([grads[p].numel() for p in paths])):
                grads[p] = piece.view(grads[p].shape)

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole model's gradient: this stage's layer
        squares summed over ``pod``, plus ``rest``'s counted once (every rank
        holds the same).  Without a plan the ``model`` ranks are replicas;
        under one the squares of the split leaves' blocks are summed over
        ``model`` first, and the whole leaves' counted once; under FSDP the
        squares of the data-split blocks are summed over ``data`` before
        that."""
        key = self.parts.layer_key
        zero = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
        sq = {(layer, split): zero for layer in (True, False) for split in (True, False)}
        data_sq = dict(sq)  # the data-split blocks' squares, by the same key
        for path, g in grads.items():
            at = (path.split("/", 1)[0] == key, path in self.split)
            if path in self.gathered:
                data_sq[at] = data_sq[at] + g.float().square().sum()
            else:
                sq[at] = sq[at] + g.float().square().sum()
        if self.gathered:
            summed = self.transport.all_reduce(torch.stack(list(data_sq.values())), "data")
            sq = {at: sq[at] + s for at, s in zip(data_sq, summed)}
        if self.split:
            blocks = self.transport.all_reduce(torch.stack([sq[True, True], sq[False, True]]), "model")
            layer_sq, rest_sq = blocks[0] + sq[True, False], blocks[1] + sq[False, False]
        else:
            layer_sq, rest_sq = sq[True, False], sq[False, False]
        layer_sq = self.transport.all_reduce(layer_sq.clone(), "pod")
        return torch.sqrt(layer_sq + rest_sq)


def make_pipeline_loss(cfg: ModelConfig, mesh, *, n_micro: int = 4, boundary: str = "striped",
                       plan: Optional[Dict] = None) -> PipelineLoss:
    """Build loss(params, batch) -> (loss, grads) running PP over the mesh's
    ``pod`` axis, and with ``plan`` TP over ``model`` inside each stage (and
    FSDP over ``data`` where the plan splits leaves over it)."""
    return PipelineLoss(cfg, mesh, n_micro, boundary, plan=plan)

