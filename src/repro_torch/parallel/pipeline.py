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

Tensor parallelism is not done here: ranks on the ``model`` axis compute the
same numbers, as the reference's fully manual fall-back does ("the model axis
carrying replicas").

Loss and gradients: the loss is the sum over this rank's microbatches of
``final_loss`` (last stage only) plus the layers' aux, summed over ``pod``
and ``data`` and divided by n_micro * DP.  Layer gradients are summed over
``data``; the gradients of ``rest`` over ``data`` and ``pod`` (the transpose
of the replicated input).  Gradients are f32, as the f32 parameters.

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


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns summed as int64: equal tensors give equal sums."""
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.detach().contiguous().reshape(-1).view(view).sum(dtype=torch.int64)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True).contiguous()


def gather_train_state(params: Params, opt_state, cfg: ModelConfig, mesh) -> Optional[Dict[str, Any]]:
    """The whole, unpadded train state ``{"params", "opt"}`` of a pipelined
    run, on rank 0's host; None on every other rank.  Every rank must call it.

    The stack's rows and their moments come from the rank of each stage in
    rank 0's ``data`` and ``model`` coordinates, received by rank 0 over
    ``pod`` on the host (``gloo`` point to point, CPU tensors, nothing through
    the card) and put back in layer order (``assemble_params``); the leaves
    outside the stack, their moments and ``.step`` are rank 0's.  Those are
    replicated: before the gather every rank's sums of their bit patterns are
    held equal over the world (all-reduced as a minimum and a maximum), and a
    rank that differs raises on every rank."""
    key = build_pipeline_parts(cfg).layer_key
    trees = {"params": params, "mu": opt_state.mu, "nu": opt_state.nu}
    replicated = [opt_state.step] + [t for tree in trees.values() for k, v in tree.items() if k != key
                                     for t in flatten({k: v}).values()]
    if mesh.size > 1:
        sums = torch.stack([_bits(t).cpu() for t in replicated])
        lo, hi = sums.clone(), sums.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        if not torch.equal(lo, hi):
            raise RuntimeError(f"rank {mesh.rank}: the replicated leaves or the step differ across the ranks")

    if mesh.coords["data"] or mesh.coords["model"]:
        return None
    L, S = stack_length(cfg), mesh.shape["pod"]
    if mesh.coords["pod"]:
        for tree in trees.values():
            for t in flatten(tree[key]).values():
                if t.numel():
                    dist.send(_host(t), mesh.rank_at(pod=0))
        return None
    out = {}
    for name, tree in trees.items():
        stages = [tree_map(_host, tree)]
        for s in range(1, S):
            lo_s, hi_s = (min(i, L) for i in stage_layer_range(L, S, s))
            rows = {}
            for path, t in flatten(tree[key]).items():
                rows[path] = torch.empty((hi_s - lo_s,) + tuple(t.shape[1:]), dtype=t.dtype)
                if rows[path].numel():
                    dist.recv(rows[path], mesh.rank_at(pod=s))
            stages.append({key: unflatten(rows)})
        out[name] = assemble_params(stages, cfg)
    return {"params": out["params"], "opt": OptState(_host(opt_state.step), out["mu"], out["nu"])}


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
    by default; the dry-run gives a ``MetaTransport``."""

    def __init__(self, cfg: ModelConfig, mesh, n_micro: int = 4, boundary: str = "striped",
                 transport: Optional[Transport] = None):
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
        with _batch_route(batch):
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
        """Layer gradients summed over ``data``; ``rest``'s over ``data``, then
        ``pod``.  Each set travels as one flat buffer."""
        layer_paths = [p for p in grads if p.split("/", 1)[0] == key]
        rest_paths = [p for p in grads if p.split("/", 1)[0] != key]
        for paths, axes in ((layer_paths, ("data",)), (rest_paths, ("data", "pod"))):
            if not paths or all(self.mesh.shape[a] == 1 for a in axes):
                continue
            buf = torch.cat([grads[p].reshape(-1) for p in paths])
            for axis in axes:
                self.transport.all_reduce(buf, axis)
            for p, piece in zip(paths, buf.split([grads[p].numel() for p in paths])):
                grads[p] = piece.view(grads[p].shape)

    def grad_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole model's gradient: this stage's layer
        squares summed over ``pod``, plus ``rest``'s counted once (every rank
        holds the same, and ``model`` ranks are replicas)."""
        key = self.parts.layer_key
        layer_sq = rest_sq = torch.zeros((), dtype=torch.float32, device=next(iter(grads.values())).device)
        for path, g in grads.items():
            s = g.float().square().sum()
            if path.split("/", 1)[0] == key:
                layer_sq = layer_sq + s
            else:
                rest_sq = rest_sq + s
        layer_sq = self.transport.all_reduce(layer_sq.clone(), "pod")
        return torch.sqrt(layer_sq + rest_sq)


def make_pipeline_loss(cfg: ModelConfig, mesh, *, n_micro: int = 4, boundary: str = "striped") -> PipelineLoss:
    """Build loss(params, batch) -> (loss, grads) running PP over the mesh's ``pod`` axis."""
    return PipelineLoss(cfg, mesh, n_micro, boundary)

