"""Helpers of the FSDP tests (``tests/test_torch_fsdp*.py``).

``loss_rank`` is a rank of a ``gloo`` world spawned by
``torch_pipeline_helpers.spawn``: for each case in turn, this rank's blocks of
the whole model under the plan with fsdp on (``model_plan(fsdp=True)``,
``shard_params``) and one ``DataParallelLoss`` call on a global batch.
``train_rank`` trains such blocks with ``make_train_step``.  ``assembled``
puts the ranks' blocks back together, over ``data`` and then ``model``;
``data_bytes_owed`` is what a call puts on the ``data`` axis, from the code.
``world_rank`` runs all of one test file's work in one spawned world.  This
module imports no JAX at its top, so the ranks never load it.
"""
from __future__ import annotations

import math

import torch

AXES = ("data", "model")


def fsdp_plan(cfg, shape, min_bytes: int = 0):
    """The plan with fsdp on of ``cfg`` on (data, model) = ``shape``, at
    ``_add_fsdp_axis``'s threshold ``min_bytes`` (0: every leaf with a dim
    that ``data`` divides)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.tensor_parallel import model_plan

    return model_plan(cfg, Mesh(shape, AXES), fsdp=True, min_bytes=min_bytes)


def loss_rank(rank: int, shape, cases) -> list:
    """This rank of (data, model) = ``shape``, for each (cfg, params,
    batch, min_bytes) of ``cases``: its blocks of ``params`` under the fsdp
    plan, and the loss, gradients (its blocks), their norm and the
    transport's byte counts of one ``DataParallelLoss`` call and its
    ``grad_norm``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.data_parallel import DataParallelLoss
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.tensor_parallel import model_plan

    mesh = make_mesh(shape, AXES)
    out = []
    for cfg, params, batch, min_bytes in cases:
        plan = model_plan(cfg, mesh, fsdp=True, min_bytes=min_bytes)
        loss_fn = DataParallelLoss(build_model(cfg).loss, mesh, plan=plan)
        loss, grads = loss_fn(shard_params(params, mesh, plan), batch)
        out.append({"coords": mesh.coords, "loss": loss, "grads": {p: g.detach() for p, g in grads.items()},
                    "grad_norm": loss_fn.grad_norm(grads), "bytes": loss_fn.transport.counts()})
    return out


def train_rank(rank: int, cfg, shape, params, batches, lr: float, min_bytes: int) -> dict:
    """This rank of (data, model) = ``shape`` trained on ``batches`` (one
    step each) from its blocks of ``params`` under the fsdp plan, with
    ``make_train_step`` over ``DataParallelLoss`` and the launcher's schedule
    (``optimizer_config(lr, len(batches))``): the losses, the final blocks and
    moments (flat), and the transport's counts."""
    from repro_torch.convert import flatten, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import optimizer_config
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.optimizer import init_opt_state, make_train_step
    from repro_torch.parallel.data_parallel import DataParallelLoss
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.tensor_parallel import model_plan

    mesh = make_mesh(shape, AXES)
    plan = model_plan(cfg, mesh, fsdp=True, min_bytes=min_bytes)
    # spawn hands params over in shared memory, and the step writes the blocks in place
    blocks = tree_map(lambda t: t.clone(), shard_params(params, mesh, plan))
    loss_fn = DataParallelLoss(build_model(cfg).loss, mesh, plan=plan)
    step = make_train_step(loss_fn, optimizer_config(lr, len(batches)))
    opt, losses = init_opt_state(blocks), []
    for b in batches:
        blocks, opt, m = step(blocks, opt, b)
        losses.append(float(m["loss"]))
    return {"coords": mesh.coords, "losses": losses, "params": {k: v.detach() for k, v in flatten(blocks).items()},
            "mu": flatten(opt.mu), "nu": flatten(opt.nu), "bytes": loss_fn.transport.counts()}


def gather_check(rank: int, shape) -> dict:
    """The gather on use by itself on (data, model) = ``shape``: a (4, 6)
    leaf split on dim 1 over ``data``, and a stacked (2, 4, 6) one split on
    dim 1, taken a layer at a time (dim 0 of the layer's view), each gathered
    and differentiated against a weight of this rank's (rank + 1 times a
    ramp), so that the gradient's blocks are those of 3 x the ramp summed
    over two ranks.  Returns what was gathered, the blocks' gradients and the
    transport's counts."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import P, local_block
    from repro_torch.parallel.transport import Transport

    mesh = make_mesh(shape, AXES)
    plan = {"w": P(None, "data"), "layers": {"w": P(None, "data", None)}}
    whole, stacked = torch.arange(24.0).reshape(4, 6), torch.arange(48.0).reshape(2, 4, 6)
    block = local_block(whole, plan["w"], mesh).clone().requires_grad_(True)
    sblock = local_block(stacked, plan["layers"]["w"], mesh).clone().requires_grad_(True)
    transport = Transport(mesh)
    unchanged = fsdp.gather_leaf(block, "w") is block and fsdp.gather_layer({"w": block}, "layers")["w"] is block
    with fsdp.use(fsdp.FSDPContext(mesh, transport, plan)):
        got = fsdp.gather_leaf(block, "w")
        layers = [fsdp.gather_layer({"w": lp}, "layers")["w"] for lp in sblock.unbind(0)]
        ramp = torch.arange(24.0).reshape(4, 6) * (rank + 1)
        loss = (got * ramp).sum() + sum((lp * ramp).sum() for lp in layers)
        loss.backward()
    return {"unchanged": unchanged, "got": got.detach(), "layers": [lp.detach() for lp in layers],
            "grad": block.grad, "stacked_grad": sblock.grad, "bytes": transport.counts(),
            "block": block.detach(), "sblock": sblock.detach()}


def world_rank(rank: int, shape, cases, train=None, gather: bool = False) -> dict:
    """All of one test file's work on this rank of one spawned world:
    ``gather_check`` where asked, ``loss_rank`` of ``cases``, and
    ``train_rank`` of ``train`` (cfg, params, batches, lr, min_bytes)."""
    return {"gather": gather_check(rank, shape) if gather else None, "cases": loss_rank(rank, shape, cases),
            "train": None if train is None else train_rank(rank, train[0], shape, *train[1:])}


def assembled(results, plan, key: str = "grads") -> dict:
    """The whole model's ``key`` (flat) from every rank's blocks: over
    ``data`` at each ``model`` index, then over ``model`` (``unshard``)."""
    from repro_torch.convert import flatten, unflatten
    from repro_torch.parallel.sharding import unshard

    by_model = {}
    for r in results:
        by_model.setdefault(r["coords"]["model"], []).append(r)
    shards = [unshard([unflatten(r[key]) for r in sorted(rs, key=lambda r: r["coords"]["data"])], plan, "data")
              for _, rs in sorted(by_model.items())]
    return flatten(unshard(shards, plan, "model"))


def data_bytes_owed(cfg, plan, shape, blocks: dict, batch: dict, *, norm: bool = True) -> dict:
    """What one ``DataParallelLoss`` call (and its ``grad_norm`` with
    ``norm``) puts on ``data`` from a rank, in f32, from the code.  ``blocks``
    is the rank's flat blocks.  A data-split leaf is gathered where it is
    read: a layer's leaves once a layer (a hybrid's shared block once a
    group), twice under remat "full" (the recomputation gathers again), a
    stacked leaf split on its layer (or group) axis once a step
    (``fsdp.gather_stack``, outside remat), the embedding where tokens are
    embedded and the head once; the gradient of
    each gather of the forward is reduce-scattered, the whole leaf, DP times
    the block.  All-reduced: every other leaf's gradient, the mask count and
    the loss (4 B each), a MoE layer's two aux means (2, E) (twice under
    remat "full"), and ``grad_norm``'s two sums of squares."""
    from repro_torch.parallel.fsdp import data_dims
    from repro_torch.parallel.tensor_parallel import split_paths

    DP = shape[0]
    scattered = split_paths(plan, "data")
    once = {p for p, d in data_dims(plan).items() if d == 0 and p.split("/")[0] in ("layers", "groups")}
    again = 2 if cfg.remat == "full" else 1
    groups = cfg.num_layers // cfg.attn_period if cfg.family == "hybrid" else 1

    def uses(path: str) -> int:
        top = path.split("/")[0]
        if top in ("layers", "groups"):
            return 1
        if top == "shared_attn":
            return groups
        if top == "embed":
            return int("tokens" in batch) + int(cfg.tie_embeddings)
        return 1

    gathered = sum(4 * blocks[p].numel() * uses(p) * (1 if p in once or p.split("/")[0] in ("embed", "lm_head")
                                                      else again) for p in scattered)
    scatter = sum(4 * DP * blocks[p].numel() * uses(p) for p in scattered)
    reduced = sum(4 * t.numel() for p, t in blocks.items() if p not in scattered) + 4 + 4
    if cfg.moe is not None:
        reduced += again * cfg.num_layers * 4 * 2 * cfg.moe.num_experts
    if norm:
        reduced += 8
    return {"send": 0, "all_reduce": reduced, "all_gather": gathered, "reduce_scatter": scatter}


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| in norm, in f32."""
    return float((got.float() - want.float()).norm()) / max(float(want.float().norm()), 1e-30)


def n_elems(tree: dict) -> int:
    return sum(math.prod(t.shape) for t in tree.values())
