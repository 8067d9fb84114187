"""Helpers of the pipeline tests (``tests/test_torch_pipeline_*.py``).

``spawn`` runs a function on the ranks of a ``gloo`` world of CPU processes
(``torch.multiprocessing``'s ``spawn`` start method, ``file://`` rendezvous
under the test's ``tmp_path``), each with a deadline, and returns what each
rank saved.  ``pipeline_run`` is the rank function: this rank's share of the
converted parameters, the pipelined loss and gradients for each boundary, and
optionally a few train steps.  This module imports no JAX at its top, so the
ranks never load it; ``reference_microbatch_mean`` (the parent's) does.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_lib

DEADLINE_S = 150  # a whole spawned run; a rank that waits on another fails after mesh_lib.TIMEOUT
AXES = ("pod", "data", "model")


def _entry(rank: int, fn, world: int, tmp: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank,
                            world_size=world, timeout=mesh_lib.TIMEOUT)
    try:
        torch.save(fn(rank, *args), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, deadline: float = DEADLINE_S) -> list:
    """``fn(rank, *args)`` on ``world`` ranks; returns each rank's result.
    Raises if a rank raises, dies or outlives ``deadline`` (all are stopped)."""
    tmp = str(tmp_path)
    ctx = torch.multiprocessing.start_processes(_entry, args=(fn, world, tmp, args), nprocs=world, join=False,
                                                start_method="spawn")
    end = time.monotonic() + deadline
    try:
        while not ctx.join(timeout=max(0.05, end - time.monotonic())):
            if time.monotonic() >= end:
                raise TimeoutError(f"{world} ranks outlived {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def pipeline_run(rank: int, cfg, shape, params_path: str, batches_path: str, boundaries, n_micro: int,
                 train_steps: int = 0, lr: float = 3e-3, tensor_parallel: bool = False) -> dict:
    """This rank of a pipeline over a (pod, data, model) mesh of ``shape``:
    for each boundary, the loss, gradients and byte counters of one call on
    the first batch; with ``train_steps``, that many steps of the pipelined
    train step (the last boundary) on the batches in turn, and the state.
    With ``tensor_parallel``, tensor-parallel over ``model`` inside the
    stages by ``model_plan``: the rank holds its shards of its stage."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state, make_train_step
    from repro_torch.parallel.pipeline import make_pipeline_loss, stage_params
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.tensor_parallel import model_plan

    mesh = make_mesh(shape, AXES)
    plan = model_plan(cfg, mesh) if tensor_parallel else None
    params = stage_params(torch.load(params_path), cfg, mesh)
    if plan is not None:
        params = shard_params(params, mesh, plan)
    batches = torch.load(batches_path)
    out = {"coords": mesh.coords, "runs": {}, "shapes": {k: tuple(v.shape) for k, v in _flat(params).items()}}
    for boundary in boundaries:
        loss_fn = make_pipeline_loss(cfg, mesh, n_micro=n_micro, boundary=boundary, plan=plan)
        loss, grads = loss_fn(params, batches[0])
        out["runs"][boundary] = {"loss": loss, "grads": grads, "grad_norm": loss_fn.grad_norm(grads),
                                 "bytes": loss_fn.transport.counts()}
    if train_steps:
        ocfg = OptimizerConfig(peak_lr=lr, warmup_steps=1, total_steps=train_steps)
        step = make_train_step(make_pipeline_loss(cfg, mesh, n_micro=n_micro, boundary=boundaries[-1], plan=plan),
                               ocfg)
        state = init_opt_state(params)
        out["losses"], out["grad_norms"] = [], []
        for b in batches[:train_steps]:
            params, state, m = step(params, state, b)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
        out["params"] = {k: v.detach() for k, v in _flat(params).items()}
        out["mu"], out["nu"] = _flat(state.mu), _flat(state.nu)
    return out


def _flat(tree):
    from repro_torch.convert import flatten

    return flatten(tree)


def save_inputs(tmp_path, params, batches) -> tuple:
    """The whole model's parameters and the batches (lists of dicts of
    tensors) in files the ranks load."""
    p, b = os.path.join(str(tmp_path), "params.pt"), os.path.join(str(tmp_path), "batches.pt")
    torch.save(params, p)
    torch.save(batches, b)
    return p, b


def stage_ranks(results) -> list:
    """The ranks of model and data coordinate 0, one a stage, in pod order."""
    return sorted((r for r in results if r["coords"]["data"] == 0 and r["coords"]["model"] == 0),
                  key=lambda r: r["coords"]["pod"])


def assemble(results, key: str, boundary: str) -> dict:
    """The whole model's gradient from the ranks: each stage's layer rows (from
    its rank of data and model coordinate 0) stacked in order; the other
    leaves from rank 0."""
    stages = stage_ranks(results)
    out = {}
    for path, g in results[0]["runs"][boundary]["grads"].items():
        if path.split("/", 1)[0] == key:
            out[path] = torch.cat([s["runs"][boundary]["grads"][path] for s in stages], 0)
        else:
            out[path] = g
    return out


def assemble_blocks(results, cfg, plan, part) -> dict:
    """The whole model's tree (flat) from the ranks of a tensor-parallel
    pipeline: ``part(rank's result)`` (a flat dict of its shards of its
    stage) of the ranks of data coordinate 0, each stage's put together over
    ``model`` (``unshard``) and the stages in layer order (``assemble_params``)."""
    from repro_torch.convert import flatten, unflatten
    from repro_torch.parallel.pipeline import assemble_params
    from repro_torch.parallel.sharding import unshard

    stages = []
    for s in range(1 + max(r["coords"]["pod"] for r in results)):
        ranks = sorted((r for r in results if r["coords"]["pod"] == s and r["coords"]["data"] == 0),
                       key=lambda r: r["coords"]["model"])
        stages.append(unshard([unflatten(part(r)) for r in ranks], plan))
    return flatten(assemble_params(stages, cfg))


def reference_pipeline_loss(ref_cfg, num_stages: int, chunks: int):
    """``loss(params, batch)`` of the reference's pipelined step over one
    device (JAX arrays): the mean over the ``chunks`` row chunks of the batch
    (microbatch m, data shard d is chunk m * DP + d) of ``final_loss`` plus the
    layers' aux, each chunk through the reference's ``build_pipeline_parts``
    over the stack padded for ``num_stages``, as ``repro/parallel/pipeline.py``
    computes it."""
    import jax
    import jax.numpy as jnp
    from repro.models.transformer import build_pipeline_parts
    from repro.parallel.pipeline import pad_layer_stack

    parts = build_pipeline_parts(ref_cfg)

    def loss(params, batch):
        embeds = "embeds" in batch
        B, T = (batch["embeds"] if embeds else batch["tokens"]).shape[:2]
        c = B // chunks
        if "positions" in batch:
            positions = batch["positions"]
        else:
            positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32)[None], (B, T))
            if ref_cfg.mrope_sections is not None:
                positions = jnp.broadcast_to(positions[None], (3, B, T))
        if positions.ndim == 3:
            pos_c = positions.reshape(3, chunks, c, T).transpose(1, 0, 2, 3)
        else:
            pos_c = positions.reshape(chunks, c, T)
        targets = batch.get("labels")
        if targets is None:
            targets = jnp.pad(batch["tokens"][:, 1:], ((0, 0), (0, 1)))
            mask = jnp.ones_like(targets, jnp.float32).at[:, -1].set(0.0)
        else:
            mask = batch.get("mask", jnp.ones_like(targets, jnp.float32))
        inp = batch["embeds"] if embeds else batch["tokens"]
        inp_c = inp.reshape((chunks, c) + inp.shape[1:])
        t_c, m_c = targets.reshape(chunks, c, T), mask.reshape(chunks, c, T)
        layers = pad_layer_stack(params[parts.layer_key], num_stages)
        rest = {k: v for k, v in params.items() if k != parts.layer_key}

        def chunk(total, xs):
            i, pos, t, m = xs
            x = i.astype(ref_cfg.dtype) if embeds else jnp.take(rest["embed"], i, axis=0).astype(ref_cfg.dtype)
            x, auxs = jax.lax.scan(lambda h, lp: parts.layer(lp, rest, h, pos), x, layers)
            return total + parts.final_loss(rest, x, t, m) + jnp.sum(auxs), None

        total, _ = jax.lax.scan(chunk, jnp.float32(0.0), (inp_c, pos_c, t_c, m_c))
        return total / chunks

    return loss


def reference_microbatch_mean(ref_cfg, ref_params, batch_np: dict, num_stages: int, chunks: int):
    """``jax.value_and_grad`` of ``reference_pipeline_loss`` on one batch:
    (value, flat gradients)."""
    import jax
    import jax.numpy as jnp

    loss = reference_pipeline_loss(ref_cfg, num_stages, chunks)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    value, grads = jax.jit(jax.value_and_grad(lambda p: loss(p, batch)))(ref_params)
    return float(value), {k: np.asarray(v) for k, v in _jax_flat(grads).items()}


def _jax_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_jax_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def hold_against_reference(results, ref, key: str, boundary: str, tol: float, cfg=None, plan=None) -> None:
    """Every rank's loss, and the whole gradient assembled from the stages
    (under a tensor-parallel ``plan``, from the stages' blocks:
    ``assemble_blocks``), against the reference's (value, flat gradients) at
    ``tol``: the loss relative and absolute, each leaf relative with atol =
    tol * max|ref leaf|."""
    ref_loss, ref_grads = ref
    for r in results:
        np.testing.assert_allclose(float(r["runs"][boundary]["loss"]), ref_loss, rtol=tol, atol=tol)
    if plan is None:
        grads = assemble(results, key, boundary)
    else:
        grads = assemble_blocks(results, cfg, plan, lambda r: r["runs"][boundary]["grads"])
    assert set(grads) == set(ref_grads)
    for path, g in grads.items():
        want = ref_grads[path]
        np.testing.assert_allclose(g.numpy(), want, rtol=tol, atol=tol * float(np.abs(want).max()), err_msg=path)


def hold_boundaries_equal(results) -> None:
    """``striped`` and ``direct`` give the same loss, norm and gradients, bit for bit."""
    for r in results:
        s, d = r["runs"]["striped"], r["runs"]["direct"]
        assert torch.equal(s["loss"], d["loss"]) and torch.equal(s["grad_norm"], d["grad_norm"])
        for path, g in s["grads"].items():
            assert torch.equal(g, d["grads"][path]), path


def jax_tree(tree):
    """A nested dict of numpy arrays as one of JAX arrays."""
    import jax.numpy as jnp

    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def pipeline_case(tmp_path, arch: str, shape, boundaries, *, n_micro: int = 4, batch: int = 8, seq: int = 32,
                  train_steps: int = 0, lr: float = 3e-3, tensor_parallel: bool = False, experts=None,
                  **replace) -> dict:
    """``arch``'s smoke config in f32 (with ``replace``'s fields, and
    ``experts`` routed experts where given) from the port's init (seed 0),
    its batches from ``make_batches(seed 0)``: the ranks' results on a mesh of
    ``shape`` (``tensor_parallel``: by ``model_plan`` inside the stages), and
    the reference's microbatch mean on the first batch."""
    import dataclasses

    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro_torch import configs, convert
    from repro_torch.data.pipeline import DataConfig, make_batches
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=torch.float32, **replace)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jnp.float32, **replace)
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, num_experts=experts))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg).init(gen)
    it = make_batches(cfg, DataConfig(seed=0, batch_size=batch, seq_len=seq), num_steps=max(train_steps, 1))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in it]
    results = spawn(pipeline_run, int(np.prod(shape)), tmp_path, cfg, tuple(shape),
                    *save_inputs(tmp_path, params, batches), tuple(boundaries), n_micro, train_steps, lr,
                    tensor_parallel)
    ref = reference_microbatch_mean(ref_cfg, jax_tree(convert.to_reference(params)),
                                    {k: v.numpy() for k, v in batches[0].items()}, shape[0], n_micro * shape[1])
    return {"cfg": cfg, "ref_cfg": ref_cfg, "params": params, "batches": batches, "results": results, "ref": ref}


def smoke_case(arch: str, replace: dict, batch: int, seq: int):
    """(cfg, the reference's cfg, the port's params from seed 0, the same as
    JAX arrays, one numpy batch) of ``arch``'s smoke config in f32."""
    import dataclasses

    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro_torch import configs, convert
    from repro_torch.data.pipeline import input_batch_for
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=torch.float32, **replace)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jnp.float32, **replace)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg).init(gen)
    return cfg, ref_cfg, params, jax_tree(convert.to_reference(params)), input_batch_for(cfg, batch, seq)


def stack_rows(tree) -> int:
    """The leading (layer) length of a layer-stacked tree."""
    from repro_torch.convert import flatten

    return next(iter(flatten(tree).values())).shape[0]


def train_rank(rank: int, runs) -> list:
    """This rank of ``launch.train.train`` for each (cfg, mesh shape, axes,
    keyword arguments) of ``runs`` in turn, on the CPU: each run's history
    and this rank's final state (params, mu, nu flat; step).  Parameters
    given in ``kwargs`` are copied first: the spawned ranks receive them in
    shared memory, and ``train`` updates them in place."""
    from repro_torch.convert import tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train

    out = []
    for cfg, shape, axes, kwargs in runs:
        if kwargs.get("params") is not None:
            kwargs = {**kwargs, "params": tree_map(lambda t: t.clone(), kwargs["params"])}
        mesh = make_mesh(shape, axes)
        res = train(cfg, device="cpu", mesh=mesh, **kwargs)
        st = res["opt_state"]
        out.append({"coords": mesh.coords, "losses": [h["loss"] for h in res["history"]],
                    "bytes": res["history"][-1].get("bytes"), "checkpoint": res["checkpoint"],
                    "params": {k: v.detach() for k, v in _flat(res["params"]).items()},
                    "mu": _flat(st.mu), "nu": _flat(st.nu), "step": st.step})
    return out
