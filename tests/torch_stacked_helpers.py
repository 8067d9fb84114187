"""Helpers of the tests of the plan's stacked splits (ROADMAP 7f-iii, ``data``
on a layer or group axis; 7b-vi, ``model`` on the hybrid's M) and of an FSDP
state's checkpoint (Queue 1 (d)).

``plan_rank`` is a rank of a ``gloo`` world spawned by
``torch_pipeline_helpers.spawn``: for each case, its blocks of the whole model
under a plan given by the parent and one ``DataParallelLoss`` call (the plain
step) or one ``PipelineLoss`` call for each boundary (a mesh with ``pod``).
``ckpt_rank`` trains one step under a plan, writes the gathered state through
``AsyncCheckpointer``, steps on, and resumes from the file.  ``meta_counts``
is the dry-run's count of the same call on ``meta``.  ``without`` is a plan
with some leaves made whole.  This module imports no JAX at its top, so the
ranks never load it.
"""
from __future__ import annotations

import dataclasses

import torch

BOUNDARIES = ("direct", "striped")
N_MICRO = 4


# the smoke hybrid with three layers a group (M = 2 Mamba2 layers, G = 2
# groups): the plan puts ``model`` on M where ``model`` is 2
HYBRID_M2 = {"num_layers": 6, "attn_period": 3}
PURE = {"family": "ssm"}  # zamba2's smoke as the pure Mamba2 stack


def axes(shape) -> tuple:
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def without(plan, axis: str) -> dict:
    """``plan`` without its splits of a stacked axis over ``axis`` (those
    entries ``None``): the same placement with the stacked leaves whole on
    that axis."""
    from repro_torch.convert import flatten, unflatten
    from repro_torch.parallel.sharding import P
    from repro_torch.parallel.tensor_parallel import is_split, lead_axes

    def one(path, spec):
        lead = lead_axes(path)
        return P(*((None if d < lead and is_split((e,), axis) else e) for d, e in enumerate(spec)))

    return unflatten({p: one(p, spec) for p, spec in flatten(plan).items()})


def stacked_paths(plan, axis: str) -> list:
    """The leaves ``plan`` splits on a stacked axis over ``axis``."""
    from repro_torch.convert import flatten
    from repro_torch.parallel.tensor_parallel import is_split, lead_axes

    return sorted(p for p, spec in flatten(plan).items() if is_split(tuple(spec)[:lead_axes(p)], axis))


def _base(cfg, mesh, params):
    """The whole model (the plain step) or this rank's stage of it."""
    from repro_torch.parallel.pipeline import stage_params

    return stage_params(params, cfg, mesh) if "pod" in mesh.shape else params


def _calls(cfg, mesh, plan, blocks, batch) -> dict:
    """boundary (None on the plain step) -> the loss, gradients, norm and
    transport counts of one call."""
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.data_parallel import DataParallelLoss
    from repro_torch.parallel.pipeline import make_pipeline_loss

    out = {}
    for b in (BOUNDARIES if "pod" in mesh.shape else (None,)):
        loss_fn = (make_pipeline_loss(cfg, mesh, n_micro=N_MICRO, boundary=b, plan=plan) if b
                   else DataParallelLoss(build_model(cfg).loss, mesh, plan=plan))
        loss, grads = loss_fn(blocks, batch)
        out[b] = {"loss": loss, "grads": {p: g.detach() for p, g in grads.items()},
                  "grad_norm": loss_fn.grad_norm(grads), "bytes": loss_fn.transport.counts()}
    return out


def plan_rank(rank: int, shape, cases) -> list:
    """This rank of ``shape`` ((data, model) or (pod, data, model)), for each
    (cfg, params path, batch, {name: plan}) of ``cases``: for each plan its
    block shapes and ``_calls``."""
    from repro_torch.convert import flatten
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import shard_params

    mesh = make_mesh(shape, axes(shape))
    out = []
    for cfg, params_path, batch, plans in cases:
        base = _base(cfg, mesh, torch.load(params_path))
        res = {"coords": mesh.coords}
        for name, plan in plans.items():
            blocks = shard_params(base, mesh, plan) if plan is not None else base
            res[name] = {"shapes": {p: tuple(t.shape) for p, t in flatten(blocks).items()},
                         "calls": _calls(cfg, mesh, plan, blocks, batch)}
        out.append(res)
    return out


def meta_counts(cfg, shape, plan, batch_shape, rank: int, boundary=None) -> dict:
    """The dry-run's transport counts of rank ``rank``'s call and its
    ``grad_norm`` under ``plan`` on ``meta`` (``MetaTransport``), the
    parameters made as the dry-run makes them (``dryrun.meta_params``)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.data_parallel import DataParallelLoss
    from repro_torch.parallel.pipeline import PipelineLoss
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.transport import MetaTransport

    mesh = Mesh(shape, axes(shape), rank)
    model = build_model(cfg)
    params = shard_params(_base(cfg, mesh, dryrun.meta_params(model)), mesh, plan)
    batch = dryrun.train_batch(cfg, *batch_shape)
    loss_fn = (PipelineLoss(cfg, mesh, N_MICRO, boundary, transport=MetaTransport(mesh), plan=plan) if boundary
               else DataParallelLoss(model.loss, mesh, transport=MetaTransport(mesh), plan=plan))
    _, grads = loss_fn(params, batch)
    loss_fn.grad_norm(grads)
    return loss_fn.transport.counts()


def _snapshot(params, opt) -> dict:
    from repro_torch.convert import flatten

    return {"params": {p: t.detach().clone() for p, t in flatten(params).items()},
            "mu": {p: t.clone() for p, t in flatten(opt.mu).items()},
            "nu": {p: t.clone() for p, t in flatten(opt.nu).items()}, "step": opt.step.clone()}


def ckpt_rank(rank: int, shape, cases, ckpt_dir: str) -> list:
    """This rank of ``shape`` for each (cfg, params path, batches path,
    {name: plan}) of ``cases``: under each plan, one step of
    ``make_train_step`` from its blocks (lr 3e-3, two steps of schedule), the
    state after it (``_snapshot``) and the whole state gathered to rank 0
    (``gather_train_state``); under the first plan rank 0 also writes that
    state through ``AsyncCheckpointer``, every rank steps once more (the live
    run), then loads the file, cuts it by the plan (``stage_params`` in the
    stages, ``shard_params``) and steps once from it (the resumed run)."""
    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import AsyncCheckpointer, load_pytree
    from repro_torch.convert import flatten, tree_map
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.optimizer import OptimizerConfig, OptState, init_opt_state, make_train_step
    from repro_torch.parallel.data_parallel import DataParallelLoss
    from repro_torch.parallel.pipeline import gather_train_state, make_pipeline_loss
    from repro_torch.parallel.sharding import shard_params

    mesh = make_mesh(shape, axes(shape))
    out = []
    for i, (cfg, params_path, batches_path, plans) in enumerate(cases):
        whole, batches = torch.load(params_path), torch.load(batches_path)
        res = {"coords": mesh.coords}
        for k, (name, plan) in enumerate(plans.items()):
            blocks = tree_map(lambda t: t.clone(), shard_params(_base(cfg, mesh, whole), mesh, plan))
            loss_fn = (make_pipeline_loss(cfg, mesh, n_micro=N_MICRO, boundary=BOUNDARIES[-1], plan=plan)
                       if "pod" in mesh.shape else DataParallelLoss(build_model(cfg).loss, mesh, plan=plan))
            step = make_train_step(loss_fn, OptimizerConfig(peak_lr=3e-3, warmup_steps=1, total_steps=2))
            blocks, opt, _ = step(blocks, init_opt_state(blocks), batches[0])
            state = gather_train_state(blocks, opt, cfg, mesh, plan=plan)
            run = {"one": _snapshot(blocks, opt), "state": state, "bytes": loss_fn.transport.counts()}
            if k == 0:
                path = f"{ckpt_dir}/case{i}"
                if mesh.rank == 0:
                    ck = AsyncCheckpointer(path)
                    ck.save(1, state, {"step": 1})
                    ck.close()
                dist.barrier()
                blocks, opt, _ = step(blocks, opt, batches[1])
                run["live"] = _snapshot(blocks, opt)
                like = {"params": whole, "opt": init_opt_state(whole)}
                got = load_pytree(f"{path}/step_{1:08d}.npz", like)
                cut = {part: shard_params(_base(cfg, mesh, tree), mesh, plan)
                       for part, tree in (("params", got["params"]), ("mu", got["opt"].mu), ("nu", got["opt"].nu))}
                opt2 = OptState(got["opt"].step, cut["mu"], cut["nu"])
                run["loaded"] = {**{part: {p: t.clone() for p, t in flatten(tree).items()} for part, tree in cut.items()},
                                 "step": opt2.step.clone()}
                resumed, opt2, _ = step(tree_map(lambda t: t.clone(), cut["params"]), opt2, batches[1])
                run["resumed"] = _snapshot(resumed, opt2)
            res[name] = run
        out.append(res)
    return out


def smoke(arch: str, replace=None):
    """(cfg, the reference's cfg, the port's seed-0 parameters) of ``arch``'s
    smoke config in f32, with ``replace``'s fields."""
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro_torch import configs
    from repro_torch.models.transformer import build_model

    replace = replace or {}
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=torch.float32, **replace)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jnp.float32, **replace)
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, ref_cfg, build_model(cfg).init(gen)


def equal_trees(a: dict, b: dict) -> bool:
    """Whether two flat trees hold the same leaves bit for bit."""
    return a.keys() == b.keys() and all(torch.equal(a[p], b[p]) for p in a)


def plan_world(tmp_path_factory, shape, arch: str, replace: dict, plans_of, *, batch: int, seq: int) -> dict:
    """One spawned world of ``shape`` (``plan_rank``) for ``arch``'s smoke
    config with ``replace``, in f32 from the port's seed-0 parameters, on the
    first batch of ``make_batches(seed 0)`` of ``batch`` x ``seq``, under each
    plan of ``plans_of(cfg)``; and the reference's ``jax.value_and_grad`` on
    that batch: of ``model.loss`` on the plain step, of the microbatch mean
    in the stages."""
    import numpy as np

    from repro_torch import convert
    from repro_torch.data.pipeline import DataConfig, make_batches
    from torch_pipeline_helpers import jax_tree, reference_microbatch_mean, save_inputs, spawn
    from torch_tp_helpers import reference_value_and_grad

    tmp = tmp_path_factory.mktemp("stacked")
    cfg, ref_cfg, params = smoke(arch, replace)
    b = next(make_batches(cfg, DataConfig(seed=0, batch_size=batch, seq_len=seq)))
    ref_params = jax_tree(convert.to_reference(params))
    ref = (reference_microbatch_mean(ref_cfg, ref_params, b, shape[0], N_MICRO * shape[1]) if len(shape) == 3
           else reference_value_and_grad(ref_cfg, ref_params, b))
    del ref_params
    plans = plans_of(cfg)
    b = {k: torch.from_numpy(v) for k, v in b.items()}
    results = spawn(plan_rank, int(np.prod(shape)), tmp, tuple(shape),
                    [(cfg, save_inputs(tmp, params, [b])[0], b, plans)])
    return {"cfg": cfg, "params": params, "plans": plans, "ref": ref, "shape": tuple(shape),
            "results": [r[0] for r in results]}


def assembled_grads(case, name: str, boundary) -> dict:
    """The whole gradient (flat) of plan ``name``'s call for ``boundary``
    from the ranks: over ``data`` at each (stage, ``model`` index), then over
    ``model`` (``unshard``, each stage under its ``stage_plan``), then the
    stages in layer order."""
    from repro_torch.convert import flatten, unflatten
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.pipeline import assemble_params, stage_plan
    from repro_torch.parallel.sharding import unshard

    shape, cfg, plan = case["shape"], case["cfg"], case["plans"][name]
    staged = len(shape) == 3
    S, DP, TP = shape if staged else (1,) + tuple(shape)
    at = {(r["coords"].get("pod", 0), r["coords"]["data"], r["coords"]["model"]): r for r in case["results"]}
    stages = []
    for s in range(S):
        splan = stage_plan(plan, cfg, Mesh(shape, axes(shape)), s) if staged else plan
        shards = [unshard([unflatten(at[s, d, j][name]["calls"][boundary]["grads"]) for d in range(DP)], splan,
                          "data") for j in range(TP)]
        stages.append(unshard(shards, splan, "model"))
    return flatten(assemble_params(stages, cfg) if staged else stages[0])


def hold_reference(case, name: str, boundary, tol: float) -> None:
    """Every rank's loss, the whole gradient (``assembled_grads``) and its
    norm against the reference's at ``tol``: the loss relative and absolute,
    each leaf relative with atol = tol * max|ref leaf|."""
    import numpy as np

    ref_loss, ref_grads = case["ref"]
    for r in case["results"]:
        np.testing.assert_allclose(float(r[name]["calls"][boundary]["loss"]), ref_loss, rtol=tol, atol=tol)
    grads = assembled_grads(case, name, boundary)
    assert set(grads) == set(ref_grads)
    for p, g in grads.items():
        want = ref_grads[p]
        np.testing.assert_allclose(g.numpy(), want, rtol=tol, atol=tol * float(np.abs(want).max()), err_msg=p)
    norm = float(np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum() for g in ref_grads.values())))
    for r in case["results"]:
        np.testing.assert_allclose(float(r[name]["calls"][boundary]["grad_norm"]), norm, rtol=tol)


STATE_TOL = 1e-5  # a state against another run's: the clip's norm is summed in another order


def hold_ckpt(case) -> dict:
    """``ckpt_rank``'s results under the plans "fsdp" (saved, resumed) and
    "tp" (the same mesh without fsdp): every rank's state cut from the file is
    its live state after the first step bit for bit, the resumed step is the
    live second step bit for bit, and rank 0's gathered "fsdp" state (the
    file's) is the gathered "tp" state: bit for bit where every rank's blocks
    of the two runs are, else within STATE_TOL of the leaf's largest entry.
    Returns {part: (leaves bit-equal to the "tp" state, leaves)}."""
    from repro_torch.convert import flatten, unflatten
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import shard_params

    results, shape, cfg = case["results"], case["shape"], case["cfg"]
    for r in results:
        run = r["fsdp"]
        for part in ("params", "mu", "nu"):
            assert equal_trees(run["loaded"][part], run["one"][part]), (r["coords"], part)
            assert equal_trees(run["resumed"][part], run["live"][part]), (r["coords"], part)
        assert torch.equal(run["loaded"]["step"], run["one"]["step"])
    fstate, tstate = results[0]["fsdp"]["state"], results[0]["tp"]["state"]
    assert all(r[k]["state"] is None for r in results[1:] for k in ("fsdp", "tp"))
    counts = {}
    for part, f, t in (("params", fstate["params"], tstate["params"]), ("mu", fstate["opt"].mu, tstate["opt"].mu),
                       ("nu", fstate["opt"].nu, tstate["opt"].nu)):
        cuts = [flatten(shard_params(_base(cfg, Mesh(shape, axes(shape), rank), t), Mesh(shape, axes(shape), rank),
                                     case["plans"]["fsdp"])) for rank in range(len(results))]
        f, t = flatten(f), flatten(t)
        assert f.keys() == t.keys()
        equal = 0
        for p in f:
            if all(torch.equal(r["fsdp"]["one"][part][p], cut[p]) for r, cut in zip(results, cuts)):
                assert torch.equal(f[p], t[p]), (part, p)
                equal += 1
            else:
                gap = float((f[p] - t[p]).abs().max()) / max(float(t[p].abs().max()), 1e-30)
                assert gap <= STATE_TOL, (part, p, gap)
        counts[part] = (equal, len(f))
    return counts
