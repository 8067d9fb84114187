"""Helpers of the tests of FSDP over ``data`` inside the pipeline's stages
(``tests/test_torch_pipeline_fsdp*.py``, ROADMAP 7f-ii).

``run`` spawns one ``gloo`` world of CPU ranks on a (pod, data, model) mesh
for one or more smoke configs in f32 from the port's seed-0 parameters.  On
each rank (``fsdp_rank``), for each config: the pipelined call without FSDP
on the same mesh (its stage, cut to its ``model`` shards where the mesh's
plan splits, as the launcher runs it), the control; then, for each threshold
of the plan with fsdp on (``model_plan(fsdp=True, min_bytes=)``), the rank's
``data`` blocks of that stage and one call for each boundary, and one at a
second ``n_micro``; optionally two trained steps of each.  The checks: the
loss and the gradients, put together over ``data``, ``model`` and ``pod``,
against ``jax.value_and_grad`` of the reference's microbatch mean at f32
2e-5; bit-equal to the control; the ``data`` bytes from the code and the same
at both ``n_micro``; ``grad_norm`` the whole gradient's; the trained state
within 1e-5 of the control's.  This module imports no JAX at its top."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torch_pipeline_helpers import AXES, _flat, jax_tree, reference_microbatch_mean, save_inputs, spawn

REF_TOL = 2e-5  # the pipelined f32 tests' bound against the reference (test_torch_pipeline_dense.py)
STATE_TOL = 1e-5  # two steps against the control's: the clip's norm is summed in another order
N_MICRO, N_MICRO_2, BATCH, SEQ, LR = 4, 2, 8, 32, 3e-3
BOUNDARIES = ("direct", "striped")


def _state(params, opt) -> dict:
    return {"params": {k: v.detach() for k, v in _flat(params).items()}, "mu": _flat(opt.mu), "nu": _flat(opt.nu)}


def _train(cfg, mesh, plan, params, batches, steps: int, gather: bool = False) -> dict:
    """``steps`` steps of ``make_train_step`` over the pipelined loss under
    ``plan``, from copies of ``params`` (the whole leaves are shared with the
    control's tree, and the step writes in place): losses, norms, the state,
    and with ``gather`` the state through ``gather_train_state``."""
    from repro_torch.convert import tree_map
    from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state, make_train_step
    from repro_torch.parallel.pipeline import gather_train_state, make_pipeline_loss

    params = tree_map(lambda t: t.detach().clone(), params)
    loss_fn = make_pipeline_loss(cfg, mesh, n_micro=N_MICRO, boundary=BOUNDARIES[-1], plan=plan)
    step = make_train_step(loss_fn, OptimizerConfig(peak_lr=LR, warmup_steps=1, total_steps=steps))
    opt, losses = init_opt_state(params), []
    for b in batches[:steps]:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    out = {"losses": losses, **_state(params, opt), "bytes": loss_fn.transport.counts()}
    if gather:
        out["gathered"] = gather_train_state(params, opt, cfg, mesh, plan=plan)
    return out


def _call(cfg, mesh, plan, params, batch, boundary: str, n_micro: int) -> dict:
    from repro_torch.parallel.pipeline import make_pipeline_loss

    loss_fn = make_pipeline_loss(cfg, mesh, n_micro=n_micro, boundary=boundary, plan=plan)
    loss, grads = loss_fn(params, batch)
    return {"loss": loss, "grads": {p: g.detach() for p, g in grads.items()}, "grad_norm": loss_fn.grad_norm(grads),
            "bytes": loss_fn.transport.counts()}


def fsdp_rank(rank: int, shape, cases, train_steps: int, gather: bool = False) -> list:
    """This rank of (pod, data, model) = ``shape``, for each (cfg, params
    path, batches path, thresholds) of ``cases``: the control's call for each
    boundary, and for each threshold the FSDP calls (each boundary at
    N_MICRO, the first at N_MICRO_2 too), this rank's block shapes, and with
    ``train_steps`` both trained runs; with ``gather`` also each FSDP run's
    trained state through ``gather_train_state`` (the whole state on rank 0,
    None elsewhere)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import stage_params
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.tensor_parallel import model_plan

    mesh = make_mesh(shape, AXES)
    out = []
    for cfg, params_path, batches_path, thresholds in cases:
        stage = stage_params(torch.load(params_path), cfg, mesh)
        batches = torch.load(batches_path)
        plan = model_plan(cfg, mesh)
        base = stage if plan is None else shard_params(stage, mesh, plan)
        res = {"coords": mesh.coords, "control": {b: _call(cfg, mesh, plan, base, batches[0], b, N_MICRO)
                                                  for b in BOUNDARIES}, "fsdp": {}}
        if train_steps:
            res["control_train"] = _train(cfg, mesh, plan, base, batches, train_steps)
        for min_bytes in thresholds:
            fplan = model_plan(cfg, mesh, fsdp=True, min_bytes=min_bytes)
            blocks = shard_params(stage, mesh, fplan)
            run = {"shapes": {p: tuple(t.shape) for p, t in _flat(blocks).items()},
                   "calls": {(b, N_MICRO): _call(cfg, mesh, fplan, blocks, batches[0], b, N_MICRO) for b in BOUNDARIES}}
            run["calls"][BOUNDARIES[0], N_MICRO_2] = _call(cfg, mesh, fplan, blocks, batches[0], BOUNDARIES[0], N_MICRO_2)
            if train_steps:
                run["train"] = _train(cfg, mesh, fplan, blocks, batches, train_steps, gather)
                run["gathered"] = run["train"].pop("gathered", None)
            res["fsdp"][min_bytes] = run
        out.append(res)
    return out


def smoke(arch: str, replace=None, experts=None):
    """(cfg, the reference's cfg, the port's seed-0 parameters) of ``arch``'s
    smoke config in f32 (with ``replace``'s fields and ``experts`` routed
    experts where given)."""
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro_torch import configs
    from repro_torch.models.transformer import build_model

    replace = replace or {}
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=torch.float32, **replace)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jnp.float32, **replace)
    if experts is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=experts))
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, num_experts=experts))
    gen = torch.Generator()
    gen.manual_seed(0)
    return cfg, ref_cfg, build_model(cfg).init(gen)


def run(tmp_path_factory, shape, configs, train_steps: int = 0, gather: bool = False) -> dict:
    """One spawned world of ``shape`` for ``configs`` ({name: (cfg, ref_cfg,
    params, thresholds)}), batches of ``make_batches(seed 0)``: by name, the
    config, its parameters and batches, the ranks' results, the thresholds
    and the reference's microbatch mean on the first batch."""
    from repro_torch import convert
    from repro_torch.data.pipeline import DataConfig, make_batches

    tmp = tmp_path_factory.mktemp("pipeline_fsdp")
    cases, out = [], {}
    for i, (name, (cfg, ref_cfg, params, thresholds)) in enumerate(configs.items()):
        it = make_batches(cfg, DataConfig(seed=0, batch_size=BATCH, seq_len=SEQ), num_steps=max(train_steps, 1))
        batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in it]
        # the reference first: params is not handed to spawn (its files are), so nothing moves under it
        ref = reference_microbatch_mean(ref_cfg, jax_tree(convert.to_reference(params)),
                                        {k: v.numpy() for k, v in batches[0].items()}, shape[0], N_MICRO * shape[1])
        sub = tmp / f"case{i}"
        sub.mkdir()
        cases.append((cfg, *save_inputs(sub, params, batches), tuple(thresholds)))
        out[name] = {"cfg": cfg, "params": params, "batches": batches, "thresholds": tuple(thresholds), "ref": ref,
                     "shape": tuple(shape)}
    results = spawn(fsdp_rank, int(np.prod(shape)), tmp, tuple(shape), cases, train_steps, gather)
    for i, name in enumerate(configs):
        out[name]["results"] = [r[i] for r in results]
    return out


def _plans(case, min_bytes):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.tensor_parallel import model_plan

    mesh = Mesh(case["shape"], AXES)
    return model_plan(case["cfg"], mesh), model_plan(case["cfg"], mesh, fsdp=True, min_bytes=min_bytes)


def stage_fplan(case, fplan, stage: int):
    """Stage ``stage``'s plan under the whole model's ``fplan``
    (``pipeline.stage_plan``: a stacked leaf split over ``data`` on its layer
    axis stays whole in a stage whose rows ``data`` does not divide)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.pipeline import stage_plan

    return stage_plan(fplan, case["cfg"], Mesh(case["shape"], AXES), stage)


def assembled(case, fplan, part) -> dict:
    """The whole model's tree (flat) from every rank's blocks ``part(rank's
    result)``: over ``data`` at each (stage, ``model`` index), then over
    ``model`` (``unshard``), then the stages in layer order."""
    from repro_torch.convert import unflatten
    from repro_torch.parallel.pipeline import assemble_params
    from repro_torch.parallel.sharding import unshard

    S, DP, TP = case["shape"]
    at = {(r["coords"]["pod"], r["coords"]["data"], r["coords"]["model"]): r for r in case["results"]}
    stages = []
    for s in range(S):
        splan = stage_fplan(case, fplan, s)
        shards = [unshard([unflatten(part(at[s, d, j])) for d in range(DP)], splan, "data") for j in range(TP)]
        stages.append(unshard(shards, splan, "model"))
    return _flat(assemble_params(stages, case["cfg"]))


def hold_reference(case, min_bytes, boundary: str) -> None:
    """Every rank's loss, and the whole gradient put together from the
    blocks, against the reference's (value, flat gradients) at REF_TOL: the
    loss relative and absolute, each leaf relative with atol = REF_TOL *
    max|ref leaf|; and ``grad_norm`` on every rank the whole gradient's."""
    _, fplan = _plans(case, min_bytes)
    ref_loss, ref_grads = case["ref"]
    for r in case["results"]:
        np.testing.assert_allclose(float(r["fsdp"][min_bytes]["calls"][boundary, N_MICRO]["loss"]), ref_loss,
                                   rtol=REF_TOL, atol=REF_TOL)
    grads = assembled(case, fplan, lambda r: r["fsdp"][min_bytes]["calls"][boundary, N_MICRO]["grads"])
    assert set(grads) == set(ref_grads)
    for path, g in grads.items():
        want = ref_grads[path]
        np.testing.assert_allclose(g.numpy(), want, rtol=REF_TOL, atol=REF_TOL * float(np.abs(want).max()),
                                   err_msg=path)
    norm = float(torch.sqrt(sum(g.double().square().sum() for g in grads.values())))
    for r in case["results"]:
        np.testing.assert_allclose(float(r["fsdp"][min_bytes]["calls"][boundary, N_MICRO]["grad_norm"]), norm,
                                   rtol=1e-6)


def data_blocks(case, tree: dict, fplan, coords: dict) -> dict:
    """A control's flat tree (a rank's stage, or its ``model`` shards of it)
    cut to the rank's ``data`` blocks under its stage's plan of ``fplan``."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.sharding import P, local_block

    shape = case["shape"]
    mesh = Mesh(shape, AXES, Mesh(shape, AXES).rank_at(**coords))
    specs = _flat(stage_fplan(case, fplan, coords["pod"]))
    return {p: local_block(t, P(*(e if e == "data" else None for e in specs[p])), mesh) for p, t in tree.items()}


def hold_bit_equal(case, min_bytes) -> None:
    """Each rank's FSDP loss and gradient blocks, for each boundary, bit-equal
    to the control's call on the same mesh cut to the same blocks; its
    ``grad_norm`` within 1e-6 of the control's (summed in another order)."""
    _, fplan = _plans(case, min_bytes)
    for r in case["results"]:
        for b in BOUNDARIES:
            got, want = r["fsdp"][min_bytes]["calls"][b, N_MICRO], r["control"][b]
            assert torch.equal(got["loss"], want["loss"]), (r["coords"], b)
            cut = data_blocks(case, want["grads"], fplan, r["coords"])
            assert got["grads"].keys() == cut.keys()
            for p, g in got["grads"].items():
                assert torch.equal(g, cut[p]), (r["coords"], b, p)
            np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-6)


def data_bytes_owed(case, min_bytes, r) -> dict:
    """What one FSDP call and its ``grad_norm`` put on ``data`` from rank
    ``r``, in f32, from the code: each data-split block gathered once (its
    bytes) and its whole gradient reduce-scattered once (DP x its bytes),
    whatever ``n_micro``; the leaves whole over ``data`` all-reduced with the
    loss (4 B), and where the plan splits any leaf the norm's four sums of
    squares (16 B)."""
    from repro_torch.parallel import fsdp

    DP = case["shape"][1]
    split = fsdp.data_dims(stage_fplan(case, _plans(case, min_bytes)[1], r["coords"]["pod"]))
    blocks = {p: int(np.prod(s)) for p, s in r["fsdp"][min_bytes]["shapes"].items()}
    gathered = 4 * sum(n for p, n in blocks.items() if p in split)
    whole = 4 * sum(n for p, n in blocks.items() if p not in split)
    return {"send": 0, "all_reduce": whole + 4 + (16 if split else 0), "all_gather": gathered,
            "reduce_scatter": DP * gathered}


def hold_bytes(case, min_bytes) -> None:
    """The ``data`` bytes of each FSDP call are what the code owes, the same
    at N_MICRO and N_MICRO_2 (once a step); ``pod`` all-reduces the blocks of
    ``rest`` with the loss and the layers' squares, and sends what the
    control sends; ``model`` carries what the control's carries."""
    from repro_torch.models.transformer import build_pipeline_parts

    key = build_pipeline_parts(case["cfg"]).layer_key + "/"
    for r in case["results"]:
        run = r["fsdp"][min_bytes]
        owed = data_bytes_owed(case, min_bytes, r)
        assert (owed["all_gather"] > 0) == (owed["reduce_scatter"] > 0) == any(
            "data" in spec for spec in _flat(stage_fplan(case, _plans(case, min_bytes)[1], r["coords"]["pod"])).values())
        rest = 4 * sum(int(np.prod(s)) for p, s in run["shapes"].items() if not p.startswith(key))
        for (b, n), call in run["calls"].items():
            control = r["control"][b]["bytes"]
            assert call["bytes"]["data"] == owed, (r["coords"], b, n, call["bytes"]["data"], owed)
            pod = dict(control["pod"], all_reduce=rest + 8)
            if n == N_MICRO:
                assert call["bytes"]["pod"] == pod and call["bytes"]["model"] == control["model"], (r["coords"], b)
        assert run["calls"][BOUNDARIES[0], N_MICRO]["bytes"]["data"] == run["calls"][BOUNDARIES[0], N_MICRO_2]["bytes"]["data"]


def hold_meta(case, min_bytes) -> None:
    """The dry-run's count of each rank's FSDP call and its ``grad_norm`` on
    ``meta`` (``MetaTransport``), for each boundary, is the rank's transport
    bytes on every axis."""
    from torch_stacked_helpers import meta_counts

    fplan = _plans(case, min_bytes)[1]
    for rank, r in enumerate(case["results"]):
        for b in BOUNDARIES:
            got = meta_counts(case["cfg"], case["shape"], fplan, (BATCH, SEQ), rank, boundary=b)
            assert got == r["fsdp"][min_bytes]["calls"][b, N_MICRO]["bytes"], (r["coords"], b)


def split_over_data(case, min_bytes) -> list:
    """The leaves the plan with fsdp on at ``min_bytes`` splits over ``data``."""
    from repro_torch.parallel import fsdp

    return sorted(fsdp.data_dims(_plans(case, min_bytes)[1]))


def hold_train(case, min_bytes) -> None:
    """Two FSDP steps against the control's two: the losses within 1e-6
    relative, each leaf of the rank's final blocks and moments within
    STATE_TOL of the control's cut to them (max |diff| over max |control|),
    every block and moment of its block's shape."""
    _, fplan = _plans(case, min_bytes)
    for r in case["results"]:
        got, want = r["fsdp"][min_bytes]["train"], r["control_train"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for part in ("params", "mu", "nu"):
            cut = data_blocks(case, want[part], fplan, r["coords"])
            for p, t in got[part].items():
                assert tuple(t.shape) == r["fsdp"][min_bytes]["shapes"][p]
                gap = float((t - cut[p]).abs().max()) / max(float(cut[p].abs().max()), 1e-30)
                assert gap <= STATE_TOL, (r["coords"], part, p, gap)


def hold_all(case, min_bytes) -> None:
    for b in BOUNDARIES:
        hold_reference(case, min_bytes, b)
    hold_bit_equal(case, min_bytes)
    hold_bytes(case, min_bytes)

