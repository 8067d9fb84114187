"""``data`` on a stacked axis on the plain step (ROADMAP 7f-iii): RWKV-6's
smoke and the pure Mamba2 stack's (zamba2 smoke with ``family="ssm"``) in f32
from the port's seed-0 parameters, on one (data, model) = (2, 2) world of
``gloo`` CPU ranks, under the plan with fsdp on at a threshold of 0.  There
the plan puts ``data`` on the layer axis of RWKV-6's ``w0`` (L, d) and of the
pure stack's ``norm_scale`` (L, d_inner), whose one feature dim ``model``
takes: a rank holds one of the two (four) layers of each, whole.  The leaf is
gathered whole once a step before the layers are taken apart
(``fsdp.gather_stack``) and its gradient reduce-scattered back onto the
rank's layers.

Each rank's loss and the gradient put together over ``data`` and ``model``
against ``jax.value_and_grad`` of the reference's ``model.loss`` at 2e-5; the
loss and every gradient block bit-equal to the same mesh's call under the
same plan without the stacked split (the leaf whole over ``data``), its block
cut from that call's; the ``data`` bytes what the code owes; and the
dry-run's count of the same call on ``meta`` each rank's transport bytes."""
import numpy as np
import pytest
import torch

from repro_torch.convert import flatten
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import local_block, shard_params
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_fsdp_helpers import AXES, assembled, data_bytes_owed, fsdp_plan
from torch_pipeline_helpers import jax_tree, save_inputs, spawn
from torch_stacked_helpers import PURE, meta_counts, plan_rank, smoke, stacked_paths, without
from torch_tp_helpers import reference_value_and_grad

TOL = 2e-5
BATCH, SEQ = 4, 16
SHAPE = (2, 2)
CASES = {"rwkv6_7b": ("rwkv6_7b", {}, ["layers/w0"]), "mamba2_pure": ("zamba2_2p7b", PURE, ["layers/mamba/norm_scale"])}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch import convert
    from repro_torch.data.pipeline import input_batch_for

    tmp = tmp_path_factory.mktemp("fsdp_stacked")
    cases, out = [], {}
    for i, (name, (arch, replace, _)) in enumerate(CASES.items()):
        cfg, ref_cfg, params = smoke(arch, replace)
        batch = input_batch_for(cfg, BATCH, SEQ)
        ref = reference_value_and_grad(ref_cfg, jax_tree(convert.to_reference(params)), batch)
        plan = fsdp_plan(cfg, SHAPE, 0)
        plans = {"split": plan, "unsplit": without(plan, "data")}
        sub = tmp / f"case{i}"
        sub.mkdir()
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        cases.append((cfg, save_inputs(sub, params, [batch])[0], batch, plans))
        out[name] = {"cfg": cfg, "params": params, "plans": plans, "ref": ref}
    results = spawn(plan_rank, int(np.prod(SHAPE)), tmp, SHAPE, cases)
    for i, name in enumerate(CASES):
        out[name]["results"] = [r[i] for r in results]
    return out


def _runs(case, name):
    return [{"coords": r["coords"], **r[name]["calls"][None]} for r in case["results"]]


@pytest.mark.parametrize("name", CASES)
def test_the_plan_splits_the_layer_axis_over_data(world, name):
    plan = world[name]["plans"]["split"]
    assert stacked_paths(plan, "data") == CASES[name][2]
    assert all(fsdp.data_dims(plan)[p] == 0 for p in CASES[name][2])
    assert stacked_paths(world[name]["plans"]["unsplit"], "data") == []
    for r in world[name]["results"]:
        for p in CASES[name][2]:
            whole = flatten(world[name]["params"])[p].shape
            assert r["split"]["shapes"][p] == (whole[0] // 2, whole[1] // 2)


@pytest.mark.parametrize("name", CASES)
def test_loss_and_gradients_match_the_reference(world, name):
    case = world[name]
    ref_loss, ref_grads = case["ref"]
    runs = _runs(case, "split")
    for r in runs:
        np.testing.assert_allclose(float(r["loss"]), ref_loss, rtol=TOL, atol=TOL)
    grads = assembled(runs, case["plans"]["split"])
    assert set(grads) == set(ref_grads)
    for p, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[p], rtol=TOL, atol=TOL * float(np.abs(ref_grads[p]).max()),
                                   err_msg=p)
    norm = float(torch.sqrt(sum(torch.from_numpy(np.asarray(g, np.float64)).square().sum() for g in ref_grads.values())))
    for r in runs:
        np.testing.assert_allclose(float(r["grad_norm"]), norm, rtol=TOL)


@pytest.mark.parametrize("name", CASES)
def test_bit_equal_to_the_call_without_the_stacked_split(world, name):
    """The stacked leaf's gradient block is the rank's rows of the unsplit
    call's, which ``data`` all-reduced whole; every other block and the loss
    are the same bits, and the norm within 1e-6 (its squares summed in
    another order)."""
    case = world[name]
    for rank, r in enumerate(case["results"]):
        got, want = r["split"]["calls"][None], r["unsplit"]["calls"][None]
        assert torch.equal(got["loss"], want["loss"])
        mesh = Mesh(SHAPE, AXES, rank)
        specs = flatten(case["plans"]["split"])
        for p, g in got["grads"].items():
            w = want["grads"][p]
            if p in CASES[name][2]:
                w = local_block(w, (specs[p][0], None), mesh)
            assert torch.equal(g, w), (r["coords"], p)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_the_data_bytes_are_what_the_code_owes(world, name):
    case = world[name]
    cfg, plan = case["cfg"], case["plans"]["split"]
    for rank, r in enumerate(case["results"]):
        blocks = flatten(shard_params(case["params"], Mesh(SHAPE, AXES, rank), plan))
        want = data_bytes_owed(cfg, plan, SHAPE, blocks, {"tokens": None})
        assert r["split"]["calls"][None]["bytes"]["data"] == want, rank


@pytest.mark.parametrize("name", CASES)
def test_the_dry_run_counts_each_rank_s_bytes_on_meta(world, name):
    case = world[name]
    for rank, r in enumerate(case["results"]):
        for which in ("split", "unsplit"):
            got = meta_counts(case["cfg"], SHAPE, case["plans"][which], (BATCH, SEQ), rank)
            assert got == r[which]["calls"][None]["bytes"], (rank, which)
