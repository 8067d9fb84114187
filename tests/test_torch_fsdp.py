"""FSDP over ``data`` on the plain step (ROADMAP 7f): the plan, its cuts, the
gather on use, and gpt_a on a (data, model) = (2, 1) world of ``gloo`` ranks
on the CPU.

The plan with fsdp on is the reference's (``make_param_shardings(fsdp=True)``
through ``_add_fsdp_axis``), at its 4 MiB threshold and at 0, where every leaf
with a dim that ``data`` divides is split: leaf for leaf against the
reference's plan over an abstract mesh (its ``_add_fsdp_axis`` given the same
threshold), each rank's blocks (``shard_params``) of the reference's
``NamedSharding(mesh, spec).shard_shape``, and ``unshard`` over ``data`` then
``model`` giving the whole tree back bit for bit.  The gather's forward is the
whole leaf and its backward this rank's block of the gradient summed over
``data``, a stacked leaf's taken a layer at a time.  gpt_a's smoke config in
f32 on (2, 1) with every leaf it can split: the loss within 1e-5 and each
gradient leaf within 1e-4 in norm of ``jax.value_and_grad`` of the
reference's ``model.loss``, and the ``data`` bytes by op exactly what the
code owes.  ``data`` on a stacked axis (7f-iii), once refused, is planned;
the pure Mamba2 stack with ``model`` > 1, once refused, gets its plan."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as ref_configs
from repro.models.transformer import build_model as ref_build_model
from repro.parallel import sharding as ref_sharding
from repro_torch import configs
from repro_torch.convert import expected_shapes, flatten, unflatten
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import build_model
from repro_torch.parallel import fsdp
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import FSDP_MIN_BYTES, make_param_shardings, shard_params, unshard
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_fsdp_helpers import AXES, assembled, data_bytes_owed, fsdp_plan, world_rank
from torch_pipeline_helpers import smoke_case, spawn
from torch_tp_helpers import close_in_norm, reference_value_and_grad

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BATCH, SEQ = 4, 16
SHAPE = (2, 1)
ARCHS = ["gpt_a", "deepseek_v2_lite_16b", "qwen2_moe_a2p7b", "rwkv6_7b", "zamba2_2p7b", "hubert_xlarge"]


def _ref_plan(arch: str, shape, min_bytes: int) -> dict:
    ref_shapes = jax.eval_shape(ref_build_model(ref_configs.get_smoke_config(arch)).init, jax.random.PRNGKey(0))
    patched = functools.partial(ref_sharding._add_fsdp_axis, min_bytes=min_bytes)
    old, ref_sharding._add_fsdp_axis = ref_sharding._add_fsdp_axis, patched
    try:
        whole = ref_sharding.make_param_shardings(ref_shapes, AbstractMesh(shape, AXES), fsdp=True)
    finally:
        ref_sharding._add_fsdp_axis = old
    return {"/".join(p.key for p in path): s for path, s in jax.tree_util.tree_flatten_with_path(whole)[0]}


@pytest.mark.parametrize("min_bytes", [0, FSDP_MIN_BYTES], ids=["all", "4MiB"])
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_blocks_are_the_reference_s_shard_shapes_and_unshard_back(arch, shape, min_bytes):
    cfg = configs.get_smoke_config(arch)
    plan = make_param_shardings(unflatten(expected_shapes(cfg)), Mesh(shape, AXES), fsdp=True, min_bytes=min_bytes)
    ref = _ref_plan(arch, shape, min_bytes)
    assert set(flatten(plan)) == set(ref)
    for path, spec in flatten(plan).items():
        assert tuple(spec) == tuple(ref[path].spec), path
    gen = torch.Generator()
    gen.manual_seed(0)
    whole = flatten(build_model(cfg).init(gen))
    ranks = [flatten(shard_params(unflatten(whole), Mesh(shape, AXES, r), plan)) for r in range(int(np.prod(shape)))]
    for path, spec in flatten(plan).items():
        want = NamedSharding(AbstractMesh(shape, AXES), JP(*spec)).shard_shape(tuple(whole[path].shape))
        assert all(tuple(r[path].shape) == want for r in ranks), path
    if min_bytes == 0:
        assert any(tp.is_split(spec, "data") for spec in flatten(plan).values())
    coords = [Mesh(shape, AXES, r).coords for r in range(len(ranks))]
    by_model = [unshard([unflatten(ranks[r]) for r in range(len(ranks)) if coords[r]["model"] == m], plan, "data")
                for m in range(shape[1])]
    back = flatten(unshard(by_model, plan, "model"))
    for path, t in whole.items():
        assert torch.equal(back[path], t), path


def test_the_plan_refuses_data_on_a_stacked_axis_and_the_pure_stack_split_over_model():
    """Once a refusal, now the plan that runs (7f-iii): rwkv6's smoke ``w0``
    (L, d), split on d over ``model``, has only its layer axis left for
    ``data`` at a threshold of 0, and the plan puts it there (its parity is
    ``test_torch_fsdp_stacked.py``'s); the pure Mamba2 stack's ``norm_scale``
    (L, d_inner) likewise.  One byte over that leaf, the fsdp plan on (2, 2)
    holds it whole over ``data``: ``model`` on d_inner (``w_z``, ``w_x``,
    ``conv_x``, ``norm_scale``) and on ``w_out``'s rows, ``data`` on another
    dim of the leaves it divides, the leaves the heads share whole over
    ``model``.  At the reference's 4 MiB every full config has a plan on
    (16, 16) and (2, 1), and none splits a layer axis over ``data``."""
    rwkv = configs.get_smoke_config("rwkv6_7b")
    assert tuple(flatten(fsdp_plan(rwkv, (2, 2), 0))["layers/w0"]) == ("data", "model")
    pure = dataclasses.replace(configs.get_smoke_config("zamba2_2p7b"), family="ssm")
    assert tuple(flatten(fsdp_plan(pure, (2, 2), 0))["layers/mamba/norm_scale"]) == ("data", "model")
    d_in = pure.d_model * pure.ssm.expand
    plan = flatten(fsdp_plan(pure, (2, 2), 4 * pure.num_layers * d_in + 1))
    assert tuple(plan["layers/mamba/w_z"]) == (None, "data", "model")
    assert tuple(plan["layers/mamba/w_out"]) == (None, "model", "data")
    assert tuple(plan["layers/mamba/norm_scale"]) == (None, "model")
    assert not any(tp.is_split(plan[f"layers/mamba/{n}"]) for n in ("w_bc", "w_dt", "conv_bc", "A_log", "D", "dt_bias"))
    for arch in configs.ARCHS[:10]:
        cfg = configs.get_config(arch)
        for shape in ((16, 16), (2, 1)):
            full = tp.model_plan(cfg, Mesh(shape, AXES), fsdp=True)
            assert full is not None, (arch, shape)
            assert not any(fsdp.data_dims(full).get(p) == 0 for p in flatten(full) if p.split("/")[0] in
                           ("layers", "groups")), (arch, shape)


def test_the_fsdp_plan_on_a_data_only_mesh():
    """On (2, 1) there is no plan without fsdp, and the fsdp plan splits
    over ``data`` (``data_dims``: the FFN's ``w_up`` on d, the embedding on its
    vocabulary rows, the norms whole)."""
    cfg = configs.get_smoke_config("gpt_a")
    plan = fsdp_plan(cfg, (2, 1), 0)
    assert tp.model_plan(cfg, Mesh((2, 1), AXES)) is None and tp.split_paths(plan, "data")
    dims = fsdp.data_dims(plan)
    assert dims["layers/ffn/w_up"] == 1 and dims["embed"] == 0 and "final_norm" not in dims


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg, ref_cfg, params, ref_params, batch = smoke_case("gpt_a", {}, BATCH, SEQ)
    ref = reference_value_and_grad(ref_cfg, ref_params, batch)
    del ref_params
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    results = spawn(world_rank, int(np.prod(SHAPE)), tmp_path_factory.mktemp("fsdp21"), SHAPE,
                    [(cfg, params, tb, 0)], None, True)
    return {"cfg": cfg, "params": params, "batch": batch, "ref": ref, "results": results}


def test_the_gather_is_the_whole_leaf_and_its_backward_the_summed_block(world):
    whole, stacked = torch.arange(24.0).reshape(4, 6), torch.arange(48.0).reshape(2, 4, 6)
    summed = 3 * torch.arange(24.0).reshape(4, 6)  # rank 0's ramp and rank 1's twice it
    for rank, r in enumerate(w["gather"] for w in world["results"]):
        assert r["unchanged"]
        assert torch.equal(r["got"], whole) and all(torch.equal(a, b) for a, b in zip(r["layers"], stacked))
        assert torch.equal(r["grad"], summed[:, 3 * rank:3 * rank + 3])
        assert torch.equal(r["stacked_grad"], torch.stack([summed[2 * rank:2 * rank + 2]] * 2))
        assert r["bytes"]["data"] == {"send": 0, "all_reduce": 0, "all_gather": 4 * (12 + 2 * 12),
                                      "reduce_scatter": 4 * (24 + 2 * 24)}


def test_gpt_a_on_2x1_is_the_reference_s_loss_and_gradients(world):
    cfg, (ref_loss, ref_grads) = world["cfg"], world["ref"]
    plan = fsdp_plan(cfg, SHAPE, 0)
    runs = [r["cases"][0] for r in world["results"]]
    for r in runs:
        np.testing.assert_allclose(float(r["loss"]), ref_loss, rtol=LOSS_TOL)
    close_in_norm(assembled(runs, plan), ref_grads, GRAD_TOL)
    whole = {p: torch.from_numpy(np.array(g, dtype=np.float32)) for p, g in ref_grads.items()}
    norm = float(torch.sqrt(sum(g.square().sum() for g in whole.values())))
    blocks = flatten(shard_params(world["params"], Mesh(SHAPE, AXES), plan))
    want = data_bytes_owed(cfg, plan, SHAPE, blocks, world["batch"])
    for r in runs:
        np.testing.assert_allclose(float(r["grad_norm"]), norm, rtol=GRAD_TOL)
        assert r["bytes"]["data"] == want, (r["coords"], r["bytes"]["data"], want)
    assert runs[0]["bytes"]["model"] == dict.fromkeys(runs[0]["bytes"]["model"], 0)
