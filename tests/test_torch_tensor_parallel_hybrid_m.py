"""``model`` on the hybrid's M on the plain step (ROADMAP 7b-vi): the smoke
Zamba2 hybrid with three layers a group (``num_layers=6, attn_period=3``:
G = 2 groups of M = 2 Mamba2 layers) in f32 from the port's seed-0
parameters, on a (data, model) = (1, 2) world of ``gloo`` CPU ranks.  The
plan puts the ``model`` entry of ``w_out`` (G, M, d_inner, d) and
``norm_scale`` (G, M, d_inner) on M, a stacked axis: a rank holds one of a
group's two Mamba2 layers of each.  Every rank computes every Mamba2 layer
(``w_z`` and ``w_x`` are split on d and reduced, so ``w_out``'s input is
whole), and a group gathers its M slices inside its remat
(``tensor_parallel.gather_stacked``).

The loss and the gradient put together over ``model`` against
``jax.value_and_grad`` of the reference's ``model.loss`` at 2e-5; the loss
and every gradient block bit-equal to the same mesh's call under the plan
without the split on M (those two leaves whole), each block cut from that
call's; the dry-run's count of the call on ``meta`` each rank's transport
bytes."""
import numpy as np
import pytest
import torch

from repro_torch.convert import flatten
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import local_block
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_stacked_helpers import HYBRID_M2, axes, hold_reference, meta_counts, plan_world, stacked_paths, without

TOL = 2e-5
SHAPE = (1, 2)
BATCH, SEQ = 4, 32
SPLIT_ON_M = ["groups/mamba/mamba/norm_scale", "groups/mamba/mamba/w_out"]


def _plans(cfg):
    plan = tp.model_plan(cfg, Mesh(SHAPE, axes(SHAPE)))
    return {"split": plan, "unsplit": without(plan, "model")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return plan_world(tmp_path_factory, SHAPE, "zamba2_2p7b", HYBRID_M2, _plans, batch=BATCH, seq=SEQ)


def test_the_plan_splits_m_over_model(world):
    plans = world["plans"]
    assert stacked_paths(plans["split"], "model") == SPLIT_ON_M
    assert tp.stacked_dims(plans["split"]) == {"w_out": 1, "norm_scale": 1}
    assert tp.split_dims(plans["split"]) == tp.split_dims(plans["unsplit"])
    assert stacked_paths(plans["unsplit"], "model") == []
    for r in world["results"]:
        assert r["split"]["shapes"]["groups/mamba/mamba/w_out"][:2] == (2, 1)
        assert r["unsplit"]["shapes"]["groups/mamba/mamba/w_out"][:2] == (2, 2)


def test_loss_and_gradients_match_the_reference(world):
    hold_reference(world, "split", None, TOL)


def test_bit_equal_to_the_call_without_the_split_on_m(world):
    specs = flatten(world["plans"]["split"])
    for rank, r in enumerate(world["results"]):
        got, want = r["split"]["calls"][None], r["unsplit"]["calls"][None]
        assert torch.equal(got["loss"], want["loss"])
        mesh = Mesh(SHAPE, axes(SHAPE), rank)
        for p, g in got["grads"].items():
            w = local_block(want["grads"][p], specs[p], mesh) if p in SPLIT_ON_M else want["grads"][p]
            assert torch.equal(g, w), (rank, p)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-6)


def test_the_dry_run_counts_each_rank_s_bytes_on_meta(world):
    for rank, r in enumerate(world["results"]):
        for name, plan in world["plans"].items():
            assert meta_counts(world["cfg"], SHAPE, plan, (BATCH, SEQ), rank) == r[name]["calls"][None]["bytes"]
