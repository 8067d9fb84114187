"""``model`` on the hybrid's M inside the pipeline's stages (ROADMAP 7b-vi
with 7b-iv): the smoke Zamba2 hybrid with three layers a group
(``num_layers=6, attn_period=3``: G = 2 groups of M = 2 Mamba2 layers) in f32
from the port's seed-0 parameters, on a (pod, data, model) = (2, 1, 2) mesh of
``gloo`` CPU ranks: a stage holds one group, and each rank one of its two
Mamba2 layers of ``w_out`` and ``norm_scale``, which the plan splits on M.
The stages cut G, not M, so no second cut arises; each group gathers its M
slices inside its remat, as on the plain step.

For both boundaries the loss and the gradient put together over ``model``
and ``pod`` against ``jax.value_and_grad`` of the reference's microbatch
mean at 2e-5; the loss and every gradient block bit-equal to the same mesh's
call under the plan without the split on M; the dry-run's count of each
rank's call on ``meta`` its transport bytes."""
import numpy as np
import pytest
import torch

from repro_torch.convert import flatten
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import local_block
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_stacked_helpers import (BOUNDARIES, HYBRID_M2, axes, hold_reference, meta_counts, plan_world,
                                   stacked_paths, without)

TOL = 2e-5
SHAPE = (2, 1, 2)
BATCH, SEQ = 8, 32
SPLIT_ON_M = ["groups/mamba/mamba/norm_scale", "groups/mamba/mamba/w_out"]


def _plans(cfg):
    plan = tp.model_plan(cfg, Mesh(SHAPE, axes(SHAPE)))
    return {"split": plan, "unsplit": without(plan, "model")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return plan_world(tmp_path_factory, SHAPE, "zamba2_2p7b", HYBRID_M2, _plans, batch=BATCH, seq=SEQ)


def test_each_rank_holds_one_mamba2_layer_of_its_group_s_split_leaves(world):
    assert stacked_paths(world["plans"]["split"], "model") == SPLIT_ON_M
    for r in world["results"]:
        assert r["split"]["shapes"]["groups/mamba/mamba/w_out"][:2] == (1, 1)
        assert r["split"]["shapes"]["groups/mamba/mamba/norm_scale"][:2] == (1, 1)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_loss_and_gradients_match_the_reference(world, boundary):
    hold_reference(world, "split", boundary, TOL)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_bit_equal_to_the_call_without_the_split_on_m(world, boundary):
    specs = flatten(world["plans"]["split"])
    for rank, r in enumerate(world["results"]):
        got, want = r["split"]["calls"][boundary], r["unsplit"]["calls"][boundary]
        assert torch.equal(got["loss"], want["loss"])
        mesh = Mesh(SHAPE, axes(SHAPE), rank)
        for p, g in got["grads"].items():
            w = local_block(want["grads"][p], specs[p], mesh) if p in SPLIT_ON_M else want["grads"][p]
            assert torch.equal(g, w), (rank, boundary, p)
        np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]), rtol=1e-6)


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_the_dry_run_counts_each_rank_s_bytes_on_meta(world, boundary):
    for rank, r in enumerate(world["results"]):
        for name, plan in world["plans"].items():
            got = meta_counts(world["cfg"], SHAPE, plan, (BATCH, SEQ), rank, boundary=boundary)
            assert got == r[name]["calls"][boundary]["bytes"], (rank, name)
