"""``data`` on a stacked axis inside the pipeline's stages with tensor
parallelism over ``model`` (ROADMAP 7f-iii with 7f-ii and 7b-v): the pure
Mamba2 stack (zamba2 smoke with ``family="ssm"``, four layers) in f32 from
the port's seed-0 parameters on a (pod, data, model) = (2, 2, 2) mesh of
``gloo`` CPU ranks (``torch_pipeline_fsdp_helpers``), under the plan with
fsdp on at a threshold of 0.  ``model`` splits the stack by heads, so
``norm_scale`` (L, d_inner) has only its layer axis left for ``data``; each
stage's two rows split over ``data`` (``pipeline.stage_plan``), and a rank
holds one row of its ``model`` half, gathered with the stage's other
data-split leaves once a step before the first microbatch.
For both boundaries the loss and every gradient, put together over
``data``, ``model`` and ``pod``, against ``jax.value_and_grad`` of the
reference's microbatch mean at 2e-5; bit-equal to the call without FSDP on
the same mesh; the ``data`` bytes as the code owes them, the same at n_micro
2 and 4; the dry-run's count on ``meta`` each rank's bytes."""
import pytest

from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_fsdp_helpers import hold_bit_equal, hold_bytes, hold_meta, hold_reference, run, smoke
from torch_stacked_helpers import PURE

SHAPE = (2, 2, 2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run(tmp_path_factory, SHAPE, {"ssm": (*smoke("zamba2_2p7b", PURE), (0,))})["ssm"]


@pytest.mark.parametrize("boundary", ["direct", "striped"])
def test_loss_and_gradients_match_the_reference(world, boundary):
    hold_reference(world, 0, boundary)


def test_bit_equal_to_the_call_without_fsdp(world):
    hold_bit_equal(world, 0)


def test_data_bytes_are_the_code_s_once_a_step(world):
    hold_bytes(world, 0)


def test_the_dry_run_counts_each_rank_s_bytes_on_meta(world):
    hold_meta(world, 0)


def test_each_rank_holds_one_row_of_its_half_of_norm_scale(world):
    assert all(r["fsdp"][0]["shapes"]["layers/mamba/norm_scale"] == (1, 128) for r in world["results"])
