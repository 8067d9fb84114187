"""Tensor parallelism over ``model`` inside the pipeline's stages (ROADMAP
7b-iv): granite_34b smoke in f32 from the port's seed-0 parameters on a (pod, data,
model) = (2, 2, 2) mesh of ``gloo`` CPU ranks, each holding its shards of its
stage under the reference's placement plan (``torch_pipeline_tp_helpers``).
The loss and every gradient, put together from the stages' blocks, against
``jax.value_and_grad`` of the reference's microbatch mean at 2e-5, for both
boundaries; ``striped`` bit-equal to ``direct`` at 1/TP of its ``pod`` sends;
each rank's shapes the reference's ``shard_shape`` of its stage's rows; the
bytes of a call on each axis as the code owes them."""
import pytest

from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_tp_helpers import hold_boundaries, hold_bytes, hold_parity, hold_shard_shapes, run

ARCH, SHAPE = "granite_34b", (2, 2, 2)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run(tmp_path_factory, ARCH, SHAPE)


@pytest.mark.parametrize("boundary", ["striped", "direct"])
def test_loss_and_gradients_match_the_reference(case, boundary):
    hold_parity(case, boundary)


def test_striped_and_direct_give_the_same_numbers_bit_for_bit(case):
    hold_boundaries(case)


def test_each_rank_holds_the_reference_s_shards_of_its_stage(case):
    hold_shard_shapes(case, ARCH)


def test_bytes_each_rank_puts_on_each_axis(case):
    hold_bytes(case)
