"""FSDP over ``data`` inside the pipeline's stages with tensor parallelism
over ``model`` (ROADMAP 7f-ii with 7b-iv): gpt_a on a (pod, data, model) =
(2, 2, 2) mesh of ``gloo`` CPU ranks, each holding its ``data`` block of its
``model`` shard of its stage under the plan with fsdp on
(``torch_pipeline_fsdp_helpers``): the smoke config at a threshold of 0 and
at the reference's 4 MiB (which splits none of its leaves), and widened to
d_model 512 and d_ff 2048 at 4 MiB (the FFN's matrices split over both axes).
For both boundaries the loss and every gradient, put together over ``data``,
``model`` and ``pod``, against ``jax.value_and_grad`` of the reference's
microbatch mean at 2e-5; bit-equal to the tensor-parallel call without FSDP
on the same mesh; the ``data`` bytes as the code owes them, the same at
n_micro 2 and 4, and the ``model`` bytes the control's; two trained steps
within 1e-5 of the control's."""
import pytest

from repro_torch.parallel.sharding import FSDP_MIN_BYTES
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_fsdp_helpers import hold_bit_equal, hold_bytes, hold_reference, hold_train, run, smoke

SHAPE = (2, 2, 2)
CASES = [("gpt_a", 0), ("gpt_a", FSDP_MIN_BYTES), ("gpt_a_wide", FSDP_MIN_BYTES)]
IDS = ["smoke-threshold0", "smoke-4MiB", "wide-4MiB"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run(tmp_path_factory, SHAPE, {"gpt_a": (*smoke("gpt_a"), (0, FSDP_MIN_BYTES)),
                                         "gpt_a_wide": (*smoke("gpt_a", {"d_model": 512, "d_ff": 2048}),
                                                        (FSDP_MIN_BYTES,))}, train_steps=2)


@pytest.mark.parametrize("boundary", ["direct", "striped"])
@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_loss_and_gradients_match_the_reference(world, name, min_bytes, boundary):
    hold_reference(world[name], min_bytes, boundary)


@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_bit_equal_to_the_tensor_parallel_call(world, name, min_bytes):
    hold_bit_equal(world[name], min_bytes)


@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_data_bytes_are_the_code_s_once_a_step(world, name, min_bytes):
    hold_bytes(world[name], min_bytes)


@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_two_steps_are_the_control_s(world, name, min_bytes):
    hold_train(world[name], min_bytes)
