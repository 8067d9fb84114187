"""FSDP over ``data`` inside the pipeline's stages (ROADMAP 7f-ii) for the
stages that take a batch of ``embeds`` in place of tokens: hubert_xlarge
smoke (frame embeddings with labels and a mask, the encoder non-causal) and
qwen2_vl_7b smoke (``embeds`` with (3, B, T) M-RoPE positions, sliced on dim 1
by the pipeline), in f32 from the port's seed-0 parameters on one (pod, data,
model) = (2, 2, 2) world of ``gloo`` CPU ranks, each holding its ``data``
block of its ``model`` shard of its stage under the plan with fsdp on, at a
threshold of 0 and at the reference's 4 MiB (``torch_pipeline_fsdp_helpers``).
For both boundaries the loss and every gradient, put together over
``data``, ``model`` and ``pod``, against ``jax.value_and_grad`` of the
reference's microbatch mean at 2e-5; bit-equal to the call without FSDP on
the same mesh (the tensor-parallel call); the ``data`` bytes as the code owes
them, the same at n_micro 2 and 4.  At the reference's 4 MiB the smoke
configs' leaves are all smaller, so the plan splits none over ``data`` and
the call is the control's program."""
import pytest

from repro_torch.parallel.sharding import FSDP_MIN_BYTES
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_fsdp_helpers import hold_bit_equal, hold_bytes, hold_reference, run, smoke

SHAPE = (2, 2, 2)
ARCHS = ("hubert_xlarge", "qwen2_vl_7b")
CASES = [(arch, t) for arch in ARCHS for t in (0, FSDP_MIN_BYTES)]
IDS = [f"{a}-{'threshold0' if t == 0 else '4MiB'}" for a, t in CASES]


def configs():
    return {arch: (*smoke(arch), (0, FSDP_MIN_BYTES)) for arch in ARCHS}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run(tmp_path_factory, SHAPE, configs())


@pytest.mark.parametrize("boundary", ["direct", "striped"])
@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_loss_and_gradients_match_the_reference(world, name, min_bytes, boundary):
    hold_reference(world[name], min_bytes, boundary)


@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_bit_equal_to_the_call_without_fsdp(world, name, min_bytes):
    hold_bit_equal(world[name], min_bytes)


@pytest.mark.parametrize("name,min_bytes", CASES, ids=IDS)
def test_data_bytes_are_the_code_s_once_a_step(world, name, min_bytes):
    hold_bytes(world[name], min_bytes)
