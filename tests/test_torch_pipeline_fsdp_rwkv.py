"""FSDP over ``data`` inside the pipeline's stages (ROADMAP 7f-ii) for
RWKV-6: rwkv6_7b smoke in f32 from the port's seed-0 parameters on a (pod,
data, model) = (2, 2, 2) mesh of ``gloo`` CPU ranks, each holding its
``data`` block of its ``model`` shard (by heads) of its stage under the plan
with fsdp on (``torch_pipeline_fsdp_helpers``).  The lower threshold is one
byte over ``w0``'s 4 x (L, d): at 0 the plan would put ``data`` on ``w0``'s
layer axis, the only dim left to it, which ``model_plan`` refuses (ROADMAP
7f-iii; ``test_torch_fsdp.py``); every other leaf with a dim that ``data``
divides splits there.
For both boundaries the loss and every gradient, put together over
``data``, ``model`` and ``pod``, against ``jax.value_and_grad`` of the
reference's microbatch mean at 2e-5; bit-equal to the call without FSDP on
the same mesh (the tensor-parallel call); the ``data`` bytes as the code owes them, the same at
n_micro 2 and 4.  At the reference's 4 MiB the smoke config's leaves are all
smaller, so the plan splits none over ``data`` and the call is the
control's program."""
import pytest

from repro_torch.parallel.sharding import FSDP_MIN_BYTES
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_fsdp_helpers import hold_bit_equal, hold_bytes, hold_reference, run, smoke

SHAPE = (2, 2, 2)
ARCH = "rwkv6_7b"
LOWEST = 4 * 2 * 128 + 1  # one byte over w0's (L, d) = (2, 128) in f32: test_over_w0_is_the_lowest_threshold


def configs():
    return {ARCH: (*smoke(ARCH), (LOWEST, FSDP_MIN_BYTES))}


CASES = [(ARCH, LOWEST), (ARCH, FSDP_MIN_BYTES)]
IDS = ["over_w0", "4MiB"]


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


def test_over_w0_is_the_lowest_threshold(world):
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.tensor_parallel import model_plan
    from torch_pipeline_fsdp_helpers import AXES

    case = world[ARCH]
    assert LOWEST == 4 * case["params"]["layers"]["w0"].numel() + 1
    with pytest.raises(NotImplementedError, match="7f-iii"):
        model_plan(case["cfg"], Mesh(SHAPE, AXES), fsdp=True, min_bytes=LOWEST - 1)
