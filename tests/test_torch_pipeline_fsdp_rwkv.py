"""FSDP over ``data`` inside the pipeline's stages (ROADMAP 7f-ii) for
RWKV-6: rwkv6_7b smoke in f32 from the port's seed-0 parameters on a (pod,
data, model) = (2, 2, 2) mesh of ``gloo`` CPU ranks, each holding its
``data`` block of its ``model`` shard (by heads) of its stage under the plan
with fsdp on (``torch_pipeline_fsdp_helpers``), at three thresholds: one
byte over ``w0``'s 4 x (L, d), the reference's 4 MiB (the smoke config's
leaves are all smaller, so the plan splits none over ``data`` and the call is
the control's program), and 0, where the plan puts ``data`` on ``w0``'s layer
axis, the only dim left to it (7f-iii).  A stage holds one of the two rows,
which ``data`` does not divide, so each stage keeps its row of ``w0`` whole
(``pipeline.stage_plan``), as ``_fit_spec`` drops an axis that does not
divide a dim.
For both boundaries the loss and every gradient, put together over
``data``, ``model`` and ``pod``, against ``jax.value_and_grad`` of the
reference's microbatch mean at 2e-5; bit-equal to the call without FSDP on
the same mesh (the tensor-parallel call); the ``data`` bytes as the code owes
them, the same at n_micro 2 and 4."""
import pytest

from repro_torch.parallel.sharding import FSDP_MIN_BYTES
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_fsdp_helpers import hold_bit_equal, hold_bytes, hold_meta, hold_reference, run, smoke

SHAPE = (2, 2, 2)
ARCH = "rwkv6_7b"
LOWEST = 4 * 2 * 128 + 1  # one byte over w0's (L, d) = (2, 128) in f32: test_over_w0_is_the_lowest_threshold


def configs():
    return {ARCH: (*smoke(ARCH), (LOWEST, FSDP_MIN_BYTES, 0))}


CASES = [(ARCH, LOWEST), (ARCH, FSDP_MIN_BYTES), (ARCH, 0)]
IDS = ["over_w0", "4MiB", "threshold0"]


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


def test_the_dry_run_counts_each_rank_s_bytes_on_meta(world):
    """At a threshold of 0 (``data`` on the layer axis of the stacked leaf)."""
    hold_meta(world[ARCH], 0)


def test_over_w0_is_the_lowest_threshold(world):
    """At ``w0``'s own bytes the plan puts ``data`` on its layer axis (once
    refused, 7f-iii); each stage's one row stays whole in the stage, and the
    run at a threshold of 0 holds its ``model`` half of that row (its calls
    are held against the reference and the control above)."""
    from repro_torch.convert import flatten
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.tensor_parallel import model_plan
    from torch_pipeline_fsdp_helpers import AXES, stage_fplan

    case = world[ARCH]
    assert LOWEST == 4 * case["params"]["layers"]["w0"].numel() + 1
    plan = model_plan(case["cfg"], Mesh(SHAPE, AXES), fsdp=True, min_bytes=LOWEST - 1)
    assert tuple(flatten(plan)["layers/w0"]) == ("data", "model")
    assert all(tuple(flatten(stage_fplan(case, plan, s))["layers/w0"]) == (None, "model") for s in range(SHAPE[0]))
    assert all(r["fsdp"][0]["shapes"]["layers/w0"] == (1, 64) for r in case["results"])
