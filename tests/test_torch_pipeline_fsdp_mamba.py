"""FSDP over ``data`` inside the pipeline's stages (ROADMAP 7f-ii) for the
pure Mamba2 stack (zamba2 smoke with family "ssm"), in f32 from the port's
seed-0 parameters on a (pod, data, model) = (2, 2, 1) mesh of ``gloo`` CPU
ranks, each holding its ``data`` block of its stage under the plan with
fsdp on (``torch_pipeline_fsdp_helpers``); on a ``model`` axis of more than 1
the plan with fsdp on splits the stack by heads as well (ROADMAP 7b-v,
``test_torch_fsdp_families.py``).  One threshold is one byte over
``norm_scale``'s 4 x (L, d_inner), where every other leaf with a dim that
``data`` divides splits; at 0 the plan puts ``data`` on ``norm_scale``'s
layer axis, its ``model`` entry taking the other dim (7f-iii), and each
stage's two rows split over ``data`` (``pipeline.stage_plan``): a rank holds
one, gathered with the stage's other data-split leaves once a step.
For both boundaries the loss and every gradient, put together over
``data``, ``model`` and ``pod``, against ``jax.value_and_grad`` of the
reference's microbatch mean at 2e-5; bit-equal to the call without FSDP on
the same mesh; the ``data`` bytes as the code owes them, the same at
n_micro 2 and 4.  At the reference's 4 MiB the smoke config's leaves are all
smaller, so the plan splits none over ``data`` and the call is the
control's program."""
import pytest

from repro_torch.parallel.sharding import FSDP_MIN_BYTES
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_fsdp_helpers import hold_bit_equal, hold_bytes, hold_meta, hold_reference, run, smoke

SHAPE = (2, 2, 1)
LOWEST = 4 * 4 * 256 + 1  # one byte over norm_scale's (L, d_inner) = (4, 256) in f32
CASES = [("ssm", LOWEST), ("ssm", FSDP_MIN_BYTES), ("ssm", 0)]
IDS = ["over_norm_scale", "4MiB", "threshold0"]


def configs():
    return {"ssm": (*smoke("zamba2_2p7b", {"family": "ssm"}), (LOWEST, FSDP_MIN_BYTES, 0))}


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
    hold_meta(world["ssm"], 0)


def test_over_norm_scale_is_the_lowest_threshold(world):
    """At ``norm_scale``'s own bytes the plan puts ``data`` on its layer axis
    (once refused, 7f-iii); each stage's two rows split over ``data``, so
    the run at a threshold of 0 holds one row of it a rank (its calls are
    held against the reference and the control above)."""
    from repro_torch.convert import flatten
    from repro_torch.launch.mesh import Mesh
    from repro_torch.parallel.tensor_parallel import model_plan
    from torch_pipeline_fsdp_helpers import AXES, stage_fplan

    case = world["ssm"]
    assert LOWEST == 4 * case["params"]["layers"]["mamba"]["norm_scale"].numel() + 1
    plan = model_plan(case["cfg"], Mesh(SHAPE, AXES), fsdp=True, min_bytes=LOWEST - 1)
    spec = tuple(flatten(plan)["layers/mamba/norm_scale"])
    assert spec == ("data", "model")
    assert all(tuple(flatten(stage_fplan(case, plan, s))["layers/mamba/norm_scale"]) == spec for s in range(SHAPE[0]))
    assert all(r["fsdp"][0]["shapes"]["layers/mamba/norm_scale"] == (1, 256) for r in case["results"])
