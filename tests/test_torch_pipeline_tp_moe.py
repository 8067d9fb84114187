"""Tensor parallelism over ``model`` inside the pipeline's stages for the MoE
and MLA families (ROADMAP 7b-ii with 7b-iv): smoke configs in f32 from the
port's seed-0 parameters on (pod, data, model) meshes of ``gloo`` CPU ranks,
each holding its shards of its stage under the reference's placement plan
(``torch_pipeline_tp_helpers``).  deepseek_v2_lite_16b on (2, 1, 2) and
(2, 2, 2): its 4 experts split on the expert dim and MLA at 2 of 4 heads a
rank; qwen2_moe_a2p7b with 3 experts on (2, 1, 2): the experts split on their
features.  For both boundaries the loss (the load-balance aux included) and
every gradient, put together from the stages' blocks, against
``jax.value_and_grad`` of the reference's microbatch mean at 2e-5;
``striped`` bit-equal to ``direct`` at 1/TP of its ``pod`` sends; each rank's
shapes the reference's ``shard_shape`` of its stage's rows (a routed expert's
4-D leaf cut on its stage's rows, then on its expert or feature dim)."""
import pytest

from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_tp_helpers import hold_boundaries, hold_parity, hold_shard_shapes, run

CASES = [("deepseek_v2_lite_16b", (2, 1, 2), None), ("deepseek_v2_lite_16b", (2, 2, 2), None),
         ("qwen2_moe_a2p7b", (2, 1, 2), 3)]
IDS = [f"{a}-{'x'.join(map(str, m))}{f'-{e}experts' if e else ''}" for a, m, e in CASES]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request, tmp_path_factory):
    arch, shape, experts = request.param
    out = run(tmp_path_factory, arch, shape, experts=experts)
    out["arch"] = arch
    return out


@pytest.mark.parametrize("boundary", ["striped", "direct"])
def test_loss_and_gradients_match_the_reference(case, boundary):
    hold_parity(case, boundary)


def test_striped_and_direct_give_the_same_numbers_bit_for_bit(case):
    hold_boundaries(case)


def test_each_rank_holds_the_reference_s_shards_of_its_stage(case):
    hold_shard_shapes(case, case["arch"])
