"""The port's cross-pod pipeline for DeepSeek-V2-Lite smoke (MoE and MLA) in
f32: on a (pod 2, data 2, model 2) mesh of eight ``gloo`` CPU processes, both
boundaries, its loss (the load-balance aux included) and every gradient
against ``jax.value_and_grad`` of the reference's microbatch mean, and
``striped`` against ``direct`` bit for bit; and on (pod 4, 1, 1), where its two
layers leave two whole stages of padding, the same against the reference
over the stack padded to four.  Each data shard's MoE capacity is its own, in
both (the reference's per-shard dispatch)."""
import pytest

from torch_pipeline_helpers import hold_against_reference, hold_boundaries_equal, pipeline_case

# f32: the same arithmetic in another framework and order of sums; the loss
# and each gradient leaf within 2e-5 (atol = 2e-5 max|ref leaf|)
REF_TOL = 2e-5


@pytest.fixture(scope="module")
def mesh_222(tmp_path_factory):
    return pipeline_case(tmp_path_factory.mktemp("moe_222"), "deepseek_v2_lite_16b", (2, 2, 2), ("direct", "striped"))


@pytest.mark.parametrize("boundary", ["striped", "direct"])
def test_loss_and_gradients_match_the_reference(mesh_222, boundary):
    hold_against_reference(mesh_222["results"], mesh_222["ref"], "layers", boundary, REF_TOL)


def test_striped_and_direct_give_the_same_numbers_bit_for_bit(mesh_222):
    hold_boundaries_equal(mesh_222["results"])


def test_two_stages_of_padding_match_the_reference(tmp_path):
    case = pipeline_case(tmp_path, "deepseek_v2_lite_16b", (4, 1, 1), ("striped",))
    hold_against_reference(case["results"], case["ref"], "layers", "striped", REF_TOL)
    # each stage holds its real layers only: 1, 1, then none
    assert [r["runs"]["striped"]["grads"]["layers/ln1"].shape[0] for r in case["results"]] == [1, 1, 0, 0]
