"""The port's cross-pod pipeline for Zamba2 smoke (Mamba2 groups and the
gated shared block) in f32: on a (pod 2, data 2, model 2) mesh of eight
``gloo`` CPU processes, both boundaries, its loss and every gradient against
``jax.value_and_grad`` of the reference's microbatch mean, and ``striped``
against ``direct`` bit for bit; and with three groups on (pod 2, 1, 1), so
that the last stage runs one padded group whose zero gate switches the shared
block off (as Zamba2-2.7B's nine groups on two stages), against the reference
over the padded stack and through two train steps: the padded group is never
a parameter, and the shared block's copies stay bit-equal."""
import pytest
import torch

from torch_pipeline_helpers import hold_against_reference, hold_boundaries_equal, pipeline_case

# f32: the same arithmetic in another framework and order of sums; the loss
# and each gradient leaf within 2e-5 (atol = 2e-5 max|ref leaf|)
REF_TOL = 2e-5


@pytest.fixture(scope="module")
def mesh_222(tmp_path_factory):
    return pipeline_case(tmp_path_factory.mktemp("hybrid_222"), "zamba2_2p7b", (2, 2, 2), ("direct", "striped"))


@pytest.fixture(scope="module")
def padded(tmp_path_factory):
    return pipeline_case(tmp_path_factory.mktemp("hybrid_pad"), "zamba2_2p7b", (2, 1, 1), ("direct", "striped"),
                         train_steps=2, num_layers=6)


@pytest.mark.parametrize("boundary", ["striped", "direct"])
def test_loss_and_gradients_match_the_reference(mesh_222, boundary):
    hold_against_reference(mesh_222["results"], mesh_222["ref"], "groups", boundary, REF_TOL)


def test_striped_and_direct_give_the_same_numbers_bit_for_bit(mesh_222):
    hold_boundaries_equal(mesh_222["results"])


def test_a_padded_group_matches_the_reference(padded):
    hold_against_reference(padded["results"], padded["ref"], "groups", "striped", REF_TOL)


def test_the_padded_group_is_never_a_parameter(padded):
    """Three groups on two stages: stage 0 holds groups 0 and 1, stage 1
    group 2 alone; its gradients, moments and parameters after two steps have
    that one row, and ``rest`` (the shared block among it) is bit-equal."""
    first, last = padded["results"]
    for r, rows in ((first, 2), (last, 1)):
        for tree in (r["runs"]["striped"]["grads"], r["params"], r["mu"], r["nu"]):
            for path, t in tree.items():
                if path.startswith("groups/"):
                    assert t.shape[0] == rows, path
    for path, t in first["params"].items():
        if not path.startswith("groups/"):
            assert torch.equal(t, last["params"][path]), path
