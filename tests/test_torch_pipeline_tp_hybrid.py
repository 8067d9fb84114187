"""Tensor parallelism over ``model`` inside the pipeline's stages for the
Zamba2 hybrid (ROADMAP 7b-iii with 7b-iv): zamba2 smoke in f32 from the
port's seed-0 parameters on (pod, data, model) = (2, 1, 2) and (2, 2, 2)
meshes of ``gloo`` CPU ranks, each holding its shards of its stage (one of
the two groups, cut on G and then where the plan splits: ``w_z`` and ``w_x``
on d, ``conv_x`` on its taps) and of the shared block outside the stack
(``torch_pipeline_tp_helpers``).  For both boundaries the loss and every
gradient, put together from the stages' blocks, against
``jax.value_and_grad`` of the reference's microbatch mean at 2e-5;
``striped`` bit-equal to ``direct`` at 1/TP of its ``pod`` sends; each rank's
shapes the reference's ``shard_shape`` of its stage's rows; the bytes of a
call on each axis as the code owes them."""
import pytest

from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_tp_helpers import dense_row, hold_boundaries, hold_bytes, hold_parity, hold_shard_shapes, run

ARCH = "zamba2_2p7b"
SHAPES = [(2, 1, 2), (2, 2, 2)]


def group_row(cfg, TP: int, tok: int) -> tuple:
    """(reduced, gathered) bytes over ``model`` of one hybrid group and one
    microbatch, f32, remat "none": each Mamba2 layer reduces ``w_z``'s and
    ``w_x``'s partial outputs and the convolution's partial sums forward and
    the convolution's input gradient backward (4 inner, (tok, d_inner)), and
    gathers the sliced x's gradient (act / TP); then the shared block as a
    transformer layer (``dense_row``)."""
    M = cfg.attn_period - 1
    inner = 4 * tok * cfg.d_model * cfg.ssm.expand
    block_reduce, block_gather = dense_row(cfg, TP, tok)
    return M * 4 * inner + block_reduce, M * 4 * tok * cfg.d_model // TP + block_gather


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def case(request, tmp_path_factory):
    return run(tmp_path_factory, ARCH, request.param)


@pytest.mark.parametrize("boundary", ["striped", "direct"])
def test_loss_and_gradients_match_the_reference(case, boundary):
    hold_parity(case, boundary)


def test_striped_and_direct_give_the_same_numbers_bit_for_bit(case):
    hold_boundaries(case)


def test_each_rank_holds_the_reference_s_shards_of_its_stage(case):
    hold_shard_shapes(case, ARCH)


def test_bytes_each_rank_puts_on_each_axis(case):
    hold_bytes(case, group_row)
