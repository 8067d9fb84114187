"""Tensor parallelism over ``model`` inside the pipeline's stages for the pure
Mamba2 stack (ROADMAP 7b-v with 7b-iv): zamba2 smoke as the pure stack
(``family="ssm"``, the same ``replace`` in both packages) in f32 from the
port's seed-0 parameters on (pod, data, model) = (2, 1, 2), ``gloo`` CPU
ranks each holding its shards of its stage (two of the four layers) under the
reference's placement plan (``torch_pipeline_tp_helpers``): by heads, 4 of
the 8 a rank, ``w_z``, ``w_x`` and ``conv_x`` on d_inner, ``w_out`` and
``norm_scale`` on their rows.  For both boundaries the loss and every
gradient, put together from the stages' blocks, against
``jax.value_and_grad`` of the reference's microbatch mean at 2e-5;
``striped`` bit-equal to ``direct`` at 1/TP of its ``pod`` sends; each
rank's shapes the reference's ``shard_shape`` of its stage's rows; the bytes
of a call on each axis as the code owes them."""
import pytest

from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_tp_helpers import hold_boundaries, hold_bytes, hold_parity, hold_shard_shapes, run

ARCH = "zamba2_2p7b"
SHAPE = (2, 1, 2)


def mamba_row(cfg, TP: int, tok: int) -> tuple:
    """(reduced, gathered) bytes over ``model`` of one Mamba2 layer and one
    microbatch, f32, remat "none": forward, the gated norm's sum of squares
    (tok) and ``w_out``'s output (act) reduced; backward, the gradients of
    ``copy_in(x)`` (act), of B and C (tok x 2 d_state) and of the sum of
    squares (tok) summed, and those of dt (tok x H / TP), A and D (H / TP
    each) gathered by ``slice_``."""
    act = 4 * tok * cfg.d_model
    H = cfg.d_model * cfg.ssm.expand // cfg.ssm.head_dim
    return 2 * act + 4 * tok * (2 + 2 * cfg.ssm.d_state), 4 * tok * H // TP + 2 * 4 * H // TP


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run(tmp_path_factory, ARCH, SHAPE, family="ssm")


@pytest.mark.parametrize("boundary", ["striped", "direct"])
def test_loss_and_gradients_match_the_reference(case, boundary):
    hold_parity(case, boundary)


def test_striped_and_direct_give_the_same_numbers_bit_for_bit(case):
    hold_boundaries(case)


def test_each_rank_holds_the_reference_s_shards_of_its_stage(case):
    hold_shard_shapes(case, ARCH)


def test_bytes_each_rank_puts_on_each_axis(case):
    hold_bytes(case, mamba_row)
