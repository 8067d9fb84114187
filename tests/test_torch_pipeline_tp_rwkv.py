"""Tensor parallelism over ``model`` inside the pipeline's stages for RWKV-6
(ROADMAP 7b-iii with 7b-iv): rwkv6 smoke in f32 from the port's seed-0
parameters on (pod, data, model) = (2, 1, 2) and (2, 2, 2) meshes of ``gloo``
CPU ranks, each holding its shards of its stage (one of the two layers) under
the reference's placement plan (``torch_pipeline_tp_helpers``): the time mix
by heads, one of the two a rank, and the channel mix on d_ff and d.  For both
boundaries the loss and every gradient, put together from the stages'
blocks, against ``jax.value_and_grad`` of the reference's microbatch mean at
2e-5; ``striped`` bit-equal to ``direct`` at 1/TP of its ``pod`` sends; each
rank's shapes the reference's ``shard_shape`` of its stage's rows; the bytes
of a call on each axis as the code owes them."""
import pytest

from repro_torch.models.rwkv import LORA
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_tp_helpers import hold_boundaries, hold_bytes, hold_parity, hold_shard_shapes, run

ARCH = "rwkv6_7b"
SHAPES = [(2, 1, 2), (2, 2, 2)]


def rwkv_row(cfg, TP: int, tok: int) -> tuple:
    """(reduced, gathered) bytes over ``model`` of one RWKV-6 layer and one
    microbatch, f32, remat "none": ``wo``'s and ``cv``'s outputs reduced and
    the receptance's columns gathered forward; the gradients of the time
    mix's four ``copy_in`` inputs, of the LoRA's ``tanh`` (tok, 64) and of
    ``xk2`` summed backward."""
    act = 4 * tok * cfg.d_model
    return 7 * act + 4 * tok * LORA, act // TP


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
    hold_bytes(case, rwkv_row)
