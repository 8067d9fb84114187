"""Tensor parallelism over ``model`` inside the pipeline's stages (ROADMAP
7b-iv): gpt_a smoke in f32 from the port's seed-0 parameters on a (pod, data,
model) = (2, 2, 2) mesh of ``gloo`` CPU ranks, each holding its shards of its
stage under the reference's placement plan (``torch_pipeline_tp_helpers``).
The loss and every gradient, put together from the stages' blocks, against
``jax.value_and_grad`` of the reference's microbatch mean at 2e-5, for both
boundaries; ``striped`` bit-equal to ``direct`` at 1/TP of its ``pod`` sends;
each rank's shapes the reference's ``shard_shape`` of its stage's rows; the
bytes of a call on each axis as the code owes them.  Two pipelined train
steps (the ``striped`` boundary) match the reference's jitted
``make_train_step`` over its pipelined loss at 1e-5: the losses, and the
parameters and first moments put together from the ranks."""
import pytest

from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_tp_helpers import hold_boundaries, hold_bytes, hold_parity, hold_shard_shapes, run

ARCH, SHAPE = "gpt_a", (2, 2, 2)
STEPS, LR = 2, 3e-3
REFERENCE_TOL = 1e-5  # the port's f32 step against the reference's (test_torch_optim.py's steps)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return run(tmp_path_factory, ARCH, SHAPE, train_steps=STEPS)


@pytest.mark.parametrize("boundary", ["striped", "direct"])
def test_loss_and_gradients_match_the_reference(case, boundary):
    hold_parity(case, boundary)


def test_striped_and_direct_give_the_same_numbers_bit_for_bit(case):
    hold_boundaries(case)


def test_each_rank_holds_the_reference_s_shards_of_its_stage(case):
    hold_shard_shapes(case, ARCH)


def test_bytes_each_rank_puts_on_each_axis(case):
    hold_bytes(case)


def test_two_train_steps_match_the_reference_s_jitted_step(case):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro import configs as ref_configs
    from repro.optim.optimizer import OptimizerConfig, init_opt_state, make_train_step
    from repro_torch import convert
    from torch_pipeline_helpers import _jax_flat, assemble_blocks, jax_tree, reference_pipeline_loss
    from torch_pipeline_tp_helpers import N_MICRO
    from torch_tp_helpers import close_in_norm

    S, DP, _ = SHAPE
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), dtype=jnp.float32)
    step = jax.jit(make_train_step(reference_pipeline_loss(ref_cfg, S, N_MICRO * DP),
                                   OptimizerConfig(peak_lr=LR, warmup_steps=1, total_steps=STEPS),
                                   loss_has_metrics=False))
    p = jax_tree(convert.to_reference(case["params"]))
    o = init_opt_state(p)
    losses = []
    for b in case["batches"][:STEPS]:
        p, o, m = step(p, o, {k: jnp.asarray(v.numpy()) for k, v in b.items()})
        losses.append(float(m["loss"]))
    results = case["results"]
    for r in results:
        np.testing.assert_allclose(r["losses"], losses, rtol=REFERENCE_TOL)
    close_in_norm(assemble_blocks(results, case["cfg"], case["plan"], lambda r: r["params"]), _jax_flat(p),
                  REFERENCE_TOL)
    close_in_norm(assemble_blocks(results, case["cfg"], case["plan"], lambda r: r["mu"]), _jax_flat(o.mu),
                  REFERENCE_TOL)
