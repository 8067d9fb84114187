"""The MoE load-balance aux under data parallelism (ROADMAP Queue 3 (o)):
``DataParallelLoss`` on a (data, model) = (2, 1) mesh of two ``gloo`` CPU
ranks, each on its half of a batch of 8, against ``jax.value_and_grad`` of
the reference's ``model.loss`` on the whole batch, which takes the aux's two
means (``me``, ``ce``) over all of (B, T) before their product.  Qwen1.5-MoE
and DeepSeek-V2-Lite smoke in f32 from the port's seed-0 parameters: the loss
within 1e-5 and every gradient leaf within 1e-4 relative in norm, the bounds
of the port's ``Model.loss`` against the reference's.  A shard's own aux,
averaged over ``data``, misses the router leaves' bound; so does a mean whose
backward scales by 1 / DP (``parallel/batch_mean.py``).  The transport counts
one all-reduce of the two means (2 E f32) a MoE layer over ``data``."""

import numpy as np
import pytest
import torch

from repro_torch.convert import flatten
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import smoke_case, spawn
from torch_tp_helpers import close_in_norm, reference_value_and_grad, tp_loss_rank

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
SHAPE, BATCH, SEQ = (2, 1), 8, 16
ARCHS = ["qwen2_moe_a2p7b", "deepseek_v2_lite_16b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_moe_loss_and_gradients_are_the_whole_batch_s(tmp_path, arch):
    cfg, ref_cfg, params, ref_params, batch = smoke_case(arch, {}, BATCH, SEQ)
    assert cfg.moe is not None and cfg.remat == "none"
    # the reference first: its arrays may share memory with ``params``, which spawn moves to shared memory
    ref_loss, ref_grads = reference_value_and_grad(ref_cfg, ref_params, batch)
    results = spawn(tp_loss_rank, 2, tmp_path, cfg, SHAPE, params, [{k: torch.from_numpy(v) for k, v in batch.items()}])
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["loss"]), ref_loss, rtol=LOSS_TOL)
        close_in_norm(r["runs"][0]["grads"], ref_grads, GRAD_TOL)
        assert all(torch.equal(g, results[0]["runs"][0]["grads"][p]) for p, g in r["runs"][0]["grads"].items())
    n = sum(t.numel() for t in flatten(params).values())
    assert cfg.moe.first_moe_layer == 0  # every layer routes: one all-reduce of (2, E) f32 a layer
    got = results[0]["runs"][0]["bytes"]["data"]["all_reduce"]
    assert got == 4 * n + 8 + cfg.num_layers * 2 * cfg.moe.num_experts * 4
