"""FSDP over ``data`` on the plain step (ROADMAP 7f) for every family that
step runs, on one (data, model) = (2, 2) world of ``gloo`` ranks on the CPU:
the dense decoder, the MoE with MLA (deepseek_v2_lite) and with GQA
(qwen2_moe), RWKV-6, the Zamba2 hybrid, the HuBERT encoder and the pure
Mamba2 stack (zamba2 smoke with ``family="ssm"``, split by heads over
``model``), each smoke config in f32 from the port's seed-0 parameters.

Each rank holds its ``data`` block of its ``model`` shard of every leaf the
plan with fsdp on splits, at a threshold of 0 (every leaf with a dim that
``data`` divides, where the reference's 4 MiB would split none of a smoke
config's), RWKV-6's at one byte over its ``w0`` and the pure stack's over its
``norm_scale``, whose only dim left for ``data`` is their layer axis (the
refusal of ``test_torch_fsdp.py``).  Against
``jax.value_and_grad`` of the reference's ``model.loss`` on the whole batch:
the loss within 1e-5 and each gradient leaf, put back together over ``data``
and ``model``, within 1e-4 in norm, and the clip's norm within 1e-4; the
``data`` bytes by op exactly what the code owes (``data_bytes_owed``)."""
import numpy as np
import pytest
import torch

from repro_torch.convert import flatten
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.sharding import shard_params
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_fsdp_helpers import AXES, assembled, data_bytes_owed, fsdp_plan, world_rank
from torch_pipeline_helpers import smoke_case, spawn
from torch_tp_helpers import close_in_norm, reference_value_and_grad

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BATCH, SEQ = 4, 16
SHAPE = (2, 2)
ARCHS = ["gpt_a", "deepseek_v2_lite_16b", "qwen2_moe_a2p7b", "rwkv6_7b", "zamba2_2p7b", "hubert_xlarge",
         "mamba2_pure"]
SMOKES = {"mamba2_pure": ("zamba2_2p7b", {"family": "ssm"})}  # a case that is not an arch: (its arch, its replace)


def _min_bytes(arch: str, params) -> int:
    """One byte over the leaf whose only dim left for ``data`` is its layer
    axis: RWKV-6's ``w0``, the pure stack's ``norm_scale``; 0 otherwise."""
    if arch == "rwkv6_7b":
        return 4 * params["layers"]["w0"].numel() + 1
    if arch == "mamba2_pure":
        return 4 * params["layers"]["mamba"]["norm_scale"].numel() + 1
    return 0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, refs = [], {}
    for arch in ARCHS:
        cfg, ref_cfg, params, ref_params, batch = smoke_case(*SMOKES.get(arch, (arch, {})), BATCH, SEQ)
        min_bytes = _min_bytes(arch, params)
        refs[arch] = (cfg, params, batch, min_bytes, reference_value_and_grad(ref_cfg, ref_params, batch))
        del ref_params
        cases.append((cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()}, min_bytes))
    results = spawn(world_rank, int(np.prod(SHAPE)), tmp_path_factory.mktemp("fsdp22"), SHAPE, cases)
    return refs, results


@pytest.mark.parametrize("arch", ARCHS)
def test_the_fsdp_step_is_the_reference_s_loss_and_gradients(world, arch):
    refs, results = world
    cfg, params, batch, min_bytes, (ref_loss, ref_grads) = refs[arch]
    plan = fsdp_plan(cfg, SHAPE, min_bytes)
    runs = [r["cases"][ARCHS.index(arch)] for r in results]
    for r in runs:
        np.testing.assert_allclose(float(r["loss"]), ref_loss, rtol=LOSS_TOL)
    close_in_norm(assembled(runs, plan), ref_grads, GRAD_TOL)
    whole = {p: torch.from_numpy(np.array(g, dtype=np.float32)) for p, g in ref_grads.items()}
    norm = float(torch.sqrt(sum(g.square().sum() for g in whole.values())))
    for r in runs:
        np.testing.assert_allclose(float(r["grad_norm"]), norm, rtol=GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_data_bytes_are_what_the_code_owes(world, arch):
    refs, results = world
    cfg, params, batch, min_bytes, _ = refs[arch]
    plan = fsdp_plan(cfg, SHAPE, min_bytes)
    for rank, r in enumerate(results):
        blocks = flatten(shard_params(params, Mesh(SHAPE, AXES, rank), plan))
        want = data_bytes_owed(cfg, plan, SHAPE, blocks, batch)
        got = r["cases"][ARCHS.index(arch)]["bytes"]["data"]
        assert got == want, (rank, got, want)
        assert got["reduce_scatter"] == SHAPE[0] * got["all_gather"]  # remat "none": each gather scattered once
