"""Tensor parallelism over ``model`` on the plain step (ROADMAP 7b-i): the
dense decoder family's loss and gradients on ``gloo`` ranks of the CPU, each
holding its shards of the reference's placement plan, against
``jax.value_and_grad`` of the reference's ``model.loss`` on the same batch,
the smoke configs in f32 from the port's seed-0 parameters.

Cases: gpt_a at (data, model) = (1, 2) and (2, 2), whose heads line up with
the ranks; granite_34b at (1, 2), whose single kv head the plan cuts in two;
qwen2_vl_7b at (1, 4), whose 2 kv heads are cut inside, with a batch of
``embeds`` and its own (3, B, T) positions, which the model pins to the masked
``sdpa``; hubert_xlarge at (1, 2), non-causal over ``embeds`` with
``labels`` and a ``mask``; gpt_a with a tied embedding at (1, 2), whose head
(the embedding split on its features) is split on its contracting dim.  Loss f32 1e-5, gradients 1e-4 relative in norm a
leaf, the bounds of the port's ``Model.loss`` against the reference's.  The
transport counts what the design owes over ``model``, and the gradients over
``data`` only."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.data.pipeline import input_batch_for
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel.tensor_parallel import model_plan
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import jax_tree, spawn
from torch_tp_helpers import close_in_norm, gathered, reference_value_and_grad, tp_loss_rank

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
BATCH, SEQ = 4, 16
CASES = [("gpt_a", (1, 2), False, {}), ("gpt_a", (2, 2), False, {}), ("granite_34b", (1, 2), False, {}),
         ("qwen2_vl_7b", (1, 4), True, {}), ("hubert_xlarge", (1, 2), False, {}),
         ("gpt_a", (1, 2), False, {"tie_embeddings": True})]


def _case(arch: str, replace: dict):
    import jax.numpy as jnp
    from repro import configs as ref_configs
    from repro_torch.models.transformer import build_model

    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=torch.float32, **replace)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jnp.float32, **replace)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg).init(gen)
    return cfg, ref_cfg, params


def _batch(cfg, pinned: bool) -> dict:
    """``input_batch_for``'s batch; for a pinned VLM batch, positions of its
    own: text rows 0..T-1 and image patches that share temporal position 0."""
    b = input_batch_for(cfg, BATCH, SEQ)
    if pinned:
        pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (3, BATCH, SEQ)).copy()
        pos[0, :, 2:6] = 0
        pos[1, :, 2:6] = np.arange(4) // 2
        pos[2, :, 2:6] = np.arange(4) % 2
        b["positions"] = pos
    return b


@pytest.mark.parametrize("arch,shape,pinned,replace", CASES,
                         ids=[f"{a}-{'x'.join(map(str, m))}{'-tied' if r else ''}" for a, m, _, r in CASES])
def test_the_tp_loss_and_gradients_are_the_reference_s(tmp_path, arch, shape, pinned, replace):
    cfg, ref_cfg, params = _case(arch, replace)
    batch = _batch(cfg, pinned)
    results = spawn(tp_loss_rank, int(np.prod(shape)), tmp_path, cfg, shape, params,
                    [{k: torch.from_numpy(v) for k, v in batch.items()}])
    ref_loss, ref_grads = reference_value_and_grad(ref_cfg, jax_tree(convert.to_reference(params)), batch)
    plan = model_plan(cfg, Mesh(shape, ("data", "model")))
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["loss"]), ref_loss, rtol=LOSS_TOL)
    close_in_norm(gathered(results, plan, 0), ref_grads, GRAD_TOL)
    whole = {p: torch.from_numpy(np.array(g, dtype=np.float32)) for p, g in ref_grads.items()}
    norm = float(torch.sqrt(sum(g.square().sum() for g in whole.values())))
    for r in results:
        np.testing.assert_allclose(float(r["runs"][0]["grad_norm"]), norm, rtol=GRAD_TOL)
