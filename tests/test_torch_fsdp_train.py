"""FSDP over ``data`` on the plain step (ROADMAP 7f), on one (data, model) =
(2, 2) world of ``gloo`` ranks on the CPU: the reference's own 4 MiB plan,
remat "full", and two trained steps; gpt_a's smoke config in f32 from the
port's seed-0 parameters.

  * The real plan: gpt_a widened to d_model 512 and d_ff 2048, at the
    reference's threshold, splits the FFN's two matrices over ``data`` and
    leaves ``wq``, ``wk``, ``wv``, ``wo``, the embedding and the head whole
    there.
  * Remat "full": each layer gathers inside the checkpointed block, so the
    recomputation in the backward gathers its blocks again; the reduce-scatter
    stays one a gather of the forward.
  * Training: two steps of ``make_train_step`` over the FSDP loss, put back
    together with ``unshard``, against the reference's jitted
    ``make_train_step(model.loss)`` on the same batches within 1e-5.

Each against ``jax.value_and_grad`` of the reference's ``model.loss`` (loss
1e-5, a gradient leaf 1e-4 in norm), with the ``data`` bytes by op exactly
what the code owes (``data_bytes_owed``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import build_model as ref_build_model
from repro.optim.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.optim.optimizer import init_opt_state as ref_init_opt_state
from repro.optim.optimizer import make_train_step as ref_make_train_step
from repro_torch.convert import flatten
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import optimizer_config
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import FSDP_MIN_BYTES, shard_params
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_fsdp_helpers import AXES, assembled, data_bytes_owed, fsdp_plan, world_rank
from torch_pipeline_helpers import _jax_flat, smoke_case, spawn
from torch_tp_helpers import close_in_norm, reference_value_and_grad

LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
REFERENCE_TOL = 1e-5  # the port's f32 step against the reference's (test_torch_optim.py's steps)
BATCH, SEQ = 4, 16
SHAPE = (2, 2)
STEPS, TRAIN_BATCH, LR = 2, 8, 3e-3
CASES = {"real_plan": ({"d_model": 512, "d_ff": 2048}, FSDP_MIN_BYTES), "remat_full": ({"remat": "full"}, 0)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases, refs = [], {}
    for name, (replace, min_bytes) in CASES.items():
        cfg, ref_cfg, params, ref_params, batch = smoke_case("gpt_a", replace, BATCH, SEQ)
        refs[name] = (cfg, params, batch, min_bytes, reference_value_and_grad(ref_cfg, ref_params, batch))
        del ref_params
        cases.append((cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()}, min_bytes))
    cfg, ref_cfg, params, ref_params, _ = smoke_case("gpt_a", {}, BATCH, SEQ)
    batches = list(make_batches(cfg, DataConfig(seed=0, batch_size=TRAIN_BATCH, seq_len=SEQ), num_steps=STEPS))
    ocfg = optimizer_config(LR, STEPS)
    step = jax.jit(ref_make_train_step(ref_build_model(ref_cfg).loss, RefOptimizerConfig(
        peak_lr=ocfg.peak_lr, warmup_steps=ocfg.warmup_steps, total_steps=ocfg.total_steps)))
    p, o, losses = ref_params, ref_init_opt_state(ref_params), []
    for b in batches:
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    trained = {"params": _jax_flat(p), "mu": _jax_flat(o.mu), "losses": losses}
    del ref_params, p, o
    train = (cfg, params, [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches], LR, 0)
    results = spawn(world_rank, int(np.prod(SHAPE)), tmp_path_factory.mktemp("fsdp22t"), SHAPE, cases, train)
    return refs, results, {"cfg": cfg, "params": params, "batch": batches[0], "reference": trained}


@pytest.mark.parametrize("name", list(CASES))
def test_the_fsdp_step_is_the_reference_s(world, name):
    refs, results, _ = world
    cfg, params, batch, min_bytes, (ref_loss, ref_grads) = refs[name]
    plan = fsdp_plan(cfg, SHAPE, min_bytes)
    runs = [r["cases"][list(CASES).index(name)] for r in results]
    for r in runs:
        np.testing.assert_allclose(float(r["loss"]), ref_loss, rtol=LOSS_TOL)
    close_in_norm(assembled(runs, plan), ref_grads, GRAD_TOL)
    for rank, r in enumerate(runs):
        blocks = flatten(shard_params(params, Mesh(SHAPE, AXES, rank), plan))
        assert r["bytes"]["data"] == data_bytes_owed(cfg, plan, SHAPE, blocks, batch), (rank, r["bytes"]["data"])
    data = runs[0]["bytes"]["data"]
    if name == "remat_full":  # the recomputation gathers the layers again; the head and the embedding once
        head = 4 * sum(blocks[p].numel() for p in ("embed", "lm_head"))
        assert data["all_gather"] - head == 2 * (data["reduce_scatter"] // SHAPE[0] - head)
    else:
        assert sorted(fsdp.data_dims(plan)) == ["layers/ffn/w_down", "layers/ffn/w_up"]


def test_two_fsdp_steps_are_the_reference_s_jitted_steps(world):
    _, results, t = world
    cfg, ref = t["cfg"], t["reference"]
    plan = fsdp_plan(cfg, SHAPE, 0)
    runs = [r["train"] for r in results]
    for r in runs:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=REFERENCE_TOL)
    close_in_norm(assembled(runs, plan, "params"), ref["params"], REFERENCE_TOL)
    close_in_norm(assembled(runs, plan, "mu"), ref["mu"], REFERENCE_TOL)
    for rank, r in enumerate(runs):
        blocks = flatten(shard_params(t["params"], Mesh(SHAPE, AXES, rank), plan))
        assert {k: v.shape for k, v in r["params"].items()} == {k: v.shape for k, v in blocks.items()}
        assert {k: v.shape for k, v in r["nu"].items()} == {k: v.shape for k, v in blocks.items()}
        owed = data_bytes_owed(cfg, plan, SHAPE, blocks, t["batch"])
        assert r["bytes"]["data"] == {k: STEPS * v for k, v in owed.items()}, rank
