"""Data parallelism on the plain step (ROADMAP.md Queue 1, 7d): the launcher
over a (data, model) = (2, 2) mesh of four ``gloo`` ranks on the CPU, gpt_a
smoke in f32 from the reference's ``PRNGKey(0)`` parameters, converted.

``train()`` on the ranks: two steps of 8 x 16 (each rank its ``data`` half of
the batch) leave every rank's parameters, moments and step bit-equal, within
1e-6 (relative, in norm, a leaf) of one process's steps on the whole batch and
within 1e-5 of the reference's jitted ``make_train_step(model.loss)`` on the
same batches; a batch of 3 rows, which the ``data`` axis does not split, is
replicated (the reference's ``P()``) and gives one process's steps too.  The
transport counts each step's mask count, gradients and loss over ``data`` and
nothing over ``model``.  Under ``torchrun`` the launcher runs the same world
without ``--pipeline`` and prints the reference's lines from rank 0."""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import make_batches as ref_make_batches
from repro.models.transformer import build_model as ref_build_model
from repro.optim.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.optim.optimizer import init_opt_state as ref_init_opt_state
from repro.optim.optimizer import make_train_step as ref_make_train_step
from repro_torch import configs, convert
from repro_torch.launch.train import optimizer_config, train
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import _jax_flat, spawn, train_rank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, AXES = (2, 2), ("data", "model")
STEPS, SEQ = 2, 16
ONE_PROCESS_TOL = 1e-6  # the shards' masked sums over the global count: f32 sums in another order
REFERENCE_TOL = 1e-5  # the port's f32 step against the reference's (test_torch_optim.py's steps)
PRINTED = 5e-5 + 1e-6  # the step line prints 4 decimals


def _cfg():
    return dataclasses.replace(configs.get_smoke_config("gpt_a"), dtype=torch.float32)


def _reference_params():
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("gpt_a"), dtype=jnp.float32)
    return ref_cfg, ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))


def _close(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        w = torch.from_numpy(np.array(w))
        assert float((got[k] - w).norm()) <= tol * float(w.norm()), (k, float((got[k] - w).norm() / w.norm()))


def test_the_plain_step_over_data_ranks_is_one_process_s_step(tmp_path):
    cfg = _cfg()
    ref_cfg, ref_params = _reference_params()
    params = convert.from_reference(jax.tree.map(np.asarray, ref_params), cfg)
    runs = [(cfg, SHAPE, AXES, dict(steps=STEPS, batch=b, seq=SEQ, log_every=STEPS, params=params))
            for b in (8, 3)]
    ranks = spawn(train_rank, 4, tmp_path, runs)
    n_params = sum(t.numel() for t in convert.flatten(params).values())
    for i, batch in enumerate((8, 3)):
        first = ranks[0][i]
        for r in ranks[1:]:
            for part in ("params", "mu", "nu"):
                assert all(torch.equal(v, first[part][k]) for k, v in r[i][part].items()), part
            assert torch.equal(r[i]["step"], first["step"]) and r[i]["losses"] == first["losses"]
        assert first["bytes"]["data"]["all_reduce"] == STEPS * (4 * n_params + 8)
        assert not any(first["bytes"]["model"].values())
        one = train(cfg, steps=STEPS, batch=batch, seq=SEQ, log_every=STEPS, device="cpu",
                    params=convert.from_reference(jax.tree.map(np.asarray, ref_params), cfg))
        _close(first["params"], {k: v.detach() for k, v in convert.flatten(one["params"]).items()}, ONE_PROCESS_TOL)
        np.testing.assert_allclose(first["losses"], [h["loss"] for h in one["history"]], rtol=ONE_PROCESS_TOL)

    ocfg = optimizer_config(3e-3, STEPS)
    step = jax.jit(ref_make_train_step(ref_build_model(ref_cfg).loss, RefOptimizerConfig(
        peak_lr=ocfg.peak_lr, warmup_steps=ocfg.warmup_steps, total_steps=ocfg.total_steps)))
    p, o = ref_params, ref_init_opt_state(ref_params)
    losses = []
    for b in ref_make_batches(ref_cfg, RefDataConfig(seed=0, batch_size=8, seq_len=SEQ), num_steps=STEPS):
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    _close(ranks[0][0]["params"], _jax_flat(p), REFERENCE_TOL)
    np.testing.assert_allclose(ranks[0][0]["losses"], losses, rtol=REFERENCE_TOL)


def test_torchrun_runs_the_plain_step_over_four_ranks():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    args = ["--arch", "gpt-a", "--smoke", "--steps", "2", "--batch", "8", "--seq", "32", "--log-every", "1",
            "--device", "cpu"]
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                        "-m", "repro_torch.launch.train", *args], capture_output=True, text=True, env=env,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert [ln for ln in lines if ln.startswith("[train]")] == [
        "[train] arch=gpt-a-smoke device=cpu mesh={'data': 2, 'model': 2} params=1.8M"]
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2 and all(re.match(r"step +\d+ loss [\d.]+ gnorm [\d.]+ lr \S+ tok/s [\d,]+$", s)
                                   for s in steps)
    one = train(configs.get_smoke_config("gpt_a"), steps=1, batch=8, seq=32, device="cpu", log_every=1)
    assert abs(float(steps[0].split()[3]) - one["history"][0]["loss"]) <= PRINTED
