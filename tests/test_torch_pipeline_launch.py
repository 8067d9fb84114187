"""The launcher's ``--pipeline`` under torchrun: eight ``gloo`` ranks on the
CPU (``--standalone``, a free port), minitron-4b smoke as the launcher makes it
(bf16 activations, parameters from seed 0), two steps.  Rank 0 alone prints
the reference's ``[train]`` and step lines; step 0's loss is the reference's
microbatch mean of the same parameters and batch (bf16, within the loss
tolerance of the port's bf16 parity tests) and, to the printed digits, the
port's own pipelined loss on the same mesh, tensor-parallel over ``model``
inside the stages as the launcher runs minitron (spawned ``gloo`` ranks
through ``make_pipeline_loss`` with the plan): a tensor-parallel bf16 step
sums each product's halves over ``model`` in bf16, which one process's
accumulation does not."""
import os
import re
import subprocess
import sys

import numpy as np
import torch

from repro import configs as ref_configs
from repro_torch import configs, convert
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.models.transformer import build_model
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import jax_tree, pipeline_run, reference_microbatch_mean, save_inputs, spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--arch", "minitron-4b", "--smoke", "--pipeline", "--steps", "2", "--device", "cpu"]
BATCH, SEQ, N_MICRO, S, DP, TP = 8, 128, 4, 2, 2, 2  # the launcher's defaults on the (2, 2, 2) host mesh of 8 ranks
BF16_LOSS_TOL = 1e-3  # bf16 activations round at other places in the two frameworks (test_torch_loss.py)
PRINTED = 5e-5 + 1e-6  # the line prints 4 decimals


def test_torchrun_runs_the_pipeline_and_prints_the_reference_lines(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "8",
                        "-m", "repro_torch.launch.train", *ARGS], capture_output=True, text=True, env=env,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert [ln for ln in lines if ln.startswith("[train]")] == [
        "[train] arch=minitron-smoke device=cpu mesh={'pod': 2, 'data': 2, 'model': 2} params=1.2M"]
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 2 and all(re.match(r"step +\d+ loss [\d.]+ gnorm [\d.]+ lr \S+ tok/s [\d,]+$", s)
                                   for s in steps)
    loss0 = float(steps[0].split()[3])

    cfg = configs.get_smoke_config("minitron_4b")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg).init(gen)
    batch = next(make_batches(cfg, DataConfig(seed=0, batch_size=BATCH, seq_len=SEQ)))
    ref, _ = reference_microbatch_mean(ref_configs.get_smoke_config("minitron_4b"),
                                       jax_tree(convert.to_reference(params)), batch, S, N_MICRO * DP)
    ranks = spawn(pipeline_run, 8, tmp_path, cfg, (S, DP, TP),
                  *save_inputs(tmp_path, params, [{k: torch.from_numpy(v) for k, v in batch.items()}]),
                  ("striped",), N_MICRO, 0, 3e-3, True)
    port = float(ranks[0]["runs"]["striped"]["loss"])
    assert abs(loss0 - port) <= PRINTED, (loss0, port)
    np.testing.assert_allclose(loss0, ref, rtol=BF16_LOSS_TOL, atol=BF16_LOSS_TOL)
