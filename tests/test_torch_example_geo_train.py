"""``repro_torch.examples.geo_train`` against the reference's
``examples/geo_train.py``, which cannot be imported in a test worker (it sets
``XLA_FLAGS`` for eight emulated devices in the importing process), so its
calls are reproduced here with the example's own arguments: parts 1 and 2 are
the reference's own lines of ``main`` run over ``repro.core`` and must print
exactly what the copy prints; part 3, three steps of the smoke GPT-A through
the pipeline on (pod, data, model) = (2, 2, 2) from the reference's
``PRNGKey(0)`` parameters (converted), eight spawned ``gloo`` ranks on the
CPU, gives on every rank the losses of the reference's jitted
``make_train_step`` over its pipelined loss on one device (the mean over the
n_micro x DP row chunks, ``torch_pipeline_helpers.reference_pipeline_loss``),
within the bf16 loss tolerance of the launcher's pipelined test."""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import dc_selection, simulator, topology, wan
from repro.data.pipeline import DataConfig, make_batches
from repro.models.transformer import build_model as ref_build_model
from repro.optim.optimizer import OptimizerConfig, init_opt_state, make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.examples import geo_train
from torch_example_helpers import ROOT, converted
from torch_pipeline_helpers import reference_pipeline_loss

STEPS, S, DP, N_MICRO = 3, 2, 2, 4
BF16_LOSS_TOL = 1e-3  # bf16 activations round at other places in the two frameworks (test_torch_pipeline_launch.py)


def _reference_parts_1_and_2():
    """The reference's ``main`` from its plan to its part 3, run as written."""
    src = (ROOT / "examples" / "geo_train.py").read_text()
    body = src[src.index("    # ---- 1) plan ----"):src.index("    # ---- 3)")]
    exec(textwrap.dedent(body), {"JobModel": dc_selection.JobModel, "algorithm1": dc_selection.algorithm1,
                                 "best_plan": dc_selection.best_plan, "wan": wan, "topology": topology,
                                 "GeoTopology": simulator.GeoTopology, "simulate": simulator.simulate,
                                 "testbed_spec": simulator.testbed_spec})


def test_geo_train_plans_simulates_and_trains_as_the_reference(capfd):
    _reference_parts_1_and_2()
    want = capfd.readouterr().out.splitlines()
    assert len(want) == 7 and want[0].startswith("[plan]")

    ref_cfg = ref_smoke_config("gpt_a")
    ref_params, params = converted(ref_build_model(ref_cfg), get_smoke_config("gpt_a"))
    got = geo_train.main(steps=STEPS, device="cpu", params=params)
    lines = capfd.readouterr().out.splitlines()
    assert lines[:7] == want
    assert lines[7] == "[pipeline] mesh={'pod': 2, 'data': 2, 'model': 2} arch=gpt-a-smoke boundary=striped"
    assert lines[-1].startswith("[pipeline] done")

    ranks = got["ranks"]
    assert len(ranks) == 8 and all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert all(not any(r["launches"].values()) for r in ranks)  # the CPU takes the plain versions
    assert [ln for ln in lines if ln.startswith("[pipeline] step")] == [
        f"[pipeline] step {i:3d} loss {ranks[0]['losses'][i]:.4f}" for i in (0, STEPS - 1)]

    loss = reference_pipeline_loss(ref_cfg, S, N_MICRO * DP)
    step = jax.jit(make_train_step(loss, OptimizerConfig(peak_lr=3e-3, warmup_steps=5, total_steps=STEPS),
                                   loss_has_metrics=False))
    p, o, ref_losses = ref_params, init_opt_state(ref_params), []
    for b in make_batches(ref_cfg, DataConfig(batch_size=8, seq_len=64), num_steps=STEPS):
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        ref_losses.append(float(m["loss"]))
    np.testing.assert_allclose(ranks[0]["losses"], ref_losses, rtol=BF16_LOSS_TOL, atol=BF16_LOSS_TOL)
