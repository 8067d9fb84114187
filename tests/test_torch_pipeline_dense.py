"""The port's cross-pod pipeline on a (pod 2, data 2, model 2) mesh of eight
``gloo`` CPU processes, minitron_4b smoke in f32 (remat "full"): its loss and every
gradient against ``jax.value_and_grad`` of the reference's microbatch mean
(built from ``repro.models.transformer.build_pipeline_parts``), for both
boundaries; ``striped`` against ``direct`` bit for bit, with the bytes each
rank sends by formula; two pipelined train steps against
``make_train_step(model.loss, accum_steps=n_micro * DP)``; and ``rest``
bit-equal on every rank after them."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro_torch import configs, convert
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state, make_train_step
from repro_torch.parallel.pipeline import stage_layer_range
from torch_pipeline_helpers import (
    hold_against_reference,
    hold_boundaries_equal,
    jax_tree,
    pipeline_run,
    reference_microbatch_mean,
    save_inputs,
    spawn,
)

ARCH, SHAPE, N_MICRO, BATCH, SEQ, STEPS, LR = "minitron_4b", (2, 2, 2), 4, 8, 128, 2, 3e-3
S, DP, TP = SHAPE
# f32 against the reference: the same arithmetic in another framework and
# another order of sums; loss and each gradient leaf within 2e-5 of the
# reference's largest magnitude in that leaf (relative, atol = 2e-5 max|ref|)
REF_TOL = 2e-5
# the pipeline against the port's own accumulation: the same chunks through
# the same code, the gradients summed in another order (autograd's backward
# over microbatches in reverse): max|diff| <= 1e-5 max|g| a leaf
ACC_TOL = 1e-5
# what two AdamW steps moved each parameter (about 1.1 lr at most), against
# accumulation's: max|diff| <= 5e-3 max|update| a leaf, on the elements whose
# first moment is above 1e-3 of the leaf's largest (measured: 6e-4 at most);
# a skipped, halved or sign-flipped step moves such elements by ~0.5 lr
MU_FLOOR, UPDATE_TOL = 1e-3, 5e-3


def _batches(cfg):
    it = make_batches(cfg, DataConfig(seed=0, batch_size=BATCH, seq_len=SEQ), num_steps=STEPS)
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in it]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), remat="full", dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg).init(gen)
    batches = _batches(cfg)
    tmp = tmp_path_factory.mktemp("pipeline_dense")
    results = spawn(pipeline_run, S * DP * TP, tmp, cfg, SHAPE, *save_inputs(tmp, params, batches),
                    ("direct", "striped"), N_MICRO, STEPS, LR)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), remat="full", dtype=jnp.float32)
    ref_params = jax_tree(convert.to_reference(params))
    ref = reference_microbatch_mean(ref_cfg, ref_params, {k: v.numpy() for k, v in batches[0].items()}, S,
                                    N_MICRO * DP)
    return {"cfg": cfg, "params": params, "batches": batches, "results": results, "ref": ref}


@pytest.mark.parametrize("boundary", ["striped", "direct"])
def test_loss_and_gradients_match_the_reference(run, boundary):
    hold_against_reference(run["results"], run["ref"], "layers", boundary, REF_TOL)


def test_striped_and_direct_give_the_same_numbers_bit_for_bit(run):
    hold_boundaries_equal(run["results"])


def test_bytes_each_rank_puts_on_each_link(run):
    """Per call: a boundary sends n_micro activations (c, T, d) of f32 forward
    from stage 0 and as many gradients backward from stage 1; ``striped`` 1/TP
    of each, all-gathered over ``model`` by the receiving rank.  The layer
    gradients go once over ``data``, ``rest``'s over ``data`` and ``pod``, the
    loss over both, the squared norm over ``pod``."""
    cfg = run["cfg"]
    act = N_MICRO * (BATCH // (N_MICRO * DP)) * SEQ * cfg.d_model * 4
    flat = convert.flatten(run["params"])
    layer_bytes = sum(t.numel() for p, t in flat.items() if p.startswith("layers/")) // S * 4
    rest_bytes = sum(t.numel() for p, t in flat.items() if not p.startswith("layers/")) * 4
    for r in run["results"]:
        d, s = r["runs"]["direct"]["bytes"], r["runs"]["striped"]["bytes"]
        assert d["pod"]["send"] == act and s["pod"]["send"] * TP == act
        assert d["model"]["all_gather"] == 0 and s["model"]["all_gather"] == act // TP
        for b in (d, s):
            assert b["data"]["all_reduce"] == layer_bytes + rest_bytes + 4
            assert b["pod"]["all_reduce"] == rest_bytes + 4 + 4
            assert b["model"]["send"] == b["data"]["send"] == b["model"]["all_reduce"] == 0


def test_two_train_steps_match_gradient_accumulation(run):
    """The pipelined step against ``accum_steps = n_micro * DP`` (chunk
    m * DP + d is microbatch m's data shard d): the losses and norms of both
    steps and both moments of every leaf; what the steps moved each parameter,
    within UPDATE_TOL of accumulation's where |mu| > MU_FLOOR max|mu| a leaf,
    and within two steps' largest update, 2 lr, everywhere (where mu is near 0
    the update mu / sqrt(nu) follows the last bits of the gradient)."""
    cfg = run["cfg"]
    params = {k: v.clone() for k, v in convert.flatten(run["params"]).items()}
    params = convert.unflatten(params)
    step = make_train_step(build_model(cfg).loss, OptimizerConfig(peak_lr=LR, warmup_steps=1, total_steps=STEPS),
                           accum_steps=N_MICRO * DP)
    state = init_opt_state(params)
    losses, norms = [], []
    for b in run["batches"]:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    flat_p, mu, nu = (convert.flatten(t) for t in (params, state.mu, state.nu))
    flat0 = convert.flatten(run["params"])
    for r in run["results"]:
        np.testing.assert_allclose(r["losses"], losses, rtol=ACC_TOL)
        np.testing.assert_allclose(r["grad_norms"], norms, rtol=ACC_TOL)
        stage = r["coords"]["pod"]
        for path, got in r["params"].items():
            rows = slice(*stage_layer_range(cfg.num_layers, S, stage)) if path.startswith("layers/") else slice(None)
            for name, want_tree, have in (("mu", mu, r["mu"]), ("nu", nu, r["nu"])):
                want = want_tree[path][rows]
                assert (have[path] - want).abs().max() <= ACC_TOL * want.abs().max(), (name, path)
            moved, want = got - flat0[path][rows], (flat_p[path].detach() - flat0[path])[rows]
            assert (moved - want).abs().max() <= 2 * LR * STEPS, path
            m = mu[path][rows].abs()
            keep = m > MU_FLOOR * m.max()
            assert torch.where(keep, moved - want, 0.0).abs().max() <= UPDATE_TOL * want.abs().max(), path


def test_rest_is_bit_equal_on_every_rank_after_the_steps(run):
    first = run["results"][0]
    for r in run["results"][1:]:
        for path, t in r["params"].items():
            if not path.startswith("layers/"):
                assert torch.equal(t, first["params"][path]), (r["coords"], path)
            elif r["coords"]["pod"] == first["coords"]["pod"]:
                assert torch.equal(t, first["params"][path]), (r["coords"], path)
