"""Checkpoints of the train launcher and runs continued from them, on the CPU:
the launcher's layout against the reference's launcher code and the
reference's keys; a run continued across packages (the reference saves, the
port goes on, and the reverse) against the uninterrupted run; and the port's
own resume, bit for bit.  The reference's side is its jitted ``make_train_step``
without a mesh and its checkpoint functions called directly."""
import dataclasses
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.ckpt import checkpoint as ref_ckpt
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import make_batches as ref_make_batches
from repro.models.transformer import build_model as ref_build_model
from repro.optim import optimizer as ref_opt
from repro_torch import configs, convert
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.launch import train as train_mod
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizer import init_opt_state, make_train_step
from torch_helpers import reference_params

STEPS, BATCH, SEQ, LR = 8, 8, 32, 3e-3
SPLIT = 4  # the reference's checkpoint holds the state after 4 updates
# across packages, f32: the test_torch_train.py tolerance of the loss
LOSS_RTOL = 1e-5


def _configs():
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("gpt_a"), dtype=jnp.float32)
    return ref_cfg, dataclasses.replace(configs.get_smoke_config("gpt_a"), dtype=torch.float32)


def _ref_step(ref_cfg):
    ocfg = ref_opt.OptimizerConfig(peak_lr=LR, warmup_steps=min(20, STEPS // 5 + 1), total_steps=STEPS)
    return jax.jit(ref_opt.make_train_step(ref_build_model(ref_cfg).loss, ocfg))


def _ref_batches(ref_cfg, start=0):
    data = ref_make_batches(ref_cfg, RefDataConfig(seed=0, batch_size=BATCH, seq_len=SEQ), num_steps=STEPS)
    return itertools.islice(data, start, None)


def _ref_run(ref_cfg, params, opt, start=0, stop=STEPS):
    """Losses of the reference's steps ``start`` .. ``stop - 1`` and the state after them."""
    step, losses = _ref_step(ref_cfg), []
    for b in itertools.islice(_ref_batches(ref_cfg, start), stop - start):
        params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, params, opt


def _port_continue(cfg, state):
    """The port's steps from ``opt.step`` to the end, from a restored state."""
    step = make_train_step(build_model(cfg).loss, train_mod.optimizer_config(LR, STEPS))
    params, opt = state["params"], state["opt"]
    data = make_batches(cfg, DataConfig(seed=0, batch_size=BATCH, seq_len=SEQ), num_steps=STEPS)
    losses = []
    for b in itertools.islice(data, int(opt.step), None):
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, params, opt


def _port_like(cfg):
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    return {"params": params, "opt": init_opt_state(params)}


@pytest.mark.parametrize("steps, files", [(5, [2, 4, 5]), (7, [4, 6, 7])])
def test_the_launcher_writes_the_references_layout(tmp_path, steps, files, capsys):
    """--ckpt-dir/--ckpt-every: a save after every step whose loop index is a
    nonzero multiple of --ckpt-every (with its loss), the final one as
    step_<steps> (step only), ``latest``, three kept; every archive with the
    keys, shapes and dtypes of the reference's ``_flatten`` of its train state."""
    d = str(tmp_path / "ck")
    out = train_mod.main(["--device", "cpu", "--arch", "gpt-a", "--smoke", "--steps", str(steps), "--batch", "4",
                          "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "2"])
    names = [f"step_{s:08d}.npz" for s in files]
    assert sorted(os.listdir(d)) == sorted(names + [n + ".json" for n in names] + ["latest"])
    assert open(os.path.join(d, "latest")).read() == names[-1]
    assert f"[train] checkpoint at {os.path.join(d, names[-1])}" in capsys.readouterr().out
    for s, name in zip(files, names):
        meta = json.load(open(os.path.join(d, name + ".json")))
        assert meta == ({"step": steps} if s == steps else {"step": s, "loss": out["history"][s]["loss"]})
        with np.load(os.path.join(d, name)) as z:
            # the reference's naming: a periodic save follows loop index s, so s + 1 updates
            assert int(z["opt/.step"]) == (steps if s == steps else s + 1)
    ref_cfg = ref_configs.get_smoke_config("gpt_a")
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    want = ref_ckpt._flatten({"params": ref_params, "opt": ref_opt.init_opt_state(ref_params)})
    with np.load(os.path.join(d, names[-1])) as z:
        assert set(z.files) == set(want)
        for key, arr in want.items():
            assert z[key].shape == arr.shape and z[key].dtype == arr.dtype, key


def test_a_reference_checkpoint_continues_in_the_port(tmp_path):
    ref_cfg, cfg = _configs()
    ref_params, _ = reference_params(ref_cfg, seed=0)
    want, _, _ = _ref_run(ref_cfg, ref_params, ref_opt.init_opt_state(ref_params))
    _, params, opt = _ref_run(ref_cfg, ref_params, ref_opt.init_opt_state(ref_params), stop=SPLIT)
    p = str(tmp_path / "ref.npz")
    ref_ckpt.save_pytree(p, {"params": params, "opt": opt}, {"step": SPLIT})
    got, _, opt = _port_continue(cfg, ckpt_mod.load_pytree(p, _port_like(cfg)))
    assert int(opt.step) == STEPS and len(got) == STEPS - SPLIT
    np.testing.assert_allclose(got, want[SPLIT:], rtol=LOSS_RTOL)


def test_a_port_checkpoint_continues_in_the_reference(tmp_path):
    ref_cfg, cfg = _configs()
    ref_params, tree = reference_params(ref_cfg, seed=0)
    out = train_mod.train(cfg, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, seed=0, log_every=STEPS, device="cpu",
                          params=convert.from_reference(tree, cfg), ckpt_dir=str(tmp_path), ckpt_every=SPLIT - 1)
    want = [h["loss"] for h in out["history"]]
    p = os.path.join(str(tmp_path), f"step_{SPLIT - 1:08d}.npz")  # after SPLIT updates
    state = ref_ckpt.load_pytree(p, {"params": ref_params, "opt": ref_opt.init_opt_state(ref_params)})
    assert int(state["opt"].step) == SPLIT
    got, _, opt = _ref_run(ref_cfg, state["params"], state["opt"], start=SPLIT)
    assert int(opt.step) == STEPS
    np.testing.assert_allclose(got, want[SPLIT:], rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ["gpt_a", "hubert_xlarge"])
def test_the_ports_resume_is_bit_equal_to_its_uninterrupted_run(tmp_path, arch):
    cfg = configs.get_smoke_config(arch)
    out = train_mod.train(cfg, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, seed=0, log_every=STEPS, device="cpu",
                          ckpt_dir=str(tmp_path), ckpt_every=SPLIT)
    state = ckpt_mod.load_pytree(os.path.join(str(tmp_path), f"step_{SPLIT:08d}.npz"), _port_like(cfg))
    assert int(state["opt"].step) == SPLIT + 1
    got, params, opt = _port_continue(cfg, state)
    assert got == [h["loss"] for h in out["history"]][SPLIT + 1:]
    final = ckpt_mod.load_pytree(out["checkpoint"]["path"], _port_like(cfg))
    live = dict(ckpt_mod._walk({"params": out["params"], "opt": out["opt_state"]}))
    saved = dict(ckpt_mod._walk(final))
    for key, t in ckpt_mod._walk({"params": params, "opt": opt}):
        assert torch.equal(t, live[key]) and torch.equal(t, saved[key]), key
