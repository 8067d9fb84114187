"""``repro_torch.examples.train_100m`` against the reference's
``examples/train_100m.py`` at 2 steps of 1 x 32 on the CPU, both from the
reference's ``PRNGKey(0)`` parameters (the port's converted): ``CFG_100M``
equals the reference's field by field (12 x 512, head size 64, vocabulary
32768); with both modules' ``CFG_100M`` in f32 activations every printed loss
is within f32's relative 1e-5 of the reference's (beyond the 4 printed
decimals; in the configs' bf16 the two frameworks round their activations at
other places, and step 1 parts by 2.1e-5), the loss falls (the example's own
closing assert), and the checkpoint loads in the reference's
``load_pytree``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro.models.transformer import build_model as ref_build_model
from repro_torch.convert import flatten
from repro_torch.examples import train_100m
from torch_example_helpers import PRINTED_4, converted, printed_losses, reference_example

ARGS = ["--steps", "2", "--batch", "1", "--seq", "32"]
LOSS_RTOL = 1e-5  # f32: the two frameworks sum in other orders (test_torch_loss.py)


def test_cfg_100m_is_the_reference_s_field_by_field():
    ref = reference_example("train_100m").CFG_100M
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(train_100m.CFG_100M, f.name)
        if isinstance(b, torch.dtype):
            assert np.dtype(a).name == str(b).removeprefix("torch."), f.name
        else:
            assert a == b, f.name
    assert {f.name for f in dataclasses.fields(ref)} == {f.name for f in dataclasses.fields(train_100m.CFG_100M)}
    assert (ref.num_layers, ref.d_model, ref.head_dim, ref.vocab_size) == (12, 512, 64, 32768)
    assert train_100m.CFG_100M.param_count() == ref.param_count()


def test_train_100m_trains_and_checkpoints_as_the_reference(tmp_path, monkeypatch, capsys):
    ref = reference_example("train_100m")
    monkeypatch.setattr(ref, "CFG_100M", dataclasses.replace(ref.CFG_100M, dtype=jnp.float32))
    monkeypatch.setattr(train_100m, "CFG_100M", dataclasses.replace(train_100m.CFG_100M, dtype=torch.float32))
    ref_params, params = converted(ref_build_model(ref.CFG_100M), train_100m.CFG_100M)
    ref.main(ARGS + ["--ckpt-dir", str(tmp_path / "ref")])
    want = printed_losses(capsys.readouterr().out)
    got = train_100m.main(ARGS + ["--ckpt-dir", str(tmp_path / "port")], device="cpu", params=params)
    out = capsys.readouterr().out

    assert len(want) == 2 and printed_losses(out) == [round(v, 4) for v in got["losses"]]
    for g, w in zip(got["losses"], want):
        assert abs(g - w) <= PRINTED_4 + LOSS_RTOL * abs(w), (g, w)
    assert got["losses"][-1] < got["losses"][0]
    assert got["checkpoint"] == str(tmp_path / "port" / "step_00000002.npz")
    loaded = flatten(jax.tree.map(np.asarray, ref_ckpt.load_pytree(got["checkpoint"], {"params": ref_params})["params"]))
    trained = flatten(params)  # the example trained them in place and saved them
    assert set(loaded) == set(trained)
    for k, v in trained.items():
        assert np.array_equal(loaded[k], v.detach().numpy()), k
