"""``repro_torch.examples.quickstart`` against the reference's
``examples/quickstart.py`` at 10 steps, on the CPU, both from the reference's
``PRNGKey(0)`` smoke GPT-A (the port's converted): every printed loss within
relative 1e-5 of the reference's (beyond the 4 printed decimals), the served
requests' tokens equal, and the checkpoint it writes loads in the reference's
``load_pytree``."""
import contextlib

import jax
import numpy as np

from repro.ckpt import checkpoint as ref_ckpt
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.transformer import build_model as ref_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.convert import flatten
from repro_torch.examples import quickstart
from torch_example_helpers import PRINTED_4, converted, printed_losses, reference_example

STEPS = 10
LOSS_RTOL = 1e-5  # relative, beyond the printed digits: the losses are f32 sums over bf16 activations
PRINTED_STEPS = [0, STEPS - 1]  # the example prints every 25th step and the last


def _tokens(out: str) -> list:
    return [line.split("tokens=")[1] for line in out.splitlines() if line.startswith("req ")]


def test_quickstart_trains_checkpoints_and_serves_as_the_reference(tmp_path, monkeypatch, capsys):
    ref_params, params = converted(ref_build_model(ref_smoke_config("gpt_a")), get_smoke_config("gpt_a"))
    reference_example("quickstart").main(steps=STEPS)
    want = capsys.readouterr().out

    kept = tmp_path / "ckpt"

    class KeptDirectory:  # the example's temporary directory, kept for the reference to read
        @staticmethod
        def TemporaryDirectory():
            kept.mkdir()
            return contextlib.nullcontext(str(kept))

    monkeypatch.setattr(quickstart, "tempfile", KeptDirectory)
    got = quickstart.main(steps=STEPS, device="cpu", params=params)
    out = capsys.readouterr().out

    assert len(got["losses"]) == STEPS
    ref_losses = printed_losses(want)
    assert printed_losses(out) == [round(got["losses"][i], 4) for i in PRINTED_STEPS]
    for i, ref in zip(PRINTED_STEPS, ref_losses):
        assert abs(got["losses"][i] - ref) <= PRINTED_4 + LOSS_RTOL * abs(ref), (i, got["losses"][i], ref)
    assert len(_tokens(want)) == 4 and _tokens(out) == _tokens(want)
    assert "checkpoint round-trip: ok" in out

    (path,) = kept.glob("step_*.npz")
    loaded = flatten(jax.tree.map(np.asarray, ref_ckpt.load_pytree(str(path), {"params": ref_params})["params"]))
    trained = flatten(params)  # the example trained them in place and saved them
    assert set(loaded) == set(trained)
    for k, v in trained.items():
        assert loaded[k].dtype == np.float32 and np.array_equal(loaded[k], v.detach().numpy()), k
