"""Every ``experiments/torch_*.py`` loads on the CPU.

The experiment scripts measure the port on the card and no other test imports
them, so a helper renamed or removed elsewhere would break one of them
unnoticed.  Each case loads one script with ``importlib`` (its imports and
top-level definitions run, ``main`` does not) and checks that it has a
``main`` to run.
"""
import importlib.util
import sys
from pathlib import Path

import pytest

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
SCRIPTS = sorted(p.name for p in EXPERIMENTS.glob("torch_*.py"))


def test_the_port_has_experiment_scripts():
    assert "torch_train.py" in SCRIPTS and "torch_rwkv_parity.py" in SCRIPTS


@pytest.mark.parametrize("name", SCRIPTS)
def test_experiment_script_loads_without_running(name, monkeypatch):
    # the scripts put the checkout's src/ and root on sys.path; keep that to this case
    monkeypatch.setattr(sys, "path", [str(EXPERIMENTS), *sys.path])
    spec = importlib.util.spec_from_file_location(f"experiment_{Path(name).stem}", EXPERIMENTS / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(getattr(module, "main", None)), f"{name} has no main()"
