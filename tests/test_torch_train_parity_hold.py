"""``chip_smoke.hold_train_parity``'s limits, fed made-up gradient gaps on the
CPU (the gaps themselves are measured only on the card).

Without a control every leaf is held at TRAIN_PARITY_TOL.  With a control
(Zamba2's bf16 step) each leaf is held at twice the control's gap on the same
leaf plus HYBRID_GRAD_SLACK, never above HYBRID_GRAD_CAP: a zeroed or doubled
gradient reads 1.0 and a halved one 0.5, and each must fail on any leaf."""
import sys
import types
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

BF16 = types.SimpleNamespace(dtype=torch.bfloat16)
# Gaps shaped like Zamba2's bf16 step: a leaf the control parts far from the
# plain path, one it barely does, one in between
CONTROL = {"groups/gate": 0.56, "lm_head": 0.05, "embed": 0.40}
KERNEL = {"groups/gate": 0.32, "lm_head": 0.03, "embed": 0.25}


def _hold(monkeypatch, rel: dict, control) -> None:
    gaps = {"finite": True, "loss_rel_diff": 1e-4, "grad_rel_diff": rel, "grad_rel_diff_max": max(rel.values()),
            "grad_rel_diff_worst_leaf": max(rel, key=rel.get)}
    if control is not None:
        gaps["control"] = {"grad_rel_diff": control, "grad_rel_diff_max": max(control.values())}
    monkeypatch.setattr(chip_smoke, "parity_gaps", lambda *a: gaps)
    monkeypatch.setattr(chip_smoke, "release", lambda: None)
    monkeypatch.setattr(chip_smoke, "emit", lambda result: None)
    chip_smoke.hold_train_parity("p", [("bf16", BF16, 8, None if control is None else ("c", None))], {})


def test_the_readings_within_their_limits_pass(monkeypatch):
    _hold(monkeypatch, KERNEL, CONTROL)
    _hold(monkeypatch, {k: 0.04 for k in KERNEL}, None)


@pytest.mark.parametrize("gap", [1.0, 0.5], ids=["zeroed_or_doubled", "halved"])
@pytest.mark.parametrize("leaf", sorted(KERNEL))
def test_a_wrong_leaf_fails_against_the_control(monkeypatch, leaf, gap):
    with pytest.raises(AssertionError, match=leaf):
        _hold(monkeypatch, {**KERNEL, leaf: gap}, CONTROL)


def test_each_leaf_is_held_at_its_own_control_reading(monkeypatch):
    # 0.2 is within twice the worst control leaf, not within lm_head's own 2 x 0.05 + 0.05
    with pytest.raises(AssertionError, match="lm_head"):
        _hold(monkeypatch, {**KERNEL, "lm_head": 0.2}, CONTROL)


def test_without_a_control_every_leaf_keeps_the_tolerance(monkeypatch):
    with pytest.raises(AssertionError, match="embed"):
        _hold(monkeypatch, {k: 0.04 for k in KERNEL} | {"embed": 0.06}, None)
