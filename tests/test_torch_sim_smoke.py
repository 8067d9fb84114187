"""``chip_smoke.py``'s phase ``simulate`` on the CPU: its fig 9 grid, fig 13
scenario and traced run give bit for bit what the same functions give over the
reference's ``repro.core`` and ``repro.obs``, and the phase prints its line.
On the card the phase runs the port's copy alone."""
import json
import sys
from pathlib import Path

from torch_sim_helpers import PORT, same

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_phase_runs_the_port_copy():
    assert chip_smoke.simulator is PORT.simulator
    assert chip_smoke.bubbletea is PORT.bubbletea
    assert chip_smoke.obs is PORT.obs


def _with(m, monkeypatch, fn):
    """``fn`` of chip_smoke with its simulator modules taken from ``m``."""
    monkeypatch.setattr(chip_smoke, "simulator", m.simulator)
    monkeypatch.setattr(chip_smoke, "bubbletea", m.bubbletea)
    monkeypatch.setattr(chip_smoke, "obs", m.obs)
    try:
        return fn()
    finally:
        monkeypatch.undo()


def test_fig9_grid_equals_the_references(monkeypatch):
    _, port = same(lambda m: _with(m, monkeypatch, chip_smoke.fig9_speedups))
    assert len(port) == 48 and min(port.values()) > 1.0


def test_fig13_equals_the_references(monkeypatch):
    _, port = same(lambda m: _with(m, monkeypatch, chip_smoke.fig13_bubbletea))
    assert port["placements"] > 0 and port["utilization_with_bubbletea"] > port["utilization_atlas"]


def test_traced_run_equals_the_references(monkeypatch):
    same(lambda m: _with(m, monkeypatch, chip_smoke.traced_simulation))


def test_phase_prints_its_line(capsys):
    chip_smoke.phase_simulate()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "simulate" and line["note"] == chip_smoke.SIM_NOTE
    assert line["fig13"]["placements"] > 0 and line["trace"]["windows_verified"] == 1
