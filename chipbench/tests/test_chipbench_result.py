"""The result line's keys, the refusal of a machine with no card, and of a
checkout that holds only the benchmark."""
import json
import shutil
import subprocess
import sys

import pytest

import chipbench_cpu as cpu
from chipbench import run as bench_run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["gpta-stage-train", "rwkv6-stage-train", "gpta-prefill-ragged"])
@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line_has_the_contract_keys(cell, trace):
    c = cpu.small_cell(cell)
    result = cpu.drive(c, trace=trace)
    result.pop("_run")
    line = json.loads(json.dumps(result))
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks" and set(line["checks"]) and ("breakdown" in line) == trace
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:  # every end-to-end metric of the cell is read on the CPU too
        assert set(line["metrics"]) == names
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_a_machine_without_a_card_is_refused(capsys):
    rc = bench_run.main(["--workload", "gpta-stage-train", "--seed", str(2**31 + 9), "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_a_checkout_of_the_benchmark_alone_is_refused(tmp_path):
    shutil.copy(cpu.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cpu.ROOT / "chipbench", tmp_path / "chipbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "chipbench/run.py", "--workload", "gpta-stage-train", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
