"""The dry-run's modules stand alone as the rest of the port does: they import
where ``jax`` and ``repro`` cannot be imported, the launcher runs a
combination from the command line, and the report script renders what it
wrote.  (``test_torch_hygiene.py``'s per-file cases cover their imports and
finished kernels, file by file.)"""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
NEW = ("repro_torch.kernels.cost", "repro_torch.launch.shapes", "repro_torch.launch.dryrun",
       "repro_torch.launch.roofline")
# the float ranges ``test_torch_sim_simulator.py::test_random_specs`` draws from
# (t_fwd_ms, act_bytes); Hypothesis biases a draw with the float literals of
# every loaded module of the repo that lies in its range (small ints it
# weights anyway), so a module that a test worker may load adds none that the
# simulator's copy, which that test always loads, lacks
DRAWN = ((0.5, 80.0), (1e5, 3e8))
# what a worker can load of the port's dry-run: its modules, the kernel modules
# they reach, and the scripts that import them
LOADED = [ROOT / "src" / "repro_torch" / f for f in (
    "kernels/cost.py", "kernels/rmsnorm.py", "kernels/flash_attention.py", "kernels/decode_attention.py",
    "kernels/wkv6.py", "kernels/ops.py", "launch/shapes.py", "launch/dryrun.py", "launch/roofline.py",
    "parallel/transport.py", "parallel/pipeline.py", "parallel/data_parallel.py", "parallel/sharding.py",
    "parallel/tensor_parallel.py")] + [ROOT / "experiments" / "torch_make_report.py",
                                                          ROOT / "chip_smoke.py"]

_BLOCKED = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import importlib
for name in %r:
    importlib.import_module(name)
from repro_torch.launch import dryrun
r = dryrun.wan_projection(1e9, "azure", drift="outage", fleet_jobs=3, fail="us-west@600")
assert set(r) >= {"drift", "fleet", "failure"}
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
print("imported")
""" % (NEW,)


def _drawn_floats(path: pathlib.Path) -> set:
    """The float literals of a file in DRAWN's ranges, signed as Hypothesis reads them."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) and isinstance(node.operand, ast.Constant):
            value = -node.operand.value if isinstance(node.operand.value, float) else None
        else:
            value = node.value if isinstance(node, ast.Constant) and isinstance(node.value, float) else None
        if value is not None and any(lo <= value <= hi for lo, hi in DRAWN):
            out.add(value)
    return out


@pytest.mark.parametrize("path", LOADED, ids=lambda p: p.name)
def test_no_float_literal_that_would_shift_the_simulator_s_random_specs(path):
    core = set().union(*(_drawn_floats(f) for f in (ROOT / "src" / "repro_torch" / "core").glob("*.py")))
    assert _drawn_floats(path) <= core, sorted(_drawn_floats(path) - core)


def _env():
    return {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}


def test_the_dry_run_imports_where_jax_and_repro_cannot_be_imported():
    r = subprocess.run([sys.executable, "-c", _BLOCKED], capture_output=True, text=True, timeout=120, env=_env())
    assert r.returncode == 0 and "imported" in r.stdout, r.stderr


def test_the_launcher_writes_a_combination_and_the_report_renders_it(tmp_path):
    out = tmp_path / "dryrun"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "zamba2-2.7b", "--shape",
                        "decode_32k", "--mesh", "multi", "--out", str(out), "--wan-preset", "skewed",
                        "--trace", str(tmp_path / "t.json")], capture_output=True, text=True, timeout=300,
                       env=_env(), cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert "[ok] zamba2_2p7b_decode_32k_multi_striped" in r.stdout and "[trace]" in r.stdout
    res = json.loads((out / "zamba2_2p7b_decode_32k_multi_striped.json").read_text())
    assert res["status"] == "ok" and res["program"] == "replica" and res["wan"]["topology"]
    # cached: a second run reads the file and writes nothing
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "zamba2-2.7b", "--shape",
                        "decode_32k", "--mesh", "multi", "--out", str(out)], capture_output=True, text=True,
                       timeout=300, env=_env(), cwd=str(tmp_path))
    assert r.returncode == 0 and "[cached]" in r.stdout
    r = subprocess.run([sys.executable, str(ROOT / "experiments" / "torch_make_report.py"), "--dir", str(out)],
                       capture_output=True, text=True, timeout=120, env=_env())
    assert r.returncode == 0, r.stderr
    assert "| zamba2_2p7b | decode_32k | multi | replica |" in r.stdout and "H100" in r.stdout
    assert "ok=1 skipped=0 errors=0" in r.stdout


def test_the_trace_flag_wants_a_wan_preset(tmp_path):
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--trace", str(tmp_path / "t.json")],
                       capture_output=True, text=True, timeout=120, env=_env(), cwd=str(tmp_path))
    assert r.returncode != 0 and "--trace requires --wan-preset" in r.stderr
