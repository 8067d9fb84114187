"""The lint passes of ``repro.analysis`` over the port's copy of the simulator.

The determinism, units and schema passes key on the paths ``repro/core/``,
``repro/obs/`` and ``repro/units.py``, which ``src/repro_torch/...`` does not
match, so the whole-tree lint would never look at the copy with them.  Here
each copy file is parsed under the path of the reference module it mirrors
and every pass runs over all of them together.  The only findings allowed are
the three inline conversions of ``core/reference.py`` that the reference
itself audits with a suppression on the same line of code.

Also: the copy runs where ``repro`` cannot be imported, every lazy import
inside its functions included."""
import re
import subprocess
import sys

import pytest

from repro.analysis import parse_module, run_passes
from torch_sim_helpers import MODULES, ROOT, module_file

SUPPRESS = re.compile(r"#\s*lint:\s*ok\[([^\]]*)\]")


def _code(line: str) -> str:
    return line.split("#", 1)[0].rstrip()


@pytest.fixture(scope="module")
def findings():
    mods = []
    for name in MODULES:
        copy, ref = module_file("repro_torch", name), module_file("repro", name)
        mods.append(parse_module(str(ref.relative_to(ROOT)), source=copy.read_text()))
    return run_passes(mods)


def audited(ref_path: str):
    """(rule, code) of the reference's own suppressed lines."""
    out = set()
    for line in (ROOT / ref_path).read_text().splitlines():
        m = SUPPRESS.search(line)
        if m:
            out |= {(r.strip(), _code(line)) for r in m.group(1).split(",")}
    return out


@pytest.mark.parametrize("name", list(MODULES))
def test_copy_is_clean_under_the_reference_path(name, findings):
    ref = str(module_file("repro", name).relative_to(ROOT))
    mine = [f for f in findings if f.path == ref]
    lines = module_file("repro_torch", name).read_text().splitlines()
    allowed = audited(ref)
    left = [f for f in mine if (f.rule, _code(lines[f.line - 1])) not in allowed]
    assert left == [], "\n".join(f.render() for f in left)
    assert len(mine) == (3 if name == "core.reference" else 0)


@pytest.mark.parametrize("where,found", [("src/repro/core/planted.py", True),
                                         ("src/repro_torch/core/planted.py", False)])
def test_the_pass_sees_a_planted_fault_only_under_the_reference_path(where, found):
    """Why the copy is parsed under the reference's paths: the same set
    iteration is a finding there and nothing under the copy's own path."""
    src = "def order(xs):\n    out = []\n    for x in set(xs):\n        out.append(x)\n    return out\n"
    rules = [f.rule for f in run_passes([parse_module(where, source=src)])]
    assert ("det/set-iteration" in rules) == found


_ISOLATED = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import os, tempfile
from repro_torch import obs
from repro_torch.core import control, fleet, reference, simulator, temporal, topology, validate, wan
from repro_torch.core.bubbletea import ArrivalProcess, InferenceModelSpec
from repro_torch.core.dc_selection import JobModel
from repro_torch.core.fastforward import fast_forward_gate
from repro_torch.obs.__main__ import report

t = topology.preset("azure")
spec = simulator.PipelineSpec(4, 200, 10.0, 2.5e7, (0, 0, 1, 2), 4e8)
for policy in simulator.POLICIES:
    simulator.simulate(spec, t, policy=policy, n_pipelines=2, validate=True, fast_forward=True)
    validate.check_policy(spec, t, policy, 2)
    validate.check_fast_forward(spec, t, policy, 1)
    reference.simulate(spec, t, policy=policy, n_pipelines=2)
tr = obs.RecordingTracer()
simulator.simulate(spec, t, policy="varuna", validate=True, tracer=tr)
temporal.atlas_schedule(spec, t, 2, tracer=tr)
validate.check_atlas_consistency(spec, t, 2)
assert validate.check_trace(obs.RecordingTracer()) == 0
fast_forward_gate(spec, t)
w = topology.TopologyMatrix.from_latency([[0, 20, 20], [20, 0, 20], [20, 20, 0]], dc_names=("a", "b", "c"))
job = JobModel(10.0, 1e7, 2e8, 24)
tr = obs.RecordingTracer()
control.simulate_horizon(job, {"a": 4, "b": 4, "c": 4}, P=6, live_topo=w, n_iterations=4, C=1,
                         control=control.ControlConfig(), validate=True, tracer=tr)
svc = fleet.PrefillService("A", ArrivalProcess(20.0, 2_000.0, seed=1).generate(), InferenceModelSpec("m", 8e9), "c")
fleet.simulate_fleet([fleet.FleetJob("A", job, {"a": 2, "b": 2, "c": 2}, P=6, n_iterations=2, C=1)], w,
                     prefill=svc, validate=True, tracer=tr)
validate.check_trace(tr)
path = os.path.join(tempfile.mkdtemp(), "t.json")
obs.write_chrome_trace(tr, path)
report(path)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
print("ran")
"""


def test_the_copy_runs_where_repro_cannot_be_imported(tmp_path):
    """Every function with an import inside its body runs with ``repro``
    blocked: a lazy import left pointing at the reference fails here."""
    r = subprocess.run([sys.executable, "-c", _ISOLATED], capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path)})
    assert r.returncode == 0 and "ran" in r.stdout, r.stderr[-3000:]
