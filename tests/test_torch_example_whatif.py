"""``repro_torch.examples.whatif`` against the reference's ``examples/whatif.py``:
the same lines apart from the timed one (the placement search's host
milliseconds) and the trace's path, and with ``--trace`` a byte-equal trace
file.  The copy is pure host code over ``repro_torch.core`` and
``repro_torch.obs``; it launches nothing.  Its command line runs where
``jax`` and ``repro`` cannot be imported, so the imports inside its functions
are the copy's too."""
import subprocess
import sys

from repro_torch.examples import whatif
from torch_example_helpers import ROOT, reference_example

TIMED = "searched 8 DCs in"
BLOCKED_RUN = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.argv = ["whatif", "--trace", sys.argv[1]]
runpy.run_module("repro_torch.examples.whatif", run_name="__main__")
"""


def _lines(out: str, trace_path=None) -> list:
    return [ln.replace(str(trace_path), "<trace>") if trace_path else ln
            for ln in out.splitlines() if TIMED not in ln]


def test_whatif_prints_the_reference_s_lines_and_writes_its_trace(tmp_path, capsys):
    ref_trace, port_trace = tmp_path / "ref.json", tmp_path / "port.json"
    reference_example("whatif").main(trace_path=str(ref_trace))
    out = capsys.readouterr().out
    assert sum(TIMED in ln for ln in out.splitlines()) == 1
    want = _lines(out, ref_trace)

    whatif.main()
    plain = _lines(capsys.readouterr().out)
    assert plain == [ln for ln in want if "[trace]" not in ln]

    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN, str(port_trace)],
                       capture_output=True, text=True, timeout=300, cwd=str(ROOT),
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert _lines(r.stdout, port_trace) == want
    assert port_trace.read_bytes() == ref_trace.read_bytes()
