"""``wan_projection`` of the port's dry-run against the reference's
(``repro/launch/dryrun.py``): the same dict, every float equal with ``==``,
for each WAN preset x drift x fleet size x failure, the bad ``fail`` strings
raising the same ``ValueError`` text, and a traced projection whose exported
Chrome trace is byte-equal.  Also ``head_aligned_tp``, the relayout's degree.

The reference's dry-run runs in one subprocess (``ref``), never in the test
process: importing it sets ``XLA_FLAGS`` to 512 host devices, which every JAX
process a worker starts later would inherit, and its literals would join the
constants that Hypothesis biases its draws with in every later test of the
worker (``test_torch_sim_simulator.py::test_random_specs`` among them)."""
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile

import pytest

from repro.configs import get_config as REF_CONFIG
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun as port
from torch_sim_helpers import PORT, REF, plain

HERE = pathlib.Path(__file__).resolve().parent
PRESETS = ("azure", "skewed", "star", "chain")
DCN_BYTES = (3_330_310_160.0, 16_777_216.0)  # GPT-A's striped step at (2, 16, 16), and one microbatch's part
BAD_FAILS = ("us-west", "nowhere@600", "@", "us-west@")
TRACED = ("azure", "star")


def _fails(preset):
    names = REF.topology.preset(preset).dc_names
    good = [f"{names[0]}@600", f"{names[-1]}@0.5"] if names else []
    return [None] + good


def _cases():
    """(preset, dcn bytes, keywords) of every projection compared."""
    return [(preset, dcn, dict(drift=drift, fleet_jobs=fleet, fail=fail))
            for preset in PRESETS for dcn in DCN_BYTES for drift in (None, "outage")
            for fleet in (0, 2, 3, 8) for fail in _fails(preset)]


def _outcome(fn):
    try:
        return "ok", plain(fn())
    except ValueError as e:
        return "ValueError", str(e)


def _traced(m, mod, preset, path):
    """(the projection, the trace's checked events, the exported trace's bytes)
    of one traced projection through package ``m``'s tracer."""
    tracer = m.obs.RecordingTracer()
    res = mod.wan_projection(DCN_BYTES[0], preset, drift="outage", fleet_jobs=3, tracer=tracer,
                             trace_label="gpt_a_train_4k_multi_striped")
    m.obs.write_chrome_trace(tracer, str(path), label="dryrun-wan")
    return plain(res), m.validate.check_trace(tracer), pathlib.Path(path).read_bytes()


def reference_outcomes(out_path: str) -> None:
    """Every outcome the tests compare, from the reference's dry-run, pickled
    to ``out_path``.  Runs in the subprocess ``ref`` starts."""
    import repro.launch.dryrun as mod

    out = {"projection": [_outcome(lambda: mod.wan_projection(dcn, preset, **kw)) for preset, dcn, kw in _cases()],
           "bad": {fail: _outcome(lambda: mod.wan_projection(1e9, "azure", fail=fail)) for fail in BAD_FAILS},
           "tp": {arch: mod.head_aligned_tp(REF_CONFIG(arch)) for arch in ARCHS}}
    with tempfile.TemporaryDirectory() as d:
        out["traced"] = {preset: _traced(REF, mod, preset, os.path.join(d, "trace.json")) for preset in TRACED}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": os.pathsep.join([str(HERE.parent / "src"), str(HERE)])}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("wan") / "reference.pkl"
    before = set(sys.modules)
    code = f"import test_torch_dryrun_wan as t; t.reference_outcomes({str(path)!r})"
    r = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(path, "rb") as f:
        out = pickle.load(f)
    out["imported_here"] = sorted(set(sys.modules) - before)  # what running the reference's dry-run added here
    return out


def test_the_reference_s_dry_run_stays_out_of_this_process(ref):
    """What this file does, whatever ran before it in the worker (another
    file, ``tests/test_topology.py``, imports the reference's dry-run in
    process): its fixture's subprocess adds no module to this process, and a
    fresh interpreter that imports this file and the port's dry-run has not
    imported the reference's."""
    assert not [m for m in ref["imported_here"] if m.startswith("repro.")], ref["imported_here"]
    code = ("import sys, test_torch_dryrun_wan, repro_torch.launch.dryrun; "
            "assert 'repro.launch.dryrun' not in sys.modules, 'imported'")
    r = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.parametrize("preset", PRESETS)
def test_projection_equals_the_reference_s(ref, preset):
    for (p, dcn, kw), want in zip(_cases(), ref["projection"]):
        if p == preset:
            got = _outcome(lambda: port.wan_projection(dcn, p, **kw))
            assert got == want and got[0] == "ok", (p, dcn, kw)


@pytest.mark.parametrize("fail", BAD_FAILS)
def test_bad_failures_raise_the_reference_s_error(ref, fail):
    got = _outcome(lambda: port.wan_projection(1e9, "azure", fail=fail))
    want = ref["bad"][fail]
    assert got == want and got[0] == "ValueError", (got, want)


@pytest.mark.parametrize("preset", TRACED)
def test_traced_projection_exports_the_reference_s_bytes(ref, preset, tmp_path):
    got, want = _traced(PORT, port, preset, tmp_path / "trace.json"), ref["traced"][preset]
    assert got == want
    assert want[1] > 0 and want[0]["trace"]["iteration_ms"] > 0


def test_head_aligned_tp_is_the_reference_s(ref):
    for arch in ARCHS:
        assert port.head_aligned_tp(get_config(arch)) == ref["tp"][arch], arch
