"""The port's ``obs/`` (tracer, emitters, export, second-witness check,
metrics, stats-key schema, CLI) against the reference's: the same simulation
traced in both packages gives equal events, byte-equal Chrome traces, equal
metrics and the same CLI text; the copy's own ``TraceMismatch`` on a corrupted
trace."""
import dataclasses
import subprocess
import sys

import pytest

from torch_sim_helpers import PORT, REF, ROOT, job, plain, same, world


def test_compares_the_port_files_and_registry():
    for name in ("tracer", "schema", "metrics", "crosscheck", "export", "emit", "cli"):
        assert "/src/repro_torch/obs/" in getattr(PORT, name).__file__
    assert PORT.obs.REGISTRY is not REF.obs.REGISTRY
    assert plain(PORT.obs.REGISTRY, "repro_torch") == plain(REF.obs.REGISTRY, "repro")
    assert PORT.obs.conformance_errors() == REF.obs.conformance_errors() == []
    assert PORT.obs.__all__ == REF.obs.__all__


def traced_sim(m, policy="atlas"):
    w = world(m)
    j = job(m)
    plan = m.dc_selection.best_plan(m.dc_selection.algorithm1(dataclasses.replace(j, topology=w),
                                                              {d: 4 for d in w.dc_names}, P=6, C=1))
    tr = m.obs.RecordingTracer()
    res = m.simulator.simulate(m.control.plan_spec(j, plan, w), w, policy=policy, n_pipelines=2, validate=True,
                               tracer=tr, trace_label="sim")
    return tr, res


def traced_horizon(m):
    w = world(m)
    bw = w.link(0, 1).bw_gbps
    live = w.with_bandwidth_schedules({(0, 1): m.wan.BandwidthSchedule.outage(bw, 10_000.0, 200_000.0, bw / 10.0),
                                       (1, 0): m.wan.BandwidthSchedule.flat(bw)})
    tr = m.obs.RecordingTracer()
    hz = m.control.simulate_horizon(job(m), {d: 4 for d in w.dc_names}, P=10, live_topo=live, planned_topo=w,
                                    n_iterations=30, C=1, control=m.control.ControlConfig(), validate=True,
                                    tracer=tr, trace_label="jobA")
    return tr, hz


def traced_fleet(m):
    """Host, contender and the prefill service: the busiest emission path."""
    B = m.bubbletea
    j = job(m, act_bytes=6e7)
    arr = B.ArrivalProcess(rate_per_s=15.0, horizon_ms=15_000.0, seed=7)
    reqs = arr.generate(B.PromptMix(lengths=(512, 1024), weights=(0.5, 0.5)), tiers={"gold": 0.3, "best_effort": 0.7})
    svc = m.fleet.PrefillService(host_job="A", arrivals=reqs,
                                 model=B.InferenceModelSpec("m", num_params=8e9, kv_bytes_per_token=16384.0),
                                 decode_dc="c", tiers={"gold": 1_200.0, "best_effort": 8_000.0})
    tr = m.obs.RecordingTracer()
    fr = m.fleet.simulate_fleet([m.fleet.FleetJob("A", j, {"a": 2, "b": 2, "c": 2}, P=6, n_iterations=3, C=1),
                                 m.fleet.FleetJob("B", j, {"a": 2, "b": 2}, P=4, n_iterations=3, C=1)],
                                world(m), prefill=svc, validate=True, tracer=tr)
    return tr, fr


def traced_schedule(m):
    tr = m.obs.RecordingTracer()
    spec = m.simulator.PipelineSpec(4, 8, 10.0, 2.5e7, (0, 0, 1, 2), 4e8)
    sched = m.temporal.atlas_schedule(spec, m.topology.preset("azure"), 2, tracer=tr, start_ms=5.0)
    return tr, sched


RUNS = {"sim": traced_sim, "sim-varuna": lambda m: traced_sim(m, "varuna"), "horizon": traced_horizon,
        "fleet": traced_fleet, "schedule": traced_schedule}


@pytest.mark.parametrize("run", list(RUNS))
def test_traced_runs(run):
    """Events, the exported trace (byte for byte), the metrics snapshot and
    the second witness's count."""
    def build(m):
        tr, res = RUNS[run](m)
        windows = m.obs.verify_trace(tr) if run != "schedule" else None
        return (tr, res, tr.n_events, m.obs.dump_chrome_trace(tr, label="golden"), m.obs.chrome_trace(tr),
                m.obs.metrics_from_tracer(tr).snapshot().as_dict(), windows)
    _, port = same(build)
    if run != "schedule":
        assert port[-1] > 0


@pytest.mark.parametrize("run", ["sim", "fleet"])
def test_read_back_and_cli(run, tmp_path, capsys):
    """A trace written by the port is byte-equal to the reference's, reads back
    equal in both packages, and the two CLIs print the same text for it."""
    paths = {}
    for m in (REF, PORT):
        tr, _ = RUNS[run](m)
        paths[m.root] = tmp_path / f"{m.root}.json"
        m.obs.write_chrome_trace(tr, str(paths[m.root]))
    assert paths["repro"].read_bytes() == paths["repro_torch"].read_bytes()
    same(lambda m: m.obs.read_chrome_trace(str(paths["repro_torch"])))
    capsys.readouterr()
    for cmd in ("validate", "report"):
        texts = []
        for m in (REF, PORT):
            assert m.cli.main([cmd, str(paths["repro_torch"])]) == 0
            texts.append(capsys.readouterr().out)
        assert texts[0] == texts[1] and texts[0]


def test_cli_rejects_a_busy_span_in_an_outage(tmp_path, capsys):
    def build(m):
        tr = m.obs.RecordingTracer()
        tr.span("outage:dc_outage", m.obs.CAT_CONTROL, "job/control", "failures", 1000.0, 5000.0, dc="b",
                dc_index=1)
        tr.span("fwd", m.obs.CAT_GPU, "job/gpu", "p0/s0", 2000.0, 2500.0, pipeline=0, stage=0, dc=1)
        path = tmp_path / f"bad-{m.root}.json"
        m.obs.write_chrome_trace(tr, str(path))
        errors = m.cli.validate_trace_file(str(path))
        assert m.cli.main(["validate", str(path)]) == 1
        return errors, capsys.readouterr().err
    _, (errors, err) = same(build)
    assert errors and any("dead dc" in e for e in errors) and "INVALID" in err


def test_module_entry_point(tmp_path):
    tr, _ = traced_sim(PORT)
    path = tmp_path / "t.json"
    PORT.obs.write_chrome_trace(tr, str(path))
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs", "validate", str(path)], capture_output=True,
                       text=True, timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0 and r.stdout.startswith("OK:"), r.stderr


def test_corrupted_span_raises_the_copys_mismatch():
    messages = []
    for m in (REF, PORT):
        tr, _ = traced_sim(m)
        i = next(i for i, s in enumerate(tr.spans) if s.name in m.obs.BUSY_KINDS)
        tr.spans[i] = dataclasses.replace(tr.spans[i], t1_ms=tr.spans[i].t1_ms + 7.0)
        with pytest.raises(m.obs.TraceMismatch) as err:
            m.obs.verify_trace(tr)
        other = REF if m is PORT else PORT
        assert not isinstance(err.value, other.obs.TraceMismatch)
        with pytest.raises(m.validate.InvariantViolation):
            m.validate.check_trace(tr)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_null_tracer_and_stats_keys():
    def build(m):
        w = world(m)
        spec = m.simulator.PipelineSpec(4, 256, 10.0, 1e7, (0, 0, 1, 2), 2e8)
        bare = m.simulator.simulate(spec, w, validate=True, tracer=m.obs.NullTracer())
        ff = m.simulator.simulate(spec, w, validate=True, fast_forward=True)
        _, hz = traced_horizon(m)
        _, fr = traced_fleet(m)
        return (bare, ff.stats, [m.obs.unregistered_keys(s, d) for s, d in
                                 ((bare.stats, "sim"), (ff.stats, "sim"), (hz.stats, "horizon"), (fr.stats, "fleet"))])
    _, port = same(build)
    assert port[0].transfers is None and port[1]["fast_forward"] is True
    assert port[2] == [[], [], [], []]
