"""The port's ``core/failures.py`` and ``core/control.py`` against the
reference's: seeded failure traces, the drift detector, migration and restore
pricing, and the horizon co-simulator with drift and with a forced failover,
equal bit for bit (scenarios from ``test_control.py`` and ``test_failures.py``,
kept small)."""
import pytest

from torch_sim_helpers import PORT, job, same, world

NAMES = ("use", "ussc", "usw", "asia")
LAT = [[0, 30, 60, 150], [30, 0, 40, 170], [60, 40, 0, 120], [150, 170, 120, 0]]


def test_compares_the_port_files():
    assert PORT.failures.__file__.endswith("src/repro_torch/core/failures.py")
    assert PORT.control.__file__.endswith("src/repro_torch/core/control.py")
    assert PORT.core.simulate_horizon is PORT.control.simulate_horizon


def world4(m):
    return m.topology.TopologyMatrix.from_latency(LAT, dc_names=NAMES)


def ckpt(m):
    return m.failures.CheckpointPolicy(interval_ms=20_000.0, placement=("use", "usw"), write_bw_gbps=2.0)


@pytest.mark.parametrize("seed", [0, 7, 13, 21])
def test_failure_trace_per_seed(seed):
    def build(m):
        F = m.failures
        w = world4(m)
        a = F.FailureTrace.generate(NAMES, seed=seed, horizon_ms=300_000.0, n_events=5)
        b = F.FailureTrace.generate(NAMES, seed=seed, horizon_ms=250_000.0, n_events=3,
                                    kinds=("dc_outage", "slice_preemption", "link_failure"), residual_frac=0.1)
        return [(t, t.timeline(), t.degraded_windows(w), t.apply_to_topology(w),
                 [t.dead_dcs_at(x) for x in (0.0, 60_000.0, 150_000.0, 299_000.0)], len(t)) for t in (a, b)]
    same(build)


def test_failure_model_pieces():
    def build(m):
        F = m.failures
        w = world4(m)
        tr = F.FailureTrace(events=(
            F.FailureEvent(at_ms=50_000.0, kind="dc_join", dc="asia", gpus=4),
            F.FailureEvent(at_ms=10_000.0, kind="dc_outage", dc="use", recover_ms=5_000.0),
            F.FailureEvent(at_ms=20_000.0, kind="link_failure", pair=("ussc", "usw"), residual_frac=0.2),
        ))
        c = ckpt(m)
        win = F.OutageWindow(t0_ms=1.0, t1_ms=9.0, kind="dc_outage", dc="usw")
        return (tr, tr.timeline(), tr.apply_to_topology(w), c.write_ms(3.2e9), c.alive_placement({"use"}),
                c.alive_placement(set()), win.trace_args(w), win.trace_args(),
                [e.recovery_ms for e in tr.events], [e.degrades_bandwidth for e in tr.events])
    same(build)


def test_drift_detector_and_pricing():
    def build(m):
        C = m.control
        det = C.DriftDetector(C.ControlConfig(drift_threshold=0.15, hysteresis=2))
        fires = [det.observe(d) for d in (0.0, 0.2, 0.3, 0.1, 0.5, 0.6, 0.7)]
        w = world4(m)
        bw = w.link(0, 1).bw_gbps
        live = w.with_bandwidth_schedules({(0, 1): m.wan.BandwidthSchedule.outage(bw, 1_000.0, 9_000.0, bw / 10.0)})
        model = C.MigrationModel(checkpoint=ckpt(m))
        mig = C.plan_migration((0, 0, 1, 2), (0, 2, 2, 3), param_bytes=4e8, dp_replicas_old=2, dp_replicas_new=1,
                               topo=live, at_ms=2_000.0, model=model)
        rest = C.plan_restore((0, 2, 2, 3), placement_idx=(0, 2), param_bytes=4e8, dp_replicas_old=2,
                              dp_replicas_new=1, topo=live, at_ms=2_000.0, model=model)
        j = job(m, topology=w)
        plan = m.dc_selection.best_plan(m.dc_selection.algorithm1(j, {n: 8 for n in NAMES}, P=8, C=1))
        devs = [C.link_deviation(live, w, t0, t0 + 2_000.0) for t0 in (0.0, 500.0, 4_000.0, 9_500.0)]
        return fires, det.fires, mig, rest, C.plan_spec(j, plan, w), model.stage_bytes(1e9), devs
    same(build)


def outage_live(m, w, factor=10.0):
    bw = w.link(0, 1).bw_gbps
    return w.with_bandwidth_schedules({
        (0, 1): m.wan.BandwidthSchedule.outage(bw, 10_000.0, 200_000.0, bw / factor),
        (1, 0): m.wan.BandwidthSchedule.flat(bw),
    })


@pytest.mark.parametrize("reactive", [False, True])
def test_horizon_with_drift(reactive):
    """One direction drops 10x mid-horizon: the static plan and the control
    plane (which re-plans around it)."""
    def build(m):
        w = world(m)
        ctrl = m.control.ControlConfig() if reactive else None
        return m.control.simulate_horizon(job(m), {"a": 4, "b": 4, "c": 4}, P=10, live_topo=outage_live(m, w),
                                          planned_topo=w, n_iterations=40, C=1, control=ctrl, validate=True)
    _, port = same(build)
    assert (port.replans > 0) == reactive


def test_horizon_planned_diurnal_never_replans():
    def build(m):
        w = world(m)
        live = w.with_bandwidth_schedules({(0, 1): m.wan.BandwidthSchedule.diurnal(5.0, 2.0, period_ms=60_000.0)})
        return m.control.simulate_horizon(job(m), {"a": 4, "b": 4, "c": 4}, P=10, live_topo=live, n_iterations=30,
                                          C=1, control=m.control.ControlConfig(drift_threshold=0.15, hysteresis=2),
                                          validate=True)
    same(build)


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_horizon_forced_failover(with_ckpt):
    """A DC outage forces a re-plan off the dead DC (with and without a
    checkpoint to restore from)."""
    def build(m):
        F = m.failures
        w = world4(m)
        trace = F.FailureTrace(events=(F.FailureEvent(at_ms=60_000.0, kind="dc_outage", dc="ussc",
                                                      residual_frac=0.02),))
        return m.control.simulate_horizon(
            job(m, partition_param_bytes=4e8, microbatches=64), {n: 8 for n in NAMES}, P=12, live_topo=w,
            planned_topo=w, n_iterations=48, C=2,
            migration=m.control.MigrationModel(checkpoint=ckpt(m) if with_ckpt else None),
            control=m.control.ControlConfig(), failures=trace, validate=True)
    _, port = same(build)
    assert any(mig.reason == "dc_outage:ussc" for mig in port.migrations)


def test_horizon_seeded_cascade():
    def build(m):
        F = m.failures
        w = world4(m)
        tr = F.FailureTrace.generate(NAMES, seed=13, horizon_ms=250_000.0, n_events=3,
                                     kinds=("dc_outage", "slice_preemption"))
        return m.control.simulate_horizon(
            job(m, partition_param_bytes=4e8, microbatches=64), {n: 8 for n in NAMES}, P=12, live_topo=w,
            planned_topo=w, n_iterations=40, C=2, migration=m.control.MigrationModel(checkpoint=ckpt(m)),
            control=m.control.ControlConfig(), failures=tr, validate=True)
    same(build)
