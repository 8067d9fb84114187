"""The port's ``core/fleet.py`` against the reference's: the channel allocator,
the multi-job fleet with drift cascades and a failure, and BubbleTea's
prefill service riding a job with KV handoffs priced on the shared WAN
(``KVFlows``), equal bit for bit (scenarios from ``test_fleet.py`` and
``test_prefill_fleet.py``, kept small)."""
import pytest

from torch_sim_helpers import PORT, job, same, world


def test_compares_the_port_file():
    assert PORT.fleet.__file__.endswith("src/repro_torch/core/fleet.py")
    assert PORT.core.simulate_fleet is PORT.fleet.simulate_fleet


def test_allocator():
    def build(m):
        F = m.fleet
        t = world(m, 2, ("a", "b"))
        cap = t.effective_bw_gbps(0, 1)
        spec = m.simulator.testbed_spec(hidden=4096, seq_len=4096, micro_batch=1, layers_per_stage=1,
                                        layer_params=412e6, num_stages=4, microbatches=8, stage_dc=[0, 0, 1, 1])
        return ([F._weighted_max_min(e) for e in ([("a", 0.9, 1.0), ("b", 0.9, 1.0)],
                                                  [("a", 0.9, 1.0), ("b", 0.2, 1.0)],
                                                  [("a", 1.0, 2.0), ("b", 1.0, 1.0)])],
                [F.channel_targets({"A": {(0, 1): x * cap}, "B": {(0, 1): y * cap}}, {}, t)
                 for x, y in ((0.4, 0.5), (0.9, 0.9), (0.4, 0.2))],
                F.pair_demand_rates(spec, 2, 180.0))
    same(build)


def service(m, rate=25.0, seed=7):
    B = m.bubbletea
    arr = B.ArrivalProcess(rate_per_s=rate, horizon_ms=30_000.0, seed=seed, diurnal_amplitude=0.3,
                           diurnal_period_ms=30_000.0, burst_rate_mult=4.0, mean_on_ms=1_000.0, mean_off_ms=4_000.0)
    mix = B.PromptMix(lengths=(512, 1024, 2048), weights=(0.25, 0.65, 0.10))
    return m.fleet.PrefillService(
        host_job="A", arrivals=arr.generate(mix, tiers={"gold": 0.3, "best_effort": 0.7}),
        model=B.InferenceModelSpec("llama3-8b", num_params=8e9, kv_bytes_per_token=16384.0),
        decode_dc="c", tiers={"gold": 1_200.0, "best_effort": 8_000.0})


@pytest.mark.parametrize("jobs", [1, 2])
def test_fleet_with_prefill_service(jobs):
    """The host job with BubbleTea's prefill service, alone and beside a
    contender on the shared WAN."""
    def build(m):
        j = job(m, act_bytes=6e7)
        fj = [m.fleet.FleetJob("A", j, {"a": 2, "b": 2, "c": 2}, P=6, n_iterations=6, C=1),
              m.fleet.FleetJob("B", j, {"a": 2, "b": 2}, P=4, n_iterations=6, C=1)]
        return m.fleet.simulate_fleet(fj[:jobs], world(m), prefill=service(m), validate=True)
    _, port = same(build)
    assert port.stats["prefill"]["placed"] > 0


def test_fleet_cascade():
    """Job A spans a, b, c and B spans a, c, d; an unplanned outage on a->b
    pushes A onto the pair B crosses, and B drifts and re-plans."""
    def build(m):
        w = world(m, 4, ("a", "b", "c", "d"))
        bw = w.link(0, 1).bw_gbps
        live = w.with_bandwidth_schedules({(0, 1): m.wan.BandwidthSchedule.outage(bw, 20_000.0, 1e9, bw / 10.0)})
        j = job(m, act_bytes=1.2e8)
        fj = [m.fleet.FleetJob(n, j, g, P=6, n_iterations=40, C=1, planned_topo=w,
                               control=m.control.ControlConfig())
              for n, g in (("A", {"a": 2, "b": 2, "c": 2}), ("B", {"a": 2, "c": 2, "d": 2}))]
        return m.fleet.simulate_fleet(fj, live, validate=True)
    _, port = same(build)
    assert port.jobs["A"].replans >= 1


@pytest.mark.parametrize("sharing", ["temporal", "fair"])
def test_fleet_guard_and_sharing(sharing):
    def build(m):
        j = job(m, act_bytes=2e8)
        trigger = m.control.ControlConfig(drift_threshold=1e-6, hysteresis=1, cooldown_iterations=0,
                                          min_gain_ms=-1e15)
        fj = [m.fleet.FleetJob(n, j, {"a": 2, "b": 2, "c": 2}, P=4, n_iterations=8, C=1, control=trigger)
              for n in ("A", "B")]
        return m.fleet.simulate_fleet(fj, world(m), validate=True,
                                      config=m.fleet.FleetConfig(sharing=sharing, max_cascade_replans=1))
    same(build)


def test_fleet_with_failure():
    def build(m):
        F = m.failures
        w = world(m)
        trace = F.FailureTrace(events=(F.FailureEvent(at_ms=2_000.0, kind="dc_outage", dc="b", recover_ms=6_000.0,
                                                      residual_frac=0.05),))
        j = job(m)
        fj = [m.fleet.FleetJob(n, j, {"a": 4, "b": 4, "c": 4}, P=6, n_iterations=10, C=1,
                               control=m.control.ControlConfig(),
                               checkpoint=F.CheckpointPolicy(interval_ms=1_000.0, placement=("a", "c")))
              for n in ("A", "B")]
        return m.fleet.simulate_fleet(fj, w, failures=trace, validate=True)
    same(build)
