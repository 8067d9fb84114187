"""The port's ``core/topology.py`` against the reference's: every preset, the
constructors and the derived views (schedules, contention, snapshots), equal
bit for bit."""
import pytest

from torch_sim_helpers import PORT, same

PRESETS = [("azure", {}), ("azure", {"multi_tcp": False}), ("skewed", {}),
           ("skewed", {"fast_ms": 5.0, "slow_ms": 200.0, "multi_tcp": False}), ("star", {}),
           ("star", {"n_dcs": 6, "hub_ms": 25.0}), ("chain", {}), ("chain", {"n_dcs": 5, "hop_ms": 12.5}),
           ("uniform", {}), ("uniform4", {"wan_latency_ms": 30.0, "multi_tcp": False})]


def test_compares_the_port_file():
    assert PORT.topology.__file__.endswith("src/repro_torch/core/topology.py")
    assert set(PORT.topology.PRESETS) == {"azure", "skewed", "star", "chain"}


def view(t):
    """Everything a consumer reads off a topology."""
    pairs = t.wan_pairs()
    return (
        t, pairs, t.time_varying(),
        {(a, b): (t.link(a, b), t.is_wan(a, b), t.effective_bw_gbps(a, b), t.bandwidth_schedule(a, b))
         for a in range(t.n_dcs) for b in range(t.n_dcs)},
        t.bottleneck() if pairs else None, t.best_link() if pairs else None,
    )


@pytest.mark.parametrize("name,kw", PRESETS, ids=lambda x: str(x))
def test_preset(name, kw):
    same(lambda m: view(m.topology.preset(name, **kw)))


@pytest.mark.parametrize("name,kw", PRESETS, ids=lambda x: str(x))
def test_preset_views(name, kw):
    def build(m):
        t = m.topology.preset(name, **kw)
        traced = t.with_trace_schedules(hours=0.25, samples_per_hour=240, seed=5)
        first = t.wan_pairs()[0]
        contended = traced.with_rate_multipliers({first: 0.5, t.wan_pairs()[-1]: 1.0})
        return (view(traced), view(contended), view(traced.snapshot(420_000.0)),
                view(traced.snapshot(420_000.0, window_ms=60_000.0)),
                t.with_rate_multipliers({}) is t)
    same(build)


def test_constructors_and_names():
    def build(m):
        T = m.topology.TopologyMatrix
        lat = [[0.0, 30.0, 60.0, 150.0], [30.0, 0.0, 40.0, 170.0], [60.0, 40.0, 0.0, 120.0],
               [150.0, 170.0, 120.0, 0.0]]
        a = T.from_latency(lat, dc_names=("use", "ussc", "usw", "asia"))
        b = T.from_latency(lat, multi_tcp=False)
        c = T.from_links(3, {(0, 1): m.wan.Link(12.0, 3.5), (2, 0): m.wan.Link(80.0, 0.4)}, name="x")
        d = T.uniform(5, wan_latency_ms=15.0, intra_bw_gbps=200.0)
        outage = a.with_bandwidth_schedules({(0, 1): m.wan.BandwidthSchedule.outage(5.0, 10.0, 20.0, 0.5)})
        return (view(a), view(b), view(c), view(d), view(outage), a.index_of("usw"), a.index_of("x", 9),
                m.simulator.GeoTopology(25.0, False).matrix(4))
    same(build)
