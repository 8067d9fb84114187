"""The port's ``core/wan.py`` and ``units.py`` against the reference's: TCP
model, links, bandwidth schedules, seeded traces and all-reduce times, equal
bit for bit (exact equality, floats included)."""
import pytest

from torch_sim_helpers import PORT, same

LATENCIES = (0.0, 0.1, 2.0, 10.0, 16.0, 20.0, 34.0, 40.0, 95.0, 150.0)


def test_compares_the_port_files():
    assert PORT.wan.__file__.endswith("src/repro_torch/core/wan.py")
    assert PORT.units.__file__.endswith("src/repro_torch/units.py")


@pytest.mark.parametrize("lat", LATENCIES)
def test_tcp_model(lat):
    same(lambda m: (
        m.wan.tcp_single_bw_gbps(lat),
        [m.wan.tcp_multi_bw_gbps(lat, n) for n in (1, 2, 3, 5, 16)],
        m.wan.connections_for_cap(lat),
        m.wan.wan_link(lat, True), m.wan.wan_link(lat, False),
        m.wan.wan_link(lat, False).transfer_ms(1.2e8),
        m.wan.intra_dc_link().transfer_ms(3.3e7),
    ))


def test_constants_and_units():
    same(lambda m: (
        {k: v for k, v in vars(m.wan).items() if k.isupper()},
        {k: v for k, v in vars(m.units).items() if k.isupper()},
        [getattr(m.units, f)(1.2345e7, 3.7) for f in ("serialization_ms", "bits_serialization_ms",
                                                       "serialization_ms_gbytes", "bits_rate_gbps")],
        [getattr(m.units, f)(1.5e6) for f in ("bytes_to_bits", "bits_to_bytes", "gb_to_bytes")],
        m.units.window_bits(12.5, 4.2), m.units.window_bits(12.5, 4.2, 0.3),
    ))


def _schedules(m):
    S = m.wan.BandwidthSchedule
    link = m.wan.wan_link(34.0, True)
    return {
        "flat": S.flat(5.0),
        "step": S.step(5.0, 2.5, 40.0),
        "outage": S.outage(5.0, 10.0, 200.0, 0.5),
        "diurnal": S.diurnal(5.0, 1.0, period_ms=1000.0, steps=12, cycles=2),
        "samples": S.from_samples([1.0, 1.0, 2.0, 0.5, 0.5, 3.0], 7.5, period_ms=45.0),
        "trace": S.from_trace(link, hours=0.5, samples_per_hour=120, seed=3),
        "pieces": S((0.0, 10.0, 30.0), (1.0, 0.25, 2.0)),
    }


@pytest.mark.parametrize("name", ["flat", "step", "outage", "diurnal", "samples", "trace", "pieces"])
def test_bandwidth_schedule_lookups(name):
    def build(m):
        s = _schedules(m)[name]
        times = (0.0, 5.0, 10.0, 29.999, 30.0, 44.0, 45.0, 250.0, 999.0, 1500.0, 2.2e6)
        return (
            s, s.is_flat(), s.min_bw_gbps(), s.max_bw_gbps(),
            [s.bw_at(t) for t in times],
            [s.min_bw_over(a, b) for a, b in ((0.0, 10.0), (5.0, 50.0), (100.0, 2000.0))],
            [s.mean_bw_gbps(a, b) for a, b in ((0.0, 10.0), (5.0, 50.0), (100.0, 2000.0))],
            [s.constant_over(a, b) for a, b in ((0.0, 5.0), (5.0, 50.0))],
            [s.transfer_ms(n, t, r) for n in (1e3, 5e6, 4e8) for t in (0.0, 9.0, 44.0, 1200.0) for r in (1.0, 0.5)],
            [s.bits_sent(5e6, t, t + d, r) for t in (0.0, 9.0) for d in (1.0, 25.0) for r in (1.0, 2.0)],
            [s.preempt(4e6, 0.0, cut) for cut in (1.0, 10.0, 15.0, 30.0, 42.0)],
            s.scaled(0.5),
        )
    same(build)


@pytest.mark.parametrize("seed", [0, 1, 7, 13])
def test_bandwidth_trace_per_seed(seed):
    def build(m):
        traces = [m.wan.bandwidth_trace_gbps(lat, hours=1.0, seed=seed, multi_tcp=mt)
                  for lat in (10.0, 40.0, 95.0) for mt in (True, False)]
        link = m.wan.Link(latency_ms=33.3, bw_gbps=4.2)
        traces.append(m.wan.bandwidth_trace_for_link(link, hours=0.5, samples_per_hour=240, seed=seed))
        return traces, [m.wan.trace_cov(t) for t in traces]
    same(build)


@pytest.mark.parametrize("bw", [0.3, 1.22, 5.0, 100.0])
def test_allreduce_and_activation_bytes(bw):
    same(lambda m: (
        [m.wan.allreduce_ms(p, n, bw) for p in (0.0, 8.24e8, 2.4e9) for n in (1, 2, 3, 6)],
        [m.wan.activation_bytes(b, s, h) for b, s, h in ((1, 4096, 4096), (1, 6144, 8192), (4, 512, 2560))],
        m.wan.activation_bytes(2, 1024, 2048, bytes_per=4),
    ))
