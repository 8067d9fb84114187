"""The port's ``core/temporal.py`` (Atlas's temporal bandwidth sharing) and
``core/fastforward.py`` (period detection and its gates) against the
reference's, equal bit for bit."""
import pytest

from torch_sim_helpers import PORT, same

GPT_A = dict(hidden=4096, seq_len=4096, micro_batch=1, layers_per_stage=1, layer_params=412e6)
GPT_B = dict(hidden=8192, seq_len=6144, micro_batch=1, layers_per_stage=1, layer_params=1.2e9)


def test_compares_the_port_files():
    assert PORT.temporal.__file__.endswith("src/repro_torch/core/temporal.py")
    assert PORT.fastforward.__file__.endswith("src/repro_torch/core/fastforward.py")


def spec_of(m, model, M, dcs, **kw):
    return m.simulator.testbed_spec(**model, num_stages=len(dcs), microbatches=M, stage_dc=list(dcs), **kw)


def varying(m):
    S = m.wan.BandwidthSchedule
    t = m.topology.preset("azure")
    bw = t.link(1, 2).bw_gbps
    return t.with_bandwidth_schedules({(1, 2): S.step(bw, bw / 4.0, 120.0), (2, 3): S.diurnal(5.0, 2.0, 900.0, 9)})


TOPOS = {
    "geo40": lambda m: m.simulator.GeoTopology(40.0, True),
    "geo10-single": lambda m: m.simulator.GeoTopology(10.0, False),
    "azure": lambda m: m.topology.preset("azure"),
    "skewed": lambda m: m.topology.preset("skewed"),
    "varying": varying,
}


@pytest.mark.parametrize("topo", list(TOPOS))
@pytest.mark.parametrize("D", [1, 2, 3])
def test_atlas_schedule(topo, D):
    def build(m):
        t = TOPOS[topo](m)
        out = []
        for model, M, dcs in ((GPT_A, 8, (0, 0, 1, 2)), (GPT_B, 5, (0, 1, 2, 2, 1, 0))):
            spec = spec_of(m, model, M, dcs)
            for cap in (None, 2):
                for start in (0.0, 100.0):
                    s = m.temporal.atlas_schedule(spec, t, D, inflight_cap=cap, start_ms=start)
                    out.append((s, s.wan_bits(spec), [m.temporal.is_wan_boundary(spec, t, b) for b in range(len(dcs) - 1)]))
        return out
    same(build)


@pytest.mark.parametrize("topo", ["geo40", "azure", "varying"])
def test_fast_forward_gate(topo):
    def build(m):
        t = TOPOS[topo](m)
        specs = [spec_of(m, GPT_A, 64, dcs) for dcs in ((0, 0, 1, 2), (0, 0, 0, 0), (1, 2, 3, 3))]
        return ([m.fastforward.fast_forward_gate(s, t) for s in specs],
                [m.fastforward.fast_forward_gate(s, t, epoch_boundary=True) for s in specs],
                [m.fastforward.probe_sizes(s, d) for s in specs for d in (1, 3)])
    same(build)


@pytest.mark.parametrize("policy", ["gpipe", "megatron", "varuna", "atlas"])
@pytest.mark.parametrize("force", [False, True])
def test_try_fast_forward(policy, force):
    """The fast-forward over each package's own raw engine, at an M where it
    engages and one where its probes do not fit."""
    def build(m):
        t = m.topology.preset("skewed")
        out = []
        for M, D in ((160, 1), (160, 3), (20, 2)):
            spec = spec_of(m, GPT_A, M, (0, 0, 1, 1, 2))
            D_engine = D if policy == "atlas" else 1

            def run(s):
                if policy == "atlas":
                    return m.simulator._run_atlas(s, t, D_engine, 0.0)
                return m.simulator._run_events(s, t, policy, D_engine, 0.0)
            out.append(m.fastforward.try_fast_forward(spec, run, n_pipelines=D_engine, force=force))
        return out
    _, port = same(build)
    if force:
        assert any(r is not None for r in port), "the fast-forward never engaged"
