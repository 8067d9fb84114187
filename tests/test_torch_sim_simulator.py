"""The port's ``core/simulator.py`` against the reference's: ``simulate`` over
the four policies, uniform and heterogeneous WANs and 1-4 pipelines, with the
invariant checker on, the fast-forward on and off, a time-varying WAN and an
offset start; the spec constructors and the analytic helpers.  Exact equality,
floats included: every interval, bubble and stats entry."""
import hypothesis.strategies as st
import pytest
from hypothesis import given, settings

from torch_sim_helpers import PORT, same

POLICIES = ("gpipe", "megatron", "varuna", "atlas")
GPT_A = dict(hidden=4096, seq_len=4096, micro_batch=1, layers_per_stage=1, layer_params=412e6)
GPT_B = dict(hidden=8192, seq_len=6144, micro_batch=1, layers_per_stage=1, layer_params=1.2e9)
TOPOLOGIES = ("geo10", "geo10-multi", "geo40", "geo40-multi", "azure", "skewed", "star", "chain")


def test_compares_the_port_file():
    assert PORT.simulator.__file__.endswith("src/repro_torch/core/simulator.py")
    assert PORT.simulator.simulate.__module__ == "repro_torch.core.simulator"
    assert PORT.simulator.POLICIES == POLICIES


def topology(m, name):
    if name.startswith("geo"):
        return m.simulator.GeoTopology(wan_latency_ms=float(name[3:5]), multi_tcp=name.endswith("multi"))
    return m.topology.preset(name)


def spec_of(m, model=GPT_A, M=4, dcs=(0, 0, 1, 2)):
    return m.simulator.testbed_spec(**model, num_stages=len(dcs), microbatches=M, stage_dc=list(dcs))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_simulate_grid(topo, policy):
    """One spec, ``n_pipelines`` 1-4, the invariant checker on."""
    def build(m):
        spec = spec_of(m, M=6)
        return [m.simulator.simulate(spec, topology(m, topo), policy=policy, n_pipelines=d, validate=True)
                for d in (1, 2, 3, 4)]
    same(build)


@pytest.mark.parametrize("model", ["gpt_a", "gpt_b"])
@pytest.mark.parametrize("M", [4, 16])
@pytest.mark.parametrize("lat", [10, 40])
def test_fig9_testbed(model, M, lat):
    """Fig 9 and 10's cases: Atlas with 3 pipelines on multi-TCP against the
    baselines on single and on multi TCP."""
    def build(m):
        spec = spec_of(m, GPT_A if model == "gpt_a" else GPT_B, M)
        single = m.simulator.GeoTopology(wan_latency_ms=lat, multi_tcp=False)
        multi = m.simulator.GeoTopology(wan_latency_ms=lat, multi_tcp=True)
        out = {"atlas": m.simulator.simulate(spec, multi, policy="atlas", n_pipelines=3, validate=True)}
        for pol in POLICIES[:3]:
            out[pol] = m.simulator.simulate(spec, single, policy=pol, validate=True)
            out[pol + "-multi"] = m.simulator.simulate(spec, multi, policy=pol, validate=True)
        return out
    same(build)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("fast_forward", [None, True, False])
def test_fast_forward_on_and_off(policy, fast_forward):
    def build(m):
        spec = spec_of(m, M=96, dcs=(0, 0, 1, 1, 2, 2))
        res = m.simulator.simulate(spec, m.topology.preset("azure"), policy=policy, n_pipelines=2,
                                   validate=True, fast_forward=fast_forward)
        return res, res.stats.get("fast_forward")
    _, port = same(build)
    if fast_forward is False:
        assert port[1] is False


def varying(m):
    """The Azure WAN with an outage on one pair and a diurnal swing on another."""
    S = m.wan.BandwidthSchedule
    t = m.topology.preset("azure")
    bw = t.link(0, 1).bw_gbps
    return t.with_bandwidth_schedules({
        (0, 1): S.outage(bw, 50.0, 400.0, bw / 10.0),
        (1, 2): S.diurnal(5.0, 1.5, period_ms=600.0, steps=6),
    })


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("start_ms", [0.0, 37.5, 380.0])
def test_time_varying_wan_and_start(policy, start_ms):
    def build(m):
        spec = spec_of(m, M=12, dcs=(0, 1, 2, 3))
        t = varying(m)
        return (m.simulator.has_time_varying_wan(spec, t),
                [m.simulator.simulate(spec, t, policy=policy, n_pipelines=d, validate=True, start_ms=start_ms,
                                      fast_forward=True) for d in (1, 3)])
    same(build)


@pytest.mark.parametrize("policy", POLICIES)
def test_transfer_log_and_allreduce(policy):
    def build(m):
        spec = spec_of(m, GPT_B, M=8)
        t = m.topology.preset("skewed")
        return (m.simulator.simulate(spec, t, policy=policy, n_pipelines=3, dp_replicas_for_allreduce=3,
                                     validate=True, record_transfers=True),
                m.simulator.iteration_wan_bits(spec, 3),
                [m.simulator.boundary_schedule(varying(m), spec, b, b + 1) for b in range(3)])
    same(build)


def test_spec_constructors_and_dp():
    def build(m):
        S = m.simulator
        return ([S.testbed_spec(**mod, num_stages=6, microbatches=M, stage_dc=[0, 0, 1, 1, 2, 2], recompute=r)
                 for mod in (GPT_A, GPT_B) for M in (4, 16) for r in (True, False)],
                S.testbed_spec(**GPT_A, num_stages=4, microbatches=4, stage_dc=[0, 1, 2, 3], gpu_tflops=989.0),
                [S.dp_iteration_ms(100.0, 4.8e9, 6, lat, multi_tcp=mt, intra_dc=intra)
                 for lat in (0, 10, 40) for mt in (False, True) for intra in (False, True)])
    same(build)


@settings(max_examples=50, deadline=None, database=None, derandomize=True)
@given(stages=st.integers(2, 6), M=st.integers(1, 16), preset=st.sampled_from(["azure", "skewed", "star", "chain"]),
       policy=st.sampled_from(POLICIES), d=st.integers(1, 3), data=st.data())
def test_random_specs(stages, M, preset, policy, d, data):
    """Random ``PipelineSpec``s over a preset's DCs, both packages."""
    n_dcs = {"azure": 4, "skewed": 3, "star": 4, "chain": 4}[preset]
    stage_dc = tuple(data.draw(st.lists(st.integers(0, n_dcs - 1), min_size=stages, max_size=stages)))
    t_fwd = data.draw(st.floats(0.5, 80.0))
    act = data.draw(st.floats(1e5, 3e8))
    params = data.draw(st.sampled_from([0.0, 8.24e8, 2.4e9]))
    cap = data.draw(st.sampled_from([None, 1, 2, stages]))

    def build(m):
        """The result, or the package's own invariant fault as (name, message):
        a draw may land on a fault of the reference (ROADMAP.md Queue 3 (l),
        (m)), which the copy must raise alike."""
        spec = m.simulator.PipelineSpec(num_stages=stages, microbatches=M, t_fwd_ms=t_fwd, act_bytes=act,
                                        stage_dc=stage_dc, stage_param_bytes=params, inflight_cap=cap)
        try:
            return m.simulator.simulate(spec, m.topology.preset(preset), policy=policy, n_pipelines=d, validate=True)
        except m.validate.InvariantViolation as e:
            return ("InvariantViolation", str(e))
    same(build)


@pytest.mark.parametrize("preset", ["azure", "skewed", "star", "chain"])
def test_gpipe_under_an_inflight_cap_of_one_faults_alike(preset):
    """ROADMAP.md Queue 3 (m): GPipe under an in-flight cap of 1 stops short
    in the reference; the copy raises the same ``InvariantViolation``."""
    def build(m):
        spec = m.simulator.PipelineSpec(num_stages=2, microbatches=2, t_fwd_ms=1.0, act_bytes=1e5, stage_dc=(0, 0),
                                        stage_param_bytes=0.0, inflight_cap=1)
        with pytest.raises(m.validate.InvariantViolation) as e:
            m.simulator.simulate(spec, m.topology.preset(preset), policy="gpipe", validate=True)
        return str(e.value)
    ref, port = same(build)
    assert "stage did not run M forwards + M backwards" in ref
