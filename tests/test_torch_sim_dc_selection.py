"""The port's ``core/dc_selection.py`` (Algorithm 1) against the reference's:
plans for every D, the best plan, the what-if sweep and the closed-form
pipeline latency on uniform WANs and on each preset, equal bit for bit."""
import pytest

from torch_sim_helpers import PORT, REF, job, same

PRESETS = ("azure", "skewed", "star", "chain")


def test_compares_the_port_file_and_keeps_its_own_memo():
    assert PORT.dc_selection.__file__.endswith("src/repro_torch/core/dc_selection.py")
    assert PORT.dc_selection._PP_MEMO is not REF.dc_selection._PP_MEMO


def names_of(t):
    """The topology's DC names, or positional ones where it has none."""
    return t.dc_names or tuple(f"dc{i}" for i in range(t.n_dcs))


def fleet_of(t, gpus=(16, 8, 12, 6, 10, 4)):
    return {n: gpus[i % len(gpus)] for i, n in enumerate(names_of(t))}


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("C", [1, 2])
def test_algorithm1_on_presets(preset, C):
    def build(m):
        t = m.topology.preset(preset)
        j = job(m, topology=t)
        plans = m.dc_selection.algorithm1(j, fleet_of(t), P=12, C=C)
        exhaustive = m.dc_selection.algorithm1(j, fleet_of(t), P=12, C=C, order_search="exhaustive")
        return (plans, m.dc_selection.best_plan(plans), exhaustive, j.comm_compute_ratio,
                [j.pair_bw_gbps(a, b) for a, b in t.wan_pairs()])
    same(build)


@pytest.mark.parametrize("preset", PRESETS)
def test_algorithm1_options(preset):
    def build(m):
        t = m.topology.preset(preset)
        names = names_of(t)
        j = job(m, topology=t, microbatches=60, act_bytes=3e7)
        f = fleet_of(t)
        return (m.dc_selection.algorithm1(j, f, P=10, C=1, D_max=3),
                m.dc_selection.algorithm1(j, f, P=10, C=1, incumbent_order=tuple(reversed(names))),
                m.dc_selection.algorithm1(j, f, P=10, C=1, exclude_dcs=(names[1],)),
                m.dc_selection.algorithm1(j, f, P=10, C=1, dc_order=names, search_orders=False),
                m.dc_selection.algorithm1(j, f, P=10))
    same(build)


@pytest.mark.parametrize("lat", [10.0, 40.0])
@pytest.mark.parametrize("multi_tcp", [True, False])
def test_algorithm1_uniform(lat, multi_tcp):
    def build(m):
        j = job(m, wan_latency_ms=lat, multi_tcp=multi_tcp, act_bytes=2 * 10e-3 * 5.0 * 1e9 / 8)
        out = [m.dc_selection.algorithm1(j, {"dc1": 600, "dc2": 60 * F}, P=60, C=2) for F in (0, 3, 10)]
        return out, [m.dc_selection.best_plan(p) for p in out], m.dc_selection.get_latency_dp(j, 4)
    same(build)


@pytest.mark.parametrize("preset", PRESETS)
def test_get_latency_pp(preset):
    def build(m):
        t = m.topology.preset(preset)
        j = job(m, topology=t)
        names = names_of(t)
        parts = {n: 2 + i for i, n in enumerate(names)}
        return [m.dc_selection.get_latency_pp(j, parts, order, cell)
                for order in (names, tuple(reversed(names)), names[1:] + names[:1]) for cell in (1, 2, 3)]
    same(build)


def test_what_if():
    def build(m):
        t = m.topology.preset("azure")
        names = names_of(t)
        scenarios = {"all": fleet_of(t), "us-only": {n: 16 for n in names[:3]},
                     "two": {names[0]: 24, names[3]: 24}}
        return (m.dc_selection.what_if(job(m, topology=t), scenarios, P=12, C=1),
                m.dc_selection.what_if(job(m), {"a": {"dc1": 64, "dc2": 16}}, P=16, gpu_cost_per_hour=3.5))
    same(build)
