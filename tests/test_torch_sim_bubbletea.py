"""The port's ``core/bubbletea.py`` against the reference's: the analytic
prefill latency model, seeded arrival streams, the controller's placements
and rejections in fig 13's bubbles, the utilization and bubble helpers and the
local KV handoff, equal bit for bit.  No clock is given to a controller, so
``search_time_us`` stays empty in both."""
import pytest

from torch_sim_helpers import PORT, same

GPT_B = dict(hidden=8192, seq_len=6144, micro_batch=1, layers_per_stage=1, layer_params=1.2e9)


def test_compares_the_port_file_and_keeps_the_papers_a100_constants():
    assert PORT.bubbletea.__file__.endswith("src/repro_torch/core/bubbletea.py")
    assert PORT.bubbletea.GPU_TFLOPS == 312.0  # the paper's A100 testbed, not the H100 the port runs on


def test_latency_model():
    def build(m):
        B = m.bubbletea
        lm = B.PrefillLatencyModel(B.InferenceModelSpec("llama3-8b", 8e9))
        big = B.PrefillLatencyModel(B.InferenceModelSpec("llama3-70b", 70e9, mem_budget_gb=8.0), gpu_tflops=400.0)
        lens, pps = (1, 128, 512, 1024, 2047, 2048, 2049, 4096, 8192, 32768), (1, 2, 4, 8)
        return {name: [(f.compute_ms(L), f.swap_ms(L, p), f.prefill_ms(L, p), f.ttft_ms(L, p), f.ttft_ms(L, p, 7.5))
                       for L in lens for p in pps] for name, f in (("8b", lm), ("70b", big))}, lm.model.model_bytes
    same(build)


ARRIVALS = {
    "poisson": dict(rate_per_s=200.0, horizon_ms=20_000.0),
    "diurnal": dict(rate_per_s=50.0, horizon_ms=60_000.0, diurnal_amplitude=0.6, diurnal_period_ms=20_000.0),
    "bursty": dict(rate_per_s=25.0, horizon_ms=60_000.0, diurnal_amplitude=0.3, diurnal_period_ms=30_000.0,
                   burst_rate_mult=4.0, mean_on_ms=1_000.0, mean_off_ms=4_000.0),
}


@pytest.mark.parametrize("kind", list(ARRIVALS))
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_arrival_streams(kind, seed):
    def build(m):
        B = m.bubbletea
        arr = B.ArrivalProcess(seed=seed, **ARRIVALS[kind])
        return (arr.generate(),
                arr.generate(B.PromptMix(lengths=(512, 1024, 2048), weights=(0.25, 0.65, 0.10)),
                             tiers={"gold": 0.3, "best_effort": 0.7}, req_id0=1000),
                [arr.rate_at(t, on) for t in (0.0, 1234.5, 15_000.0) for on in (False, True)])
    same(build)


def fig13(m, pp=False, slo=None, tiers=None, seed=0, rate=1000.0):
    """Fig 13's scenario: Atlas's bubbles on the testbed (GPT-B, M 16, 40 ms,
    3 pipelines), then prefills from a seeded arrival stream."""
    B = m.bubbletea
    spec = m.simulator.testbed_spec(**GPT_B, num_stages=4, microbatches=16, stage_dc=[0, 0, 1, 2])
    res = m.simulator.simulate(spec, m.simulator.GeoTopology(40.0, True), policy="atlas", n_pipelines=3,
                               validate=True)
    lm = B.PrefillLatencyModel(B.InferenceModelSpec("llama3-8b", 8e9))
    if pp:
        stages = max(s for _p, s in res.busy) + 1
        pipes = [B.intersect_bubbles([res.bubbles[(p, s)] for s in range(stages)]) for p in range(res.n_pipelines)]
        ctrl = B.BubbleTeaController(pipes, lm, pp_degree=stages, ttft_slo_ms=slo, tiers=tiers)
    else:
        ctrl = B.BubbleTeaController([list(res.bubbles[g]) for g in sorted(res.bubbles)], lm, ttft_slo_ms=slo,
                                     tiers=tiers)
    mix = B.PromptMix(lengths=(128, 256, 512, 1024, 2048), weights=(0.3, 0.25, 0.2, 0.15, 0.1))
    arr = B.ArrivalProcess(rate_per_s=rate, horizon_ms=res.iteration_ms, seed=seed)
    placed = [ctrl.submit(r) for r in arr.generate(mix, tiers={"gold": 0.2, "silver": 0.8} if tiers else None)]
    busy = sum(iv.end - iv.start for ivs in res.busy.values() for iv in ivs)
    total = res.iteration_ms * len(res.busy)
    return res, ctrl, placed, busy, total


@pytest.mark.parametrize("pp", [False, True])
@pytest.mark.parametrize("slo", [None, 120.0])
def test_controller_on_fig13_bubbles(pp, slo):
    def build(m):
        B = m.bubbletea
        res, ctrl, placed, busy, total = fig13(m, pp=pp, slo=slo)
        assert ctrl.search_time_us == []
        return (placed, ctrl, ctrl.acceptance_rate(), ctrl.slo_rejection_rate(), ctrl.tier_report(),
                ctrl.prefill_busy_ms(), ctrl.prefill_gpu_busy_ms(), res.utilization,
                B.utilization_with_prefills(busy, total, ctrl), B.utilization_with_prefills(busy, 0.0, ctrl))
    _, port = same(build)
    assert len(port[1].placements) > 0


def test_controller_tiers_and_reset():
    def build(m):
        res, ctrl, placed, _, _ = fig13(m, tiers={"gold": 90.0, "silver": 400.0}, seed=3, rate=400.0)
        before = (list(placed), ctrl.tier_report())
        ctrl.reset_windows([[(0.0, 50.0), (80.0, 400.0)], [(10.0, 300.0)]], pipeline_dc=[0, 2])
        arr = m.bubbletea.ArrivalProcess(rate_per_s=300.0, horizon_ms=400.0, seed=4)
        later = [m.bubbletea.PrefillRequest(r.req_id + 10_000, r.arrival_ms + res.iteration_ms, r.prompt_tokens)
                 for r in arr.generate()]
        return before, [ctrl.submit(r) for r in later], ctrl
    same(build)


def test_bubble_helpers_and_kv():
    def build(m):
        B = m.bubbletea
        lists = [[(0.0, 10.0), (20.0, 35.0), (40.0, 41.0)], [(5.0, 22.0), (30.0, 45.0)], [(0.0, 50.0)]]
        kv = B.LocalKVHandoff(B.InferenceModelSpec("m", 8e9, kv_bytes_per_token=16384.0))
        q = kv.price(2048, 1, 12.5)
        kv.commit(q)
        return (B.intersect_bubbles(lists), B.intersect_bubbles(lists[:1]), B.intersect_bubbles([]),
                [B.prefill_stage_busy_ms(d, p) for d in (0.5, 3.0, 40.0, 250.0) for p in (1, 2, 4, 8)],
                q, kv.price(1, None, 0.0), B._pctl([1.0, 2.0, 3.5, 9.0], 0.5), B._pctl([], 0.99))
    same(build)
