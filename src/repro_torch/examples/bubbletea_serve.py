"""BubbleTea prefill-as-a-service demo:

1. Simulate an Atlas training iteration (12 GPUs / 3 DCs) and collect its
   consolidated bubbles.  ``res.bubbles`` stops at the pipeline end: the
   trailing DP all-reduce span is busy communication, so no prefill can
   be placed there (it used to be mis-recorded as one giant bubble per
   GPU) — the utilization figures below are computed from the corrected
   bubbles.
2. Replay a seeded production trace (``ArrivalProcess``: diurnal +
   bursty Poisson, prompt-length mixture, SLO tiers) through the
   BubbleTea controller: per-tier admission (§5 TTFT-SLO check — late
   placements are rejected back to the dedicated fleet), placement,
   TTFT percentiles per tier, utilization 45% -> ~94% (paper Fig 13).
3. Run a REAL Splitwise-style prefill/decode split on a reduced model to
   show the KV-cache handoff: on the card (the flash kernel's prefill, the
   decode kernel's steps, RMSNorm's kernel), or on the CPU when asked.

  PYTHONPATH=src python -m repro_torch.examples.bubbletea_serve [--device cpu]

The times of parts 1 and 2 are the simulator's model of the paper's A100
testbed, not this card's; the placement search's microseconds are the host's.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.bubbletea import (
    ArrivalProcess,
    BubbleTeaController,
    InferenceModelSpec,
    PrefillLatencyModel,
    PromptMix,
    utilization_with_prefills,
)
from repro_torch.core.simulator import GeoTopology, simulate, testbed_spec
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.serving.engine import Request, SplitwiseCluster


def main(device=None, params=None):
    """Parts 1-3; part 3 serves ``params`` (the smoke GPT-A's, converted) or
    parameters made from seed 0 on ``device``.  Returns the served requests
    and the cluster's ``kv_bytes_moved``."""
    device = resolve_device(device)
    # ---- 1) training bubbles ----
    spec = testbed_spec(
        hidden=8192, seq_len=6144, micro_batch=1, layers_per_stage=1,
        layer_params=1.2e9, num_stages=4, microbatches=16, stage_dc=[0, 0, 1, 2],
    )
    res = simulate(spec, GeoTopology(wan_latency_ms=40, multi_tcp=True),
                   policy="atlas", n_pipelines=3, dp_replicas_for_allreduce=3)
    pp_end = res.iteration_ms - res.allreduce_ms
    print(f"[atlas] iter={res.iteration_ms:.0f}ms util={res.utilization:.0%} "
          f"(bubbles to fill; all-reduce span "
          f"[{pp_end:.0f}, {res.iteration_ms:.0f}]ms stays busy)")

    # ---- 2) prefill-as-a-service ----
    lm = PrefillLatencyModel(InferenceModelSpec("llama3-8b", 8e9))
    ctrl = BubbleTeaController(
        [list(res.bubbles[g]) for g in sorted(res.bubbles)], lm, pp_degree=1,
        tiers={"gold": 1_500.0, "best_effort": 5_000.0},
        clock=time.perf_counter,
    )
    reqs = ArrivalProcess(
        rate_per_s=1_000.0 / 1.2, horizon_ms=res.iteration_ms, seed=0,
    ).generate(
        PromptMix(lengths=(128, 256, 512, 1024, 2048),
                  weights=(0.3, 0.25, 0.2, 0.15, 0.1)),
        tiers={"gold": 0.3, "best_effort": 0.7},
    )
    for r in reqs:
        ctrl.submit(r)
    busy = sum(iv.end - iv.start for ivs in res.busy.values() for iv in ivs)
    total = res.iteration_ms * len(res.busy)
    after = utilization_with_prefills(busy, total, ctrl)
    print(f"[bubbletea] requests={len(reqs)} placed={len(ctrl.placements)} "
          f"accept={ctrl.acceptance_rate():.0%} "
          f"slo-rejects={len(ctrl.rejected_slo)}")
    print(f"[bubbletea] utilization {res.utilization:.0%} -> {after:.0%} "
          f"(paper: 45% -> 94%)")
    for tier, rep in ctrl.tier_report().items():
        print(f"[bubbletea]   {tier}: accept={rep['acceptance']:.0%} "
          f"TTFT ms p50={rep['ttft_p50_ms']:.0f} p99={rep['ttft_p99_ms']:.0f}")
    print(f"[bubbletea] placement search "
          f"p50={np.percentile(ctrl.search_time_us, 50):.0f}us")

    # ---- 3) real Splitwise handoff on a reduced model ----
    cfg = get_smoke_config("gpt_a")
    model = build_model(cfg)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = model.init(gen)
    cluster = SplitwiseCluster(cfg, params, max_batch=4, max_len=128, device=device)
    reqs = [
        Request(i, (np.arange(6 + i) * 5 % cfg.vocab_size).astype(np.int32),
                max_new_tokens=6)
        for i in range(4)
    ]
    done = cluster.serve(reqs)
    print(f"[splitwise] served {len(done)} requests; "
          f"KV moved {cluster.kv_bytes_moved/1e6:.1f} MB; "
          f"sample tokens {done[0].generated}")
    return {"requests": done, "kv_bytes_moved": cluster.kv_bytes_moved}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' must be asked for")
    main(device=ap.parse_args().device)
