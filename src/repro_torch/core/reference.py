"""Pre-refactor scheduling engine — the differential-testing reference.

This module is a verbatim snapshot of the event-driven simulator and the
Atlas list-scheduler as they stood before the fast-path rebuild
(heap-based event core, steady-state fast-forward, lazy-heap list
scheduler).  It is deliberately *slow* — per-dispatch ``ready.sort()``,
per-pump ``pend.sort()``, O(n·|avail|) scans — and deliberately frozen:

  * ``tests/test_engine_equiv.py`` asserts the optimized engine in
    ``repro_torch.core.simulator`` produces *interval-identical* ``SimResult``s
    against this reference across a (policy × topology × M) grid;
  * ``benchmarks/sim_bench.py`` times it as the perf baseline for the
    speedup trajectory recorded in ``BENCH_sim.json``.

Do not optimize this file.  If the modelled physics change, change both
engines and the invariant checker together.

The port's own copy of ``repro/core/reference.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Tuple

from repro_torch.core import wan
from repro_torch.core.simulator import Interval, PipelineSpec, SimResult


def _priority(kind: str, micro: int, pipeline: int) -> Tuple:
    # backward (incl. its recompute) preempts queued forwards (paper §4.4
    # rule 4); earlier microbatches first; lower rank first.
    order = {"bwd": 0, "fwd": 1}
    return (order[kind], micro, pipeline)


def simulate(
    spec: PipelineSpec,
    topo,  # GeoTopology | repro_torch.core.topology.TopologyMatrix
    *,
    policy: str = "varuna",
    n_pipelines: int = 1,
    dp_replicas_for_allreduce: int = 1,
) -> SimResult:
    """One minibatch of ``n_pipelines`` DP pipelines, pre-refactor engine."""
    assert policy in ("gpipe", "megatron", "varuna", "atlas")
    if policy == "atlas":
        return _simulate_atlas(spec, topo, n_pipelines, dp_replicas_for_allreduce)
    P, M = spec.num_stages, spec.microbatches
    recompute = spec.recompute and policy in ("gpipe", "varuna", "atlas")
    inflight_cap = spec.inflight_cap
    if inflight_cap is None:
        inflight_cap = M if policy == "gpipe" else P
    t_f = spec.t_fwd_ms
    t_b = spec.bwd_mult * spec.t_fwd_ms

    D = n_pipelines
    pipes = range(D)

    chan_free: Dict[Tuple, float] = {}
    chan_pending: Dict[Tuple, List[Tuple]] = {}

    def transfer_times(s_from: int, s_to: int) -> Tuple[float, float]:
        dc_a, dc_b = spec.stage_dc[s_from], spec.stage_dc[s_to]
        link = topo.link(dc_a, dc_b)
        ser = (spec.act_bytes * 8.0) / (link.bw_gbps * 1e9) * 1e3  # inline conversion as the reference keeps it
        return ser, link.latency_ms

    def chan_key(p: int, boundary: int, direction: str) -> Tuple:
        return (p, boundary, direction)

    gpu_free = {(p, s): 0.0 for p in pipes for s in range(P)}
    ready: Dict[Tuple[int, int], List[Tuple]] = {g: [] for g in gpu_free}
    busy: Dict[Tuple[int, int], List[Interval]] = {g: [] for g in gpu_free}
    fwd_done = {(p, s): 0 for p in pipes for s in range(P)}
    bwd_done = {(p, s): 0 for p in pipes for s in range(P)}
    fwd_barrier_release: Dict[int, float] = {}

    events: List[Tuple[float, int, str, Tuple]] = []
    seq = itertools.count()

    def push(t: float, kind: str, payload: Tuple):
        heapq.heappush(events, (t, next(seq), kind, payload))

    for p in pipes:
        for m in range(M):
            ready[(p, 0)].append(_priority("fwd", m, p) + ("fwd", m))

    def try_dispatch(g: Tuple[int, int], now: float):
        p, s = g
        if gpu_free[g] > now or not ready[g]:
            return
        ready[g].sort()
        for i, item in enumerate(ready[g]):
            kind, m = item[-2], item[-1]
            if kind == "fwd":
                if fwd_done[g] - bwd_done[g] >= inflight_cap:
                    continue
            if kind == "bwd" and policy == "gpipe":
                if fwd_barrier_release.get(p) is None:
                    continue
            ready[g].pop(i)
            if kind == "fwd":
                dur = t_f
            else:
                dur = t_b + (t_f if (recompute and s != P - 1) else 0.0)
            gpu_free[g] = now + dur
            busy[g].append(Interval(now, now + dur, kind, m))
            push(now + dur, "gpu_done", (p, s, kind, m))
            return

    def on_gpu_done(now: float, p: int, s: int, kind: str, m: int):
        g = (p, s)
        if kind == "fwd":
            fwd_done[g] += 1
            if s < P - 1:
                request_transfer(now, p, s, s + 1, "act", m)
            else:
                ready[g].append(_priority("bwd", m, p) + ("bwd", m))
            if policy == "gpipe" and s == P - 1 and fwd_done[g] == M:
                fwd_barrier_release[p] = now
                try_dispatch((p, P - 1), now)
        else:
            bwd_done[g] += 1
            if s > 0:
                request_transfer(now, p, s, s - 1, "grad", m)
        try_dispatch(g, now)

    def request_transfer(now: float, p: int, s_from: int, s_to: int, direction: str, m: int):
        boundary = min(s_from, s_to)
        key = chan_key(p, boundary, direction)
        prio = (m, 0 if direction == "grad" else 1, p)
        chan_pending.setdefault(key, []).append(prio + (p, s_from, s_to, direction, m))
        pump_channel(key, now)

    def pump_channel(key: Tuple, now: float):
        pend = chan_pending.get(key)
        if not pend or chan_free.get(key, 0.0) > now + 1e-12:
            return
        pend.sort()
        _, _, _, p, s_from, s_to, direction, m = pend.pop(0)
        ser, delay = transfer_times(s_from, s_to)
        chan_free[key] = now + ser
        push(now + ser + delay, "arrive", (p, s_to, direction, m))
        push(now + ser, "chan_free", (key,))

    def on_arrive(now: float, p: int, s: int, direction: str, m: int):
        g = (p, s)
        kind = "fwd" if direction == "act" else "bwd"
        ready[g].append(_priority(kind, m, p) + (kind, m))
        try_dispatch(g, now)

    for p in pipes:
        try_dispatch((p, 0), 0.0)

    while events:
        now, _, ev, payload = heapq.heappop(events)
        if ev == "gpu_done":
            on_gpu_done(now, *payload)
        elif ev == "arrive":
            on_arrive(now, *payload)
        elif ev == "chan_free":
            pump_channel(payload[0], now)

    pp_end = max((iv.end for ivs in busy.values() for iv in ivs), default=0.0)
    return _finish(spec, topo, busy, pp_end, D, dp_replicas_for_allreduce)


def _finish(spec, topo, busy, pp_end, D, dp_replicas) -> SimResult:
    # bubble semantics changed with the engines (see the module rule: if
    # the modelled physics change, both engines and the checker move
    # together): gaps are capped at pp_end — the trailing DP all-reduce
    # span is busy communication, not schedulable idle time
    ar = wan.allreduce_ms(
        spec.stage_param_bytes, dp_replicas, topo.intra_bw_gbps
    )
    total = pp_end + ar
    bubbles: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    busy_sum = 0.0
    for g, ivs in busy.items():
        ivs.sort(key=lambda iv: iv.start)
        gaps = []
        cur = 0.0
        for iv in ivs:
            if iv.start > cur + 1e-9:
                gaps.append((cur, iv.start))
            cur = max(cur, iv.end)
            busy_sum += iv.end - iv.start
        if cur < pp_end - 1e-9:
            gaps.append((cur, pp_end))
        bubbles[g] = gaps
    util = busy_sum / (total * len(busy)) if total > 0 else 0.0
    return SimResult(
        iteration_ms=total,
        busy=busy,
        utilization=util,
        bubbles=bubbles,
        allreduce_ms=ar,
        n_pipelines=D,
    )


def _simulate_atlas(spec, topo, n_pipelines, dp_replicas) -> SimResult:
    sched = atlas_schedule(spec, topo, n_pipelines, inflight_cap=spec.inflight_cap)
    busy: Dict[Tuple[int, int], List[Interval]] = {
        (p, s): [] for p in range(n_pipelines) for s in range(spec.num_stages)
    }
    for t in sched.tasks:
        busy[(t.pipeline, t.stage)].append(Interval(t.start, t.end, t.kind, t.micro))
    return _finish(spec, topo, busy, sched.makespan, n_pipelines, dp_replicas)


# ---------------------------------------------------------------------------
# pre-refactor Atlas list-scheduler (O(n · |avail|) full scan per pick)
# ---------------------------------------------------------------------------


def atlas_schedule(
    spec,
    topo,
    n_pipelines: int,
    *,
    inflight_cap: Optional[int] = None,
):
    from repro_torch.core.temporal import Schedule, Task, Transfer, is_wan_boundary

    P, M, D = spec.num_stages, spec.microbatches, n_pipelines
    t_f = spec.t_fwd_ms
    t_b = spec.bwd_mult * t_f
    cap = inflight_cap if inflight_cap is not None else P

    def boundary_times(b: int, direction: str = "act") -> Tuple[float, float]:
        dc_a, dc_b = spec.stage_dc[b], spec.stage_dc[b + 1]
        link = topo.link(dc_a, dc_b) if direction == "act" else topo.link(dc_b, dc_a)
        ser = (spec.act_bytes * 8.0) / (link.bw_gbps * 1e9) * 1e3  # inline conversion as the reference keeps it
        if dc_a == dc_b:
            return ser, link.latency_ms
        hop = (spec.act_bytes * (D - 1) / D * 8.0) / (topo.intra_bw_gbps * 1e9) * 1e3  # inline conversion as the reference keeps it
        return ser / D, link.latency_ms + 2.0 * hop

    is_wan = [spec.stage_dc[b] != spec.stage_dc[b + 1] for b in range(P - 1)]

    gpu_free = {(p, s): 0.0 for p in range(D) for s in range(P)}
    chan_free: Dict[Tuple[int, str], float] = {}
    wan_sers = [
        boundary_times(b, d)[0]
        for b in range(P - 1)
        if is_wan_boundary(spec, topo, b)
        for d in ("act", "grad")
    ]
    slot = max(wan_sers) if wan_sers else 0.0
    avail: Dict[Tuple[str, int, int, int], float] = {}
    for p in range(D):
        for m in range(M):
            avail[("fwd", p, 0, m)] = p * slot
    fwd_sched = {(p, s): 0 for p in range(D) for s in range(P)}
    bwd_sched = {(p, s): 0 for p in range(D) for s in range(P)}

    tasks: List = []
    transfers: List = []
    n_total = D * P * M * 2
    done = 0

    def task_dur(kind: str, s: int) -> float:
        if kind == "fwd":
            return t_f
        rec = t_f if (spec.recompute and s != P - 1) else 0.0
        return t_b + rec

    def feasible_start(kind: str, p: int, s: int, m: int) -> Optional[float]:
        key = (kind, p, s, m)
        if key not in avail:
            return None
        if kind == "fwd" and fwd_sched[(p, s)] - bwd_sched[(p, s)] >= cap:
            return None
        t0 = max(avail[key], gpu_free[(p, s)])
        dur = task_dur(kind, s)
        out_b = s if kind == "fwd" else s - 1
        has_out = (kind == "fwd" and s < P - 1) or (kind == "bwd" and s > 0)
        if has_out and is_wan[out_b]:
            direction = "act" if kind == "fwd" else "grad"
            cf = chan_free.get((out_b, direction), 0.0)
            t0 = max(t0, cf - dur)
        return t0

    def emit_transfer(p, b, direction, m, ready):
        ser, delay = boundary_times(b, direction)
        if is_wan[b]:
            start = max(ready, chan_free.get((b, direction), 0.0))
            chan_free[(b, direction)] = start + ser
        else:
            start = ready
        arrive = start + ser + delay
        transfers.append(Transfer(p, b, direction, m, start, start + ser, arrive))
        dst = b + 1 if direction == "act" else b
        kind = "fwd" if direction == "act" else "bwd"
        avail[(kind, p, dst, m)] = arrive

    while done < n_total:
        best = None
        for key in list(avail.keys()):
            kind, p, s, m = key
            t0 = feasible_start(kind, p, s, m)
            if t0 is None:
                continue
            rank = (t0, 0 if kind == "bwd" else 1, m, p)
            if best is None or rank < best[0]:
                best = (rank, key, t0)
        assert best is not None, "deadlock in atlas schedule (cap too small?)"
        _, (kind, p, s, m), t0 = best
        del avail[(kind, p, s, m)]
        dur = task_dur(kind, s)
        end = t0 + dur
        gpu_free[(p, s)] = end
        tasks.append(Task(p, s, m, kind, t0, end))
        if kind == "fwd":
            fwd_sched[(p, s)] += 1
            if s < P - 1:
                emit_transfer(p, s, "act", m, end)
            else:
                avail[("bwd", p, s, m)] = end
        else:
            bwd_sched[(p, s)] += 1
            if s > 0:
                emit_transfer(p, s - 1, "grad", m, end)
        done += 1

    makespan = max(t.end for t in tasks)
    if transfers:
        makespan = max(makespan, max(tr.arrive for tr in transfers))
    return Schedule(tasks, transfers, makespan, P, D)
