"""Atlas temporal-bandwidth-sharing scheduler — the paper's §4.4 heuristic.

Unlike the reactive baselines (Varuna/GPipe react to arrivals), Atlas
*precomputes* the full iteration schedule for a DP-cell before training
starts.  This module is that scheduler: a serial list-scheduler over
(pipeline, stage, microbatch, phase) tasks and their WAN transfers,
implementing the paper's four rules:

  (1) the D DP pipelines of a cell share one WAN channel per stage
      boundary and direction at D× node-pair bandwidth, one transfer at a
      time (LocalDPRank staggering emerges from serialization order);
  (2) memory-cap filtering: a forward is only scheduled when the stage's
      in-flight count (forwards minus completed backwards) is below the
      cap — Atlas never exceeds peak memory, unlike Varuna;
  (3) compute is scheduled only if its output transfer can start the
      moment compute ends (no buffered activations clogging the channel):
      the task's start is delayed so that compute-end == channel-free;
  (4) when both forward and backward are ready at a stage, backward wins
      (it unlocks downstream stages).

Scheduling core: the original implementation re-scanned every available
task per pick (O(n·|avail|) — minutes at GPT-3 scale).  This one keeps
the candidates in a *lazy* priority heap keyed by the same rank
``(feasible_start, bwd-first, micro, rank)``.  Every component of a
task's feasible start is nondecreasing over time (GPU frees, channel
frees and the scheduled-task counters only move forward), so a popped
entry is either still the true minimum (schedule it), stale (re-push
with its recomputed rank), or cap-blocked (park it until the next
backward on that stage is scheduled).  The emitted schedule is
*identical* to the full-scan reference (``repro_torch.core.reference``) —
ranks are unique per task, so no tie depends on scan order — at
O(n log n) instead of O(n²); ``tests/test_engine_equiv.py`` asserts the
equivalence.

The returned Schedule carries per-GPU busy intervals and transfer windows;
``repro_torch.core.simulator.simulate(policy="atlas")`` wraps it into the same
SimResult shape as the reactive baselines.

The port's own copy of ``repro/core/temporal.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch import units
from repro_torch.core import wan


@dataclasses.dataclass
class Task:
    pipeline: int
    stage: int
    micro: int
    kind: str  # 'fwd' | 'bwd' (bwd includes recompute time)
    start: float = -1.0
    end: float = -1.0


@dataclasses.dataclass
class Transfer:
    pipeline: int
    boundary: int  # between stage b and b+1
    direction: str  # 'act' | 'grad'
    micro: int
    start: float
    end: float  # channel occupancy end
    arrive: float  # end + propagation latency


@dataclasses.dataclass
class Schedule:
    tasks: List[Task]
    transfers: List[Transfer]
    makespan: float
    num_stages: int
    num_pipelines: int

    def wan_bits(self, spec) -> Dict[Tuple[int, int], float]:
        """Bits the schedule's transfers put on each *directed* WAN DC
        pair — measured from the emitted transfers, the differential
        reference for the analytic per-iteration demand the fleet
        allocator uses (``simulator`` stats ``wan_bits``)."""
        out: Dict[Tuple[int, int], float] = {}
        for tr in self.transfers:
            b = tr.boundary
            dc_a, dc_b = spec.stage_dc[b], spec.stage_dc[b + 1]
            if dc_a == dc_b:
                continue
            src, dst = (dc_a, dc_b) if tr.direction == "act" else (dc_b, dc_a)
            out[(src, dst)] = out.get((src, dst), 0.0) + units.bytes_to_bits(
                spec.act_bytes
            )
        return out


def is_wan_boundary(spec, topo, b: int) -> bool:
    return spec.stage_dc[b] != spec.stage_dc[b + 1]


def atlas_schedule(
    spec,  # repro_torch.core.simulator.PipelineSpec
    topo,  # simulator.GeoTopology | topology.TopologyMatrix
    n_pipelines: int,
    *,
    inflight_cap: Optional[int] = None,
    start_ms: float = 0.0,
    tracer=None,
) -> Schedule:
    """Precompute one iteration's schedule.  ``start_ms`` anchors the
    iteration at an absolute wall-clock offset: time-varying transfers
    are priced against the bandwidth segments in force at
    ``start_ms + (local start)`` — a transfer straddling a segment
    boundary keeps its sent bits and re-integrates the remainder at the
    new rate.  Task/transfer times stay iteration-local.

    ``tracer`` (``repro_torch.obs.Tracer``, recording) emits the raw schedule
    as sim-time spans — one GPU span per task on ``atlas/gpu`` lanes,
    one channel span per WAN transfer on ``atlas/wan`` lanes, anchored
    at ``start_ms``.  Callers going through ``simulate(policy="atlas")``
    should pass the tracer there instead: the wrapped result adds the
    bubble/allreduce accounting and the second-witness expectation."""
    P, M, D = spec.num_stages, spec.microbatches, n_pipelines
    t_f = spec.t_fwd_ms
    t_b = spec.bwd_mult * t_f
    cap = inflight_cap if inflight_cap is not None else P

    def boundary_times(b: int, direction: str = "act") -> Tuple:
        """(occupancy, delivery delay, schedule, rate multiplier) for
        boundary b.

        Direction matters on asymmetric topologies: activations ride the
        b -> b+1 link, gradients the reverse b+1 -> b link (matching the
        event simulator's transfer times).  The intra-DC scatter/gather
        hops stream with the WAN send: they delay delivery but never
        hold the shared WAN channel.

        On a static pair the occupancy is the returned constant; a pair
        with a ``wan.BandwidthSchedule`` is priced per transfer at its
        actual start time (``_occupancy``), the cell's temporal sharing
        entering as a D× rate multiplier.  The returned constant is then
        the *worst-segment* occupancy — used only for the DP-injection
        stagger slot, where a conservative (largest) slot keeps the
        transfer demands interleaved through the slowest segment."""
        dc_a, dc_b = spec.stage_dc[b], spec.stage_dc[b + 1]
        link = topo.link(dc_a, dc_b) if direction == "act" else topo.link(dc_b, dc_a)
        sched = None
        get = getattr(topo, "bandwidth_schedule", None)
        if get is not None:
            sched = get(dc_a, dc_b) if direction == "act" else get(dc_b, dc_a)
        bw = link.bw_gbps if sched is None else sched.min_bw_gbps()
        if sched is not None and sched.is_flat():
            sched = None  # constant rate (= min_bw): keep the fast path
        ser = units.serialization_ms(spec.act_bytes, bw)
        if dc_a == dc_b:
            return ser, link.latency_ms, None, 1
        hop = units.serialization_ms(
            spec.act_bytes * (D - 1) / D, topo.intra_bw_gbps
        )
        return ser / D, link.latency_ms + 2.0 * hop, sched, D

    is_wan = [spec.stage_dc[b] != spec.stage_dc[b + 1] for b in range(P - 1)]
    btimes = {
        (b, d): boundary_times(b, d) for b in range(P - 1) for d in ("act", "grad")
    }

    def _occupancy(b: int, direction: str, start: float) -> float:
        """Channel occupancy of one transfer on boundary b beginning at
        ``start`` — integrates across bandwidth-schedule segments when
        the pair is time-varying, else the memoized constant."""
        ser, _delay, sched, mult = btimes[(b, direction)]
        if sched is None:
            return ser
        return sched.transfer_ms(spec.act_bytes, start_ms + start, rate_mult=mult)

    gpu_free = {(p, s): 0.0 for p in range(D) for s in range(P)}
    chan_free: Dict[Tuple[int, str], float] = {}
    # LocalDPRank stagger (§4.4 rule 1): offset each pipeline's injection
    # by one cell-transfer slot so transfer demands interleave instead of
    # bursting the shared channel (Fig 6(b): DP-2 starts at 1, DP-1 at 5).
    wan_sers = [
        btimes[(b, d)][0]
        for b in range(P - 1)
        if is_wan_boundary(spec, topo, b)
        for d in ("act", "grad")
    ]
    slot = max(wan_sers) if wan_sers else 0.0
    # dependency-readiness of tasks: time activation/grad is available
    avail: Dict[Tuple[str, int, int, int], float] = {}
    for p in range(D):
        for m in range(M):
            avail[("fwd", p, 0, m)] = p * slot
    fwd_sched = {(p, s): 0 for p in range(D) for s in range(P)}
    bwd_sched = {(p, s): 0 for p in range(D) for s in range(P)}

    tasks: List[Task] = []
    transfers: List[Transfer] = []
    n_total = D * P * M * 2
    done = 0

    def task_dur(kind: str, s: int) -> float:
        if kind == "fwd":
            return t_f
        rec = t_f if (spec.recompute and s != P - 1) else 0.0
        return t_b + rec

    def rank_of(key) -> Optional[Tuple]:
        """(feasible start, bwd-first, micro, rank) or None if cap-blocked.

        Rule 3 folds in here: the start is delayed so compute-end meets
        channel-free on the output boundary."""
        kind, p, s, m = key
        if kind == "fwd" and fwd_sched[(p, s)] - bwd_sched[(p, s)] >= cap:
            return None
        t0 = avail[key]
        gf = gpu_free[(p, s)]
        if gf > t0:
            t0 = gf
        has_out = (kind == "fwd" and s < P - 1) or (kind == "bwd" and s > 0)
        if has_out:
            out_b = s if kind == "fwd" else s - 1
            if is_wan[out_b]:
                direction = "act" if kind == "fwd" else "grad"
                cf = chan_free.get((out_b, direction), 0.0) - task_dur(kind, s)
                if cf > t0:
                    t0 = cf
        return (t0, 0 if kind == "bwd" else 1, m, p)

    heap: List[Tuple[Tuple, Tuple]] = []
    # cap-blocked forwards per (p, s), a min-heap of microbatch indices:
    # within one (pipeline, stage) forwards arrive and schedule in micro
    # order, so when a backward frees an in-flight slot only the
    # smallest-m parked forward can be the next candidate
    parked: Dict[Tuple[int, int], List[int]] = {}

    def add(key):
        r = rank_of(key)
        if r is None:
            kind, p, s, m = key
            heapq.heappush(parked.setdefault((p, s), []), m)
        else:
            heap.append((r, key))

    for key in avail:
        add(key)
    heapq.heapify(heap)

    def emit_transfer(p, b, direction, m, ready):
        delay = btimes[(b, direction)][1]
        if is_wan[b]:
            start = max(ready, chan_free.get((b, direction), 0.0))
            occ = _occupancy(b, direction, start)
            chan_free[(b, direction)] = start + occ
        else:
            start = ready  # intra-DC links are effectively uncontended
            occ = _occupancy(b, direction, start)
        arrive = start + occ + delay
        transfers.append(Transfer(p, b, direction, m, start, start + occ, arrive))
        dst = b + 1 if direction == "act" else b
        kind = "fwd" if direction == "act" else "bwd"
        key = (kind, p, dst, m)
        avail[key] = arrive
        r = rank_of(key)
        if r is None:
            heapq.heappush(parked.setdefault((p, dst), []), m)
        else:
            heapq.heappush(heap, (r, key))

    while done < n_total:
        assert heap, "deadlock in atlas schedule (cap too small?)"
        r, key = heapq.heappop(heap)
        if key not in avail:
            continue  # stale duplicate of an already-scheduled task
        r2 = rank_of(key)
        if r2 is None:  # became cap-blocked since it was pushed
            kind, p, s, m = key
            heapq.heappush(parked.setdefault((p, s), []), m)
            continue
        if heap and r2 > heap[0][0]:
            heapq.heappush(heap, (r2, key))  # stale rank: requeue and retry
            continue
        kind, p, s, m = key
        t0 = r2[0]
        del avail[key]
        dur = task_dur(kind, s)
        end = t0 + dur
        gpu_free[(p, s)] = end
        tasks.append(Task(p, s, m, kind, t0, end))
        if kind == "fwd":
            fwd_sched[(p, s)] += 1
            if s < P - 1:
                emit_transfer(p, s, "act", m, end)
            else:
                bkey = ("bwd", p, s, m)
                avail[bkey] = end
                br = rank_of(bkey)
                assert br is not None
                heapq.heappush(heap, (br, bkey))
        else:
            bwd_sched[(p, s)] += 1
            # rule 2: a scheduled backward frees exactly one in-flight
            # slot — admit the smallest-m parked forward for it
            pq = parked.get((p, s))
            if pq:
                pm = heapq.heappop(pq)
                pkey = ("fwd", p, s, pm)
                pr = rank_of(pkey)
                assert pr is not None  # the slot just freed
                heapq.heappush(heap, (pr, pkey))
            if s > 0:
                emit_transfer(p, s - 1, "grad", m, end)
        done += 1

    makespan = max(t.end for t in tasks)
    if transfers:
        makespan = max(makespan, max(tr.arrive for tr in transfers))
    sched = Schedule(tasks, transfers, makespan, P, D)
    if tracer is not None and getattr(tracer, "enabled", False):
        from repro_torch import obs

        obs.trace_schedule(
            tracer, sched, spec, t0_ms=start_ms,
            dc_names=getattr(topo, "dc_names", None),
        )
    return sched
