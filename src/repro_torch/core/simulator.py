"""Discrete-event simulator for cross-DC pipeline training — paper §3/§6.

Faithfully models the paper's setting:
  - P pipeline stages placed in DCs (contiguous stages per DC, §3.2);
  - M microbatches per minibatch; forward t_f, backward 2·t_f, optional
    recomputation t_f before backward (Varuna semantics, §2);
  - activation/gradient transfers of B·L·H bytes per stage boundary
    (§3.2 fn. 2), serialized per (node-pair, direction) — activations and
    gradients travel in opposite directions and do not compete (§3.2 obs e);
  - WAN node-pair bandwidth from ``repro_torch.core.wan`` (single- vs multi-TCP);
  - schedulers: "gpipe" (all-F then all-B, recompute), "megatron" (1F1B,
    no recompute), "varuna" (1F1B + recompute + backward priority), and
    "atlas" (= varuna compute rules + *temporal bandwidth sharing*: the D
    pipelines of a DP-cell pool their per-node-pair WAN allocations so one
    transfer runs at D× bandwidth, serialized within the cell — §4.3/4.4).

Outputs per-GPU busy intervals (Fig 4 / Fig 13-style timelines), bubbles,
utilization, and iteration time; the DP all-reduce is added analytically
(intra-DC rings, §4.2).

Engine notes (the fast path — see ``repro_torch.core.reference`` for the
original engine these results are differentially tested against):

  * per-GPU ready queues and per-channel pending queues are heaps (the
    original sorted a list per dispatch/pump);
  * per-boundary transfer times are memoized;
  * the baseline policies run their D pipelines with *zero* shared state
    (per-pipeline channels, GPUs, barriers), so one pipeline is simulated
    and replicated D× (each replica gets its own ``Interval`` objects);
  * for large M, ``repro_torch.core.fastforward`` detects the periodic steady
    state from two short probe runs and emits the middle microbatches
    analytically (interval-identical to full replay, else it falls back);
  * bubble/utilization accounting is a single shared pass
    (``_finalize``) over intervals that are already start-sorted.

Event-driven, pure Python; deterministic.

The port's own copy of ``repro/core/simulator.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import units
from repro_torch.core import wan
from repro_torch.core.topology import TopologyMatrix


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    num_stages: int
    microbatches: int
    t_fwd_ms: float  # forward time per stage per microbatch
    act_bytes: float  # activation (= gradient) bytes per boundary
    stage_dc: Tuple[int, ...]  # DC index of each stage
    stage_param_bytes: float = 0.0  # per-stage parameter bytes (for DP all-reduce)
    recompute: bool = True
    bwd_mult: float = 2.0  # t_bwd = bwd_mult · t_fwd
    inflight_cap: Optional[int] = None  # max forwards ahead of backwards


@dataclasses.dataclass(frozen=True)
class GeoTopology:
    """Backward-compatible *uniform* topology: one latency/transport for
    every DC pair.  Heterogeneous WANs use ``repro_torch.core.topology
    .TopologyMatrix``, which exposes the same ``link``/``intra_bw_gbps``
    interface; ``simulate`` and the Atlas scheduler accept either."""

    wan_latency_ms: float = 40.0
    multi_tcp: bool = True
    intra_bw_gbps: float = wan.INTRA_DC_GBPS
    intra_latency_ms: float = wan.INTRA_DC_LATENCY_MS

    def link(self, dc_a: int, dc_b: int) -> wan.Link:
        if dc_a == dc_b:
            return wan.Link(self.intra_latency_ms, self.intra_bw_gbps)
        return wan.wan_link(self.wan_latency_ms, self.multi_tcp)

    def is_wan(self, dc_a: int, dc_b: int) -> bool:
        return dc_a != dc_b

    def bandwidth_schedule(self, dc_a: int, dc_b: int) -> None:
        """Uniform topologies are static; time-varying bandwidth lives on
        ``TopologyMatrix.bw_schedules``."""
        return None

    def matrix(self, n_dcs: int) -> "TopologyMatrix":
        """The equivalent (uniform) ``TopologyMatrix``."""
        return TopologyMatrix.uniform(
            n_dcs,
            wan_latency_ms=self.wan_latency_ms,
            multi_tcp=self.multi_tcp,
            intra_bw_gbps=self.intra_bw_gbps,
            intra_latency_ms=self.intra_latency_ms,
        )


@dataclasses.dataclass
class Interval:
    start: float
    end: float
    kind: str  # 'fwd' | 'rec' | 'bwd' | 'prefill'
    micro: int = -1


@dataclasses.dataclass
class SimResult:
    iteration_ms: float
    busy: Dict[Tuple[int, int], List[Interval]]  # (pipeline, stage) -> intervals
    utilization: float
    # schedulable idle windows within the pipeline span [0, iteration_ms -
    # allreduce_ms]; the trailing DP all-reduce is busy communication, not
    # a bubble (BubbleTea must not place prefills there)
    bubbles: Dict[Tuple[int, int], List[Tuple[float, float]]]
    allreduce_ms: float
    n_pipelines: int
    stats: Optional[Dict] = None  # engine accounting: events, fast_forward, ...
    # per-transfer WAN channel log (``temporal.Transfer`` records,
    # iteration-local times), recorded only when a tracer is attached or
    # ``record_transfers=True`` — the raw material for channel-lane spans
    # and the ``repro_torch.obs`` second-witness wan_bits cross-check.  For the
    # replicated baseline path the log covers the one simulated pipeline;
    # ``stats["replicated_pipelines"]`` scales its accounting.
    transfers: Optional[List] = None

    def stage_bubbles(self, pipeline: int, stage: int) -> List[Tuple[float, float]]:
        return self.bubbles[(pipeline, stage)]


POLICIES = ("gpipe", "megatron", "varuna", "atlas")


def boundary_schedule(topo, spec: PipelineSpec, s_from: int, s_to: int):
    """The ``wan.BandwidthSchedule`` governing the ``s_from -> s_to``
    transfer, or ``None`` when that directed DC pair is static (uniform
    topologies, intra-DC hops, pairs without an attached schedule)."""
    get = getattr(topo, "bandwidth_schedule", None)
    if get is None:
        return None
    return get(spec.stage_dc[s_from], spec.stage_dc[s_to])


def iteration_wan_bits(spec: PipelineSpec, n_pipelines: int) -> Dict[Tuple[int, int], float]:
    """Bits one iteration puts on each *directed* WAN DC pair (all
    ``n_pipelines`` pipelines, both directions).  Analytic and exact for
    every engine path — event replay, Atlas precompute, fast-forward —
    because every microbatch crosses every boundary exactly once per
    direction.  Recorded in ``SimResult.stats["wan_bits"]`` and used by
    the fleet allocator (``repro_torch.core.fleet.pair_demand_rates``) as the
    per-iteration channel demand."""
    out: Dict[Tuple[int, int], float] = {}
    per_boundary = units.bytes_to_bits(spec.microbatches * spec.act_bytes) * n_pipelines
    for s in range(spec.num_stages - 1):
        a, b = spec.stage_dc[s], spec.stage_dc[s + 1]
        if a == b:
            continue
        out[(a, b)] = out.get((a, b), 0.0) + per_boundary
        out[(b, a)] = out.get((b, a), 0.0) + per_boundary
    return out


def has_time_varying_wan(spec: PipelineSpec, topo) -> bool:
    """Does any stage boundary of ``spec`` cross a WAN pair whose
    bandwidth schedule is non-flat (in either direction)?  Gates the
    steady-state fast-forward: a bandwidth change anywhere in the
    iteration breaks the periodicity the extrapolation relies on, and
    the probes (short-M replays) cannot see changes beyond their own
    horizon — so the engine must fall back to full replay."""
    for s in range(spec.num_stages - 1):
        for a, b in ((s, s + 1), (s + 1, s)):
            sched = boundary_schedule(topo, spec, a, b)
            if sched is not None and not sched.is_flat():
                return True
    return False


# ---------------------------------------------------------------------------


def simulate(
    spec: PipelineSpec,
    topo,  # GeoTopology | repro_torch.core.topology.TopologyMatrix
    *,
    policy: str = "varuna",
    n_pipelines: int = 1,
    dp_replicas_for_allreduce: int = 1,
    validate: bool = False,
    fast_forward: Optional[bool] = None,
    start_ms: float = 0.0,
    tracer=None,
    trace_label: str = "sim",
    record_transfers: Optional[bool] = None,
) -> SimResult:
    """Simulate one minibatch (iteration) of ``n_pipelines`` DP pipelines.

    policy: gpipe | megatron | varuna | atlas.  Only "atlas" coordinates
    the pipelines (temporal bandwidth sharing); the baselines run
    identical, independent schedules and compete for nothing (each has its
    own node-pair allocation — the paper's *spatial* sharing).

    ``topo`` is anything exposing ``link(dc_a, dc_b)`` and
    ``intra_bw_gbps`` — the uniform ``GeoTopology`` or a heterogeneous
    ``TopologyMatrix``.  ``validate=True`` runs the physical-invariant
    checker (``repro_torch.core.validate``) on the result before returning.

    ``fast_forward``: ``None`` engages the steady-state fast-forward
    automatically once M is large enough to amortize its two probe runs;
    ``True`` attempts it whenever the probes fit below M; ``False``
    disables it (full event replay).  Whenever detection fails the engine
    silently falls back to full replay — the result is bit-compatible
    either way (``res.stats["fast_forward"]`` records what happened).
    Time-varying bandwidth (a non-flat ``TopologyMatrix`` schedule on a
    WAN boundary) breaks steady-state periodicity, so the fast-forward
    is gated off even under ``fast_forward=True``;
    ``res.stats["fast_forward_gate"]`` records the reason.

    ``start_ms`` places the iteration at an absolute wall-clock offset:
    every time-varying transfer is priced against the bandwidth segments
    in force at ``start_ms + (local start)``, so an in-flight transfer
    straddling a segment boundary keeps the bits already sent and
    re-integrates the remainder at the new rate.  Intervals stay in
    iteration-local time; static and flat pairs are offset-invariant.
    The horizon co-simulator (``repro_torch.core.control``) drives this.

    ``tracer`` (``repro_torch.obs.Tracer``) records the run as structured
    sim-time events: GPU spans per busy interval / bubble / allreduce
    on ``{trace_label}/gpu`` lanes and one channel span per WAN
    transfer on ``{trace_label}/wan`` lanes, anchored at ``start_ms``.
    A recording tracer (or ``record_transfers=True``) keeps the
    per-transfer log on ``SimResult.transfers`` and disables the
    fast-forward — its analytic extrapolation synthesizes intervals
    without replaying transfers, and the emitted timeline must show
    what actually moved on the wire (results are interval-identical by
    design either way).  ``None``/``NullTracer`` leave the hot path
    untouched (see the ``trace_overhead`` bench cell).
    """
    assert policy in POLICIES
    recording = tracer is not None and getattr(tracer, "enabled", False)
    if record_transfers is None:
        record_transfers = recording
    D = n_pipelines
    # Baselines: the D pipelines share nothing (per-pipeline channels,
    # GPUs, barriers) — simulate one and replicate.  Atlas pipelines pool
    # WAN channels per cell and must be simulated together.
    replicate = D if (policy != "atlas" and D > 1) else 1
    engine_D = 1 if policy != "atlas" else D
    transfer_log: Optional[List] = [] if record_transfers else None

    def run_raw(s: PipelineSpec):
        if policy == "atlas":
            return _run_atlas(s, topo, D, start_ms, transfer_log=transfer_log)
        return _run_events(
            s, topo, policy, engine_D, start_ms, transfer_log=transfer_log
        )

    raw = None
    ff_gate = None
    if fast_forward is not False and not record_transfers:
        from repro_torch.core import fastforward

        ff_gate = fastforward.fast_forward_gate(spec, topo)
        if ff_gate is None:
            raw = fastforward.try_fast_forward(
                spec, run_raw, n_pipelines=engine_D, force=fast_forward is True
            )
    if raw is None:
        busy, pp_end, stats = run_raw(spec)
        stats["fast_forward"] = False
        if ff_gate is not None:
            stats["fast_forward_gate"] = ff_gate
    else:
        busy, pp_end, stats = raw
    stats["replicated_pipelines"] = replicate
    if replicate > 1:
        # fresh Interval objects per replica: SimResult consumers may
        # mutate intervals (the validator's negative tests do), and
        # aliased replicas would corrupt each other
        busy = {
            (p, s): (
                ivs if p == 0 else
                [Interval(iv.start, iv.end, iv.kind, iv.micro) for iv in ivs]
            )
            for p in range(replicate)
            for (_, s), ivs in busy.items()
        }
    res = _finalize(spec, topo, busy, pp_end, D, dp_replicas_for_allreduce, stats)
    res.transfers = transfer_log
    res = _maybe_validate(res, spec, policy, validate)
    if recording:
        from repro_torch import obs

        obs.trace_sim_result(
            tracer,
            res,
            spec,
            label=trace_label,
            t0_ms=start_ms,
            dc_names=getattr(topo, "dc_names", None),
        )
    return res


# ---------------------------------------------------------------------------
# heap-based event engine (gpipe / megatron / varuna)
# ---------------------------------------------------------------------------


def _run_events(
    spec: PipelineSpec,
    topo,
    policy: str,
    D: int,
    start_ms: float = 0.0,
    transfer_log: Optional[List] = None,
) -> Tuple[Dict, float, Dict]:
    """Raw event replay: returns (busy, pipeline end time, engine stats).

    ``transfer_log`` (a list, or ``None`` to skip) collects one
    ``temporal.Transfer`` per channel occupancy — the hot path pays one
    ``is not None`` test per transfer when disabled."""
    if transfer_log is not None:
        from repro_torch.core.temporal import Transfer as _Transfer
    P, M = spec.num_stages, spec.microbatches
    recompute = spec.recompute and policy in ("gpipe", "varuna", "atlas")
    inflight_cap = spec.inflight_cap
    if inflight_cap is None:
        inflight_cap = M if policy == "gpipe" else P
    gpipe = policy == "gpipe"
    t_f = spec.t_fwd_ms
    t_b = spec.bwd_mult * spec.t_fwd_ms
    pipes = range(D)

    # --- memoized per-boundary transfer times --------------------------------
    # (channel occupancy ms, extra delivery delay ms, bandwidth schedule):
    # occupancy is the serialization time (the bandwidth resource);
    # propagation latency delays delivery but does not hold the link —
    # back-to-back transfers pipeline through the WAN.  On a static pair
    # the occupancy is a constant, computed once per (s_from, s_to); a
    # time-varying pair carries its schedule instead and integrates the
    # bytes across segment boundaries at each transfer's actual start.
    ttimes: Dict[Tuple[int, int], Tuple[float, float, Optional[object]]] = {}
    for s in range(P - 1):
        for s_from, s_to in ((s, s + 1), (s + 1, s)):
            link = topo.link(spec.stage_dc[s_from], spec.stage_dc[s_to])
            bw = link.bw_gbps
            sched = boundary_schedule(topo, spec, s_from, s_to)
            if sched is not None and sched.is_flat():
                # a flat schedule is a constant rate: keep the memoized
                # fast path (at the schedule's rate, which may override
                # the static link's)
                bw, sched = sched.bw_gbps[0], None
            ser = units.serialization_ms(spec.act_bytes, bw)
            ttimes[(s_from, s_to)] = (ser, link.latency_ms, sched)

    # --- channels: (pipeline, boundary, dir), a heap ordered by (micro,
    # rank) — transfers are *scheduled*, not FIFO (paper §4.4 rule 3):
    # earliest microbatch first (gradients and activations never share a
    # channel — direction is part of the key).
    chan_free: Dict[Tuple, float] = {}
    chan_pending: Dict[Tuple, List[Tuple]] = {}

    # --- state ---
    gpu_free = {(p, s): 0.0 for p in pipes for s in range(P)}
    ready_f: Dict[Tuple[int, int], List[int]] = {g: [] for g in gpu_free}
    ready_b: Dict[Tuple[int, int], List[int]] = {g: [] for g in gpu_free}
    busy: Dict[Tuple[int, int], List[Interval]] = {g: [] for g in gpu_free}
    fwd_done = {g: 0 for g in gpu_free}
    bwd_done = {g: 0 for g in gpu_free}
    fwd_barrier_release: Dict[int, float] = {}  # gpipe: pipeline -> all-F time

    events: List[Tuple[float, int, str, Tuple]] = []
    seq = itertools.count()
    n_events = 0

    def push(t: float, kind: str, payload: Tuple):
        heapq.heappush(events, (t, next(seq), kind, payload))

    # seed: microbatch m ready at stage 0 at t=0
    for p in pipes:
        ready_f[(p, 0)] = list(range(M))  # already a valid heap

    def try_dispatch(g: Tuple[int, int], now: float):
        # backward (incl. its recompute) preempts queued forwards (paper
        # §4.4 rule 4); gpipe holds every backward until the pipeline's
        # forward barrier; the in-flight cap holds every forward alike.
        p, s = g
        if gpu_free[g] > now:
            return
        rb = ready_b[g]
        if rb and not (gpipe and fwd_barrier_release.get(p) is None):
            m = heapq.heappop(rb)
            kind = "bwd"
            dur = t_b + (t_f if (recompute and s != P - 1) else 0.0)
        else:
            rf = ready_f[g]
            if not rf or fwd_done[g] - bwd_done[g] >= inflight_cap:
                return
            m = heapq.heappop(rf)
            kind = "fwd"
            dur = t_f
        gpu_free[g] = now + dur
        busy[g].append(Interval(now, now + dur, kind, m))
        push(now + dur, "gpu_done", (p, s, kind, m))

    def on_gpu_done(now: float, p: int, s: int, kind: str, m: int):
        g = (p, s)
        if kind == "fwd":
            fwd_done[g] += 1
            if s < P - 1:
                request_transfer(now, p, s, s + 1, "act", m)
            else:
                # last stage: backward immediately eligible
                heapq.heappush(ready_b[g], m)
            if gpipe and s == P - 1 and fwd_done[g] == M:
                fwd_barrier_release[p] = now
                try_dispatch((p, P - 1), now)
        else:  # bwd
            bwd_done[g] += 1
            if s > 0:
                request_transfer(now, p, s, s - 1, "grad", m)
        try_dispatch(g, now)

    def request_transfer(now: float, p: int, s_from: int, s_to: int, direction: str, m: int):
        boundary = min(s_from, s_to)
        key = (p, boundary, direction)
        heapq.heappush(
            chan_pending.setdefault(key, []), (m, p, s_from, s_to, direction)
        )
        pump_channel(key, now)

    def pump_channel(key: Tuple, now: float):
        pend = chan_pending.get(key)
        if not pend or chan_free.get(key, 0.0) > now + 1e-12:
            return
        m, p, s_from, s_to, direction = heapq.heappop(pend)
        ser, delay, sched = ttimes[(s_from, s_to)]
        if sched is not None:
            ser = sched.transfer_ms(spec.act_bytes, start_ms + now)
        chan_free[key] = now + ser
        if transfer_log is not None:
            transfer_log.append(
                _Transfer(
                    p, min(s_from, s_to), direction, m,
                    now, now + ser, now + ser + delay,
                )
            )
        push(now + ser + delay, "arrive", (p, s_to, direction, m))
        push(now + ser, "chan_free", (key,))

    def on_arrive(now: float, p: int, s: int, direction: str, m: int):
        g = (p, s)
        if direction == "act":
            heapq.heappush(ready_f[g], m)
        else:
            heapq.heappush(ready_b[g], m)
        try_dispatch(g, now)

    # kick off
    for p in pipes:
        try_dispatch((p, 0), 0.0)

    while events:
        now, _, ev, payload = heapq.heappop(events)
        n_events += 1
        if ev == "gpu_done":
            on_gpu_done(now, *payload)
        elif ev == "arrive":
            on_arrive(now, *payload)
        else:  # chan_free
            pump_channel(payload[0], now)

    pp_end = max((ivs[-1].end for ivs in busy.values() if ivs), default=0.0)
    stats = {"engine": "event-heap", "events": n_events}
    return busy, pp_end, stats


# ---------------------------------------------------------------------------
# Atlas (precomputed §4.4 schedule wrapped into the SimResult shape)
# ---------------------------------------------------------------------------


def _run_atlas(
    spec: PipelineSpec,
    topo,
    n_pipelines: int,
    start_ms: float = 0.0,
    transfer_log: Optional[List] = None,
) -> Tuple[Dict, float, Dict]:
    from repro_torch.core import temporal

    sched = temporal.atlas_schedule(
        spec, topo, n_pipelines, inflight_cap=spec.inflight_cap, start_ms=start_ms
    )
    if transfer_log is not None:
        transfer_log.extend(sched.transfers)
    busy: Dict[Tuple[int, int], List[Interval]] = {
        (p, s): [] for p in range(n_pipelines) for s in range(spec.num_stages)
    }
    for t in sched.tasks:
        busy[(t.pipeline, t.stage)].append(Interval(t.start, t.end, t.kind, t.micro))
    stats = {
        "engine": "atlas-precomputed",
        "events": len(sched.tasks) + len(sched.transfers),
    }
    return busy, sched.makespan, stats


# ---------------------------------------------------------------------------
# shared result assembly: all-reduce, bubbles, utilization
# ---------------------------------------------------------------------------


def _finalize(
    spec: PipelineSpec,
    topo,
    busy: Dict[Tuple[int, int], List[Interval]],
    pp_end: float,
    n_pipelines: int,
    dp_replicas: int,
    stats: Optional[Dict] = None,
) -> SimResult:
    """Wrap raw busy intervals into a SimResult: add the analytic DP
    all-reduce (intra-DC rings, §4.2) and run the single-pass bubble /
    utilization accounting shared by every engine path.

    Bubble extraction is capped at ``pp_end``: the trailing
    ``[pp_end, pp_end + allreduce_ms]`` span is the DP all-reduce, during
    which every GPU is busy communicating — it is *not* schedulable idle
    time, and recording it as a bubble let BubbleTea place prefills on
    GPUs mid-all-reduce.  Utilization stays busy-compute over the whole
    iteration (including the all-reduce span in the denominator)."""
    ar = wan.allreduce_ms(spec.stage_param_bytes, dp_replicas, topo.intra_bw_gbps)
    total = pp_end + ar
    if stats is not None:
        stats["wan_bits"] = iteration_wan_bits(spec, n_pipelines)
    bubbles: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    busy_sum = 0.0
    for g, ivs in busy.items():
        # the event engine appends in dispatch (= start) order; the atlas
        # list-scheduler may interleave — sort only when actually needed
        for i in range(1, len(ivs)):
            if ivs[i].start < ivs[i - 1].start:
                ivs.sort(key=lambda iv: iv.start)
                break
        gaps = []
        cur = 0.0
        for iv in ivs:
            if iv.start > cur + 1e-9:
                gaps.append((cur, iv.start))
            if iv.end > cur:
                cur = iv.end
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
        n_pipelines=n_pipelines,
        stats=stats,
    )


def _maybe_validate(res: SimResult, spec: PipelineSpec, policy: str, validate: bool) -> SimResult:
    if validate:
        from repro_torch.core import validate as _validate

        _validate.check_sim_result(res, spec, policy=policy)
    return res


# ---------------------------------------------------------------------------
# analytic DP-only iteration (paper §3.1, Fig 2)
# ---------------------------------------------------------------------------


def dp_iteration_ms(
    compute_ms: float,
    param_bytes: float,
    n_nodes: int,
    latency_ms: float,
    *,
    multi_tcp: bool = False,
    intra_dc: bool = False,
) -> float:
    """One DP iteration: compute + ring all-reduce over the given network."""
    if intra_dc:
        bw = wan.INTRA_DC_GBPS
    else:
        bw = (
            wan.NODE_PAIR_CAP_GBPS
            if multi_tcp
            else wan.tcp_single_bw_gbps(latency_ms)
        )
    return compute_ms + wan.allreduce_ms(param_bytes, n_nodes, bw)


# ---------------------------------------------------------------------------
# convenience: paper §6.1 testbed-style spec builders
# ---------------------------------------------------------------------------


def testbed_spec(
    *,
    hidden: int,
    seq_len: int,
    micro_batch: int,
    layers_per_stage: int,
    layer_params: float,
    num_stages: int,
    microbatches: int,
    stage_dc: Sequence[int],
    gpu_tflops: float = 312.0,  # A100 bf16 dense
    recompute: bool = True,
) -> PipelineSpec:
    """Derive compute/comm times from model dims (paper §4.2 big-O terms)."""
    # forward FLOPs per microbatch per stage ≈ 6·params·tokens  (fwd=2·,
    # bwd=4· => bwd_mult 2); attention term folded into the constant.
    tokens = micro_batch * seq_len
    stage_params = layers_per_stage * layer_params
    flops_fwd = 2.0 * stage_params * tokens
    t_fwd_ms = flops_fwd / (gpu_tflops * 1e12) * 1e3
    return PipelineSpec(
        num_stages=num_stages,
        microbatches=microbatches,
        t_fwd_ms=t_fwd_ms,
        act_bytes=wan.activation_bytes(micro_batch, seq_len, hidden),
        stage_dc=tuple(stage_dc),
        stage_param_bytes=stage_params * 2.0,  # fp16
        recompute=recompute,
    )
