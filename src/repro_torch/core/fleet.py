"""Multi-job fleet sharing one WAN — contention-priced channels and
cross-job re-plan cascades.

Everything before this module simulated one training job owning every
WAN link.  The paper's premise — workload-aware sharing of *scarce*
inter-DC bandwidth — only bites when several jobs contend for the same
directed channels: job A's migration or re-plan changes the bandwidth
job B observes, so B's drift detector may fire in response.  This
module co-simulates N jobs (each its own ``JobModel``, GPU fleet slice,
placement and optional ``ControlConfig``) over one shared
``TopologyMatrix``:

  * **Channel allocator** — per *directed* DC pair, each job's demand is
    its per-iteration channel bits over its planned iteration time, as a
    rate against the pair's guaranteed (worst-segment) capacity.
    *Temporal sharing first*: when the demands fit the channel together,
    transfers can serialize into each other's idle windows (the same
    §4.2 principle Atlas applies within a job) and every job keeps full
    rate.  Only when the channel is oversubscribed do transfers have to
    overlap, and the allocator falls back to a *weighted max-min fair
    share* — each job's schedule view is scaled to its granted fraction
    (``TopologyMatrix.with_rate_multipliers``), so every engine
    underneath (event simulator, Atlas list-scheduler,
    ``validate.check_schedule``, the horizon runner) prices transfers at
    contended effective bandwidth with no engine changes.
    ``sharing="fair"`` keeps the naive strawman — contenders always
    split the channel by weight even when serialization would have fit —
    as the bench's comparison arm.

  * **Reservation ledger + windowed residual** — every iteration
    records the average rate granted on each pair it crosses
    (``ChannelReservation``).  Grants are *residual-aware*: a window may
    never reserve more than what the open holds of other jobs leave
    free.  Fleet windows are created in nondecreasing start order (the
    scheduler always advances the job with the smallest wall clock), so
    by induction the ledger satisfies the fleet invariant *pointwise*:
    aggregate reserved rate per directed channel never exceeds the
    schedule's capacity at any instant (``validate.check_fleet``).  In
    steady state every open hold sits at or below its fair-share
    target, so the residual never bites and grants equal targets; it
    exists for generation transitions (a job migrating or finishing
    mid-window of another).

  * **Migration admission barrier** — a job migrating *onto* pairs
    where other jobs still have in-flight windows would find only the
    leftover residual there.  Instead its migration stall is extended
    until those holds drain (``HorizonRunner.defer_epoch_start`` —
    epoch/migration tiling is preserved), after which its fair-share
    target is guaranteed available.  Migration stall windows themselves
    are outside the steady-state ledger; their per-pair serialization
    and live-schedule pricing are asserted per job by
    ``validate.check_horizon``.

  * **Cascade + convergence guard** — contention enters each job's
    drift detector through the contended topology view (delivered mean
    bandwidth is the scaled schedule's), so a re-plan by one job can
    push another over its drift threshold and trigger a re-plan chain.
    The fleet bounds each chain: at most ``max_cascade_replans``
    migrations per *cascade epoch*; further fires are suppressed
    (``HorizonRunner.advance(allow_replan=False)``) until every active
    job has completed an iteration without migrating, which closes the
    epoch and resets the budget.  Jobs are processed in deterministic
    wall-clock order (ties broken by job list order), so cascades are
    reproducible.

A single-job fleet degenerates exactly: the lone demander on every
channel keeps ``mult == 1``, ``with_rate_multipliers`` returns the live
topology by identity, and the run is differentially identical to
``control.simulate_horizon`` (tested in ``tests/test_fleet.py``).

The port's own copy of ``repro/core/fleet.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch import obs, units
from repro_torch.core.bubbletea import (
    NVLINK_GBPS_BYTES,
    BubbleTeaController,
    InferenceModelSpec,
    KVQuote,
    PrefillLatencyModel,
    PrefillRequest,
    intersect_bubbles,
    utilization_with_prefills,
)
from repro_torch.core.control import (
    ControlConfig,
    HorizonResult,
    HorizonRunner,
    MigrationModel,
)
from repro_torch.core.dc_selection import JobModel
from repro_torch.core.failures import CheckpointPolicy, FailureTrace
from repro_torch.core.simulator import iteration_wan_bits, simulate
from repro_torch.core.topology import Pair, TopologyMatrix

SHARINGS = ("temporal", "fair")
# pricing floor for a residual-squeezed window, as a fraction of the
# channel's capacity (see fleet.simulate_fleet's grant logic)
MIN_GRANT_FRAC = 0.01
# ledger pseudo-job name for BubbleTea KV-handoff reservations: KV
# transfers are a scavenger class priced at the *residual* rate, but the
# bytes are real — recording them under this name makes later training
# grants' residual() subtract them like any other job's holds, which is
# what keeps check_fleet's pointwise capacity invariant true with
# prefill traffic on the wire
KV_JOB = "~prefill"


@dataclasses.dataclass(frozen=True)
class FleetJob:
    """One training job of the fleet: its workload model, its slice of
    the GPU fleet (per-DC counts), partition count and control knobs.
    ``weight`` is the job's fair-share weight on oversubscribed
    channels (capacity splits proportionally to weight)."""

    name: str
    job: JobModel
    gpus: Dict[str, int]
    P: int
    n_iterations: int
    C: Optional[int] = None
    policy: str = "atlas"
    weight: float = 1.0
    planned_topo: Optional[TopologyMatrix] = None
    control: Optional[ControlConfig] = None
    # per-job checkpoint policy: makes this job's forced failovers and
    # re-plans checkpoint-aware (restore + replay priced against live
    # shipment); None falls back to the fleet MigrationModel's policy
    checkpoint: Optional[CheckpointPolicy] = None

    def __post_init__(self):
        assert self.weight > 0.0, "fair-share weight must be positive"
        assert self.n_iterations >= 1, self.n_iterations


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet-level knobs.

    ``sharing="temporal"`` is the contention-aware policy (serialize
    first, fair-share only under oversubscription); ``"fair"`` is the
    always-fair-share strawman the bench compares against.
    ``max_cascade_replans`` is the convergence guard: migrations allowed
    per cascade epoch before further drift fires are suppressed."""

    sharing: str = "temporal"
    max_cascade_replans: int = 4
    migration: MigrationModel = dataclasses.field(default_factory=MigrationModel)

    def __post_init__(self):
        assert self.sharing in SHARINGS, self.sharing
        assert self.max_cascade_replans >= 1


@dataclasses.dataclass
class ChannelReservation:
    """Average rate one job holds on one directed channel over one
    iteration window — the unit of the fleet capacity invariant."""

    job: str
    pair: Pair
    t0_ms: float
    t1_ms: float
    rate_gbps: float  # allocated average rate over the window
    mult: float  # rate multiplier the job's schedule view was scaled by


@dataclasses.dataclass(frozen=True)
class PrefillService:
    """BubbleTea riding one fleet job: production prefill traffic served
    out of ``host_job``'s training bubbles (paper §5 at fleet scale).

    ``arrivals`` is one continuous arrival-ordered ``PrefillRequest``
    stream (see ``bubbletea.ArrivalProcess``) fed across every horizon
    epoch; ``decode_dc`` names the DC whose dedicated decode GPUs
    receive the KV cache — prefills in other DCs pay for the handoff as
    real WAN traffic on the directed channel (``KVFlows``).  ``tiers``
    maps SLO-class name → TTFT budget (ms) for tier-aware admission;
    ``pp_degree`` must be 1 (each training GPU is its own inference
    pipeline) or the host's ``n_pipelines`` (same-rank GPUs across DP
    cells form one pipeline per stage, §5.1)."""

    host_job: str
    arrivals: Sequence[PrefillRequest]
    model: InferenceModelSpec
    decode_dc: str
    tiers: Optional[Mapping[str, float]] = None
    ttft_slo_ms: Optional[float] = None
    pp_degree: int = 1
    guard_ms: float = 1.0


@dataclasses.dataclass
class FleetResult:
    jobs: Dict[str, HorizonResult]
    reservations: List[ChannelReservation]
    total_ms: float  # wall time the last job finished
    stats: Dict
    prefill: Optional[BubbleTeaController] = None

    @property
    def replans(self) -> int:
        return sum(hr.replans for hr in self.jobs.values())


# ---------------------------------------------------------------------------
# demand + fair-share targets
# ---------------------------------------------------------------------------


def pair_demand_rates(spec, n_pipelines: int, iteration_ms: float) -> Dict[Pair, float]:
    """Average rate (Gbit/s) one job needs on each directed WAN pair:
    its per-iteration channel bits (``simulator.iteration_wan_bits`` —
    the same count every engine reports in ``stats["wan_bits"]``) over
    its iteration time.  Bits/ms = 1e6 · Gbit/s."""
    assert iteration_ms > 0
    bits = iteration_wan_bits(spec, n_pipelines)
    return {p: units.bits_rate_gbps(b, iteration_ms) for p, b in bits.items()}


def _weighted_max_min(entries: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Weighted max-min fair shares of one unit of capacity.

    ``entries`` are ``(key, demand_fraction, weight)``.  Water-fill:
    jobs whose demand sits below their weighted share are satisfied
    exactly and their slack is redistributed; the rest split the
    remaining capacity by weight.  Deterministic in input order."""
    alloc: Dict[str, float] = {}
    active = list(entries)
    remaining = 1.0
    while active:
        wsum = sum(w for _k, _d, w in active)
        sat = [(k, d, w) for k, d, w in active if d <= remaining * w / wsum + 1e-15]
        if not sat:
            for k, _d, w in active:
                alloc[k] = remaining * w / wsum
            return alloc
        for k, d, _w in sat:
            alloc[k] = d
            remaining -= d
        done = {k for k, _d, _w in sat}
        active = [e for e in active if e[0] not in done]
    return alloc


def channel_targets(
    demands: Mapping[str, Mapping[Pair, float]],
    weights: Mapping[str, float],
    topo: TopologyMatrix,
    *,
    sharing: str = "temporal",
    order: Optional[Sequence[str]] = None,
) -> Dict[str, Dict[Pair, Tuple[float, float, Optional[float]]]]:
    """Steady-state allocation targets for every demanded channel.

    Per job and directed pair, returns ``(capped_need, target,
    fixed_mult)``: the demand rate clamped at the pair's guaranteed
    (worst-segment) capacity, the average rate the job is entitled to
    reserve, and — in the naive ``"fair"`` mode — the rate multiplier
    its transfers are pinned to regardless of demand (``None`` in
    temporal mode, where the multiplier follows the granted rate).

    *Temporal sharing first*: a lone demander, or demanders whose
    capped needs fit the channel together, keep ``target ==
    capped_need`` (their transfer windows serialize; nobody slows
    down).  An oversubscribed channel splits by weighted max-min.  By
    construction the targets on one pair sum to at most its
    worst-segment capacity, which is what makes the fleet invariant
    hold pointwise even while the live schedule fluctuates above that
    floor."""
    assert sharing in SHARINGS, sharing
    names = [n for n in (order if order is not None else demands) if n in demands]
    out: Dict[str, Dict[Pair, Tuple[float, float, Optional[float]]]] = {
        n: {} for n in names
    }
    pairs = sorted({p for n in names for p in demands[n]})
    for pair in pairs:
        cap = topo.effective_bw_gbps(*pair)
        entries = [
            (n, min(1.0, demands[n][pair] / cap), weights.get(n, 1.0))
            for n in names
            if pair in demands[n]
        ]
        fits = sum(d for _n, d, _w in entries) <= 1.0 + 1e-12
        if len(entries) == 1 or (sharing == "temporal" and fits):
            for n, d, _w in entries:
                out[n][pair] = (d * cap, d * cap, None)
            continue
        if sharing == "fair":
            # the strawman: overlapping flows always split the channel
            # by weight — transfers run at the share rate even when
            # serialization would have fit everyone at full speed
            wsum = sum(w for _n, _d, w in entries)
            for n, d, w in entries:
                share = w / wsum
                out[n][pair] = (d * cap, min(d, share) * cap, share)
            continue
        shares = _weighted_max_min(entries)
        for n, d, _w in entries:
            out[n][pair] = (d * cap, min(d, shares[n]) * cap, None)
    return out


# ---------------------------------------------------------------------------
# WAN-priced KV handoff
# ---------------------------------------------------------------------------


class KVFlows:
    """Prices BubbleTea KV-cache handoffs on the shared fleet WAN.

    Implements the ``bubbletea`` pricer protocol (``price``/``commit``).
    A prefill whose pipeline DC equals the decode DC hands off over
    NVLink; otherwise the KV bytes are demand on the directed
    ``(src, decode)`` channel, and the transfer is a *scavenger class*:

      * transfers on one channel serialize behind a per-pair cursor
        (KV has no fair-share entitlement — it consumes leftovers);
      * each transfer moves at the pointwise **residual** rate — the
        pair's worst-segment capacity minus every ledger hold open at
        that instant *and* minus the declared steady-state training
        demand on the pair (``demand_rate``) — integrated piecewise
        until the bytes drain, so a training-busy channel stretches the
        quote and the controller's SLO gate rejects the request up
        front.  Subtracting declared demand (not just materialized
        holds) is what keeps KV strictly scavenger-class: a transfer
        running ahead of the training clock must not book the capacity
        the next training window is entitled to, or that window's grant
        would collapse to the pricing floor;
      * on commit, one ``ChannelReservation`` per constant-rate segment
        is recorded under ``KV_JOB``.  Later training grants clip
        against these holds through the same ``residual()`` as against
        each other, and each KV segment's rate is by construction
        exactly the capacity the earlier holds left free — so the
        fleet's pointwise capacity invariant (``validate.check_fleet``)
        survives prefill traffic by the same creation-order induction
        that covers training windows.

    Pricing must see every hold overlapping the transfer, including ones
    the allocator's open-hold index already pruned, so the class keeps
    its own per-pair history fed from the append-only global ledger.
    Dead entries are compacted away only when provably immutable: KV
    segments are final, but a training hold that is the current tail of
    its pair chain may still be extended in place by the allocator's
    window coalescing, so the tail always survives compaction.
    """

    def __init__(
        self,
        live_topo: TopologyMatrix,
        model: InferenceModelSpec,
        decode_dc: int,
        caps: Dict[Pair, float],
        pair_res: Dict[Pair, Deque[ChannelReservation]],
        reservations: List[ChannelReservation],
        demand_rate=None,  # (pair, t) -> summed training demand Gbit/s
        demand_bounds=None,  # () -> iterable of demand-segment edges (ms)
    ):
        self.topo = live_topo
        self.model = model
        self.decode_dc = decode_dc
        self.caps = caps  # shared with the allocator
        self.pair_res = pair_res
        self.reservations = reservations  # shared append-only ledger
        self.demand_rate = demand_rate
        self.demand_bounds = demand_bounds
        self._seen = 0  # absorbed prefix of `reservations`
        self._hist: Dict[Pair, List[ChannelReservation]] = {}
        self._cursor: Dict[Pair, float] = {}
        self.n_wan = 0
        self.n_local = 0
        self.wan_bits = 0.0
        self.local_bits = 0.0
        self.kv_reservations = 0

    def _cap(self, pair: Pair) -> float:
        if pair not in self.caps:
            self.caps[pair] = self.topo.effective_bw_gbps(*pair)
        return self.caps[pair]

    def _absorb(self) -> None:
        while self._seen < len(self.reservations):
            r = self.reservations[self._seen]
            self._seen += 1
            self._hist.setdefault(r.pair, []).append(r)

    def _walk(
        self, pair: Pair, start: float, bits: float
    ) -> Tuple[List[Tuple[float, float, float]], float]:
        """Integrate ``bits`` from ``start`` at the pointwise residual
        rate; returns the constant-rate segments and the finish time."""
        cap = self._cap(pair)
        hist = self._hist.get(pair, [])
        if len(hist) > 64:
            chain = self.pair_res.get(pair)
            tail = chain[-1] if chain else None
            hist = [
                r for r in hist
                if r.t1_ms > start - 1e-9 or (r.job != KV_JOB and r is tail)
            ]
            self._hist[pair] = hist
        holds = [
            (r.t0_ms, r.t1_ms, r.rate_gbps)
            for r in hist
            if r.t1_ms > start + 1e-9 and r.rate_gbps > 0.0
        ]
        edges = {b for h in holds for b in h[:2] if b > start + 1e-9}
        if self.demand_bounds is not None:
            edges |= {b for b in self.demand_bounds() if b > start + 1e-9}
        bounds = sorted(edges)
        segs: List[Tuple[float, float, float]] = []
        t = start
        remaining = bits
        bi = 0
        while remaining > 1e-6:
            while bi < len(bounds) and bounds[bi] <= t + 1e-9:
                bi += 1
            nxt = bounds[bi] if bi < len(bounds) else float("inf")
            held = sum(r for (a, b, r) in holds if a <= t + 1e-9 < b)
            if self.demand_rate is not None:
                held = max(held, min(cap, self.demand_rate(pair, t)))
            rate = max(cap - held, 0.0)
            if rate <= cap * 1e-9:
                if bi >= len(bounds):
                    # permanently saturated (open-ended demand fills the
                    # channel): the transfer never drains — return an
                    # infinite finish so admission rejects the request
                    return segs, float("inf")
                t = nxt
                continue
            need_ms = units.bits_serialization_ms(remaining, rate)
            if t + need_ms <= nxt:
                segs.append((t, t + need_ms, rate))
                t += need_ms
                remaining = 0.0
            else:
                segs.append((t, nxt, rate))
                remaining -= units.window_bits(nxt - t, rate)
                t = nxt
        return segs, t

    # -- pricer protocol ---------------------------------------------------

    def price(self, prompt_tokens: int, src_dc: Optional[int],
              ready_ms: float) -> KVQuote:
        bits = units.bytes_to_bits(prompt_tokens * self.model.kv_bytes_per_token)
        if src_dc is None or src_dc == self.decode_dc:
            kv_ms = units.serialization_ms_gbytes(
                prompt_tokens * self.model.kv_bytes_per_token, NVLINK_GBPS_BYTES
            )
            return KVQuote(prompt_tokens, src_dc, ready_ms, ready_ms,
                           ready_ms + kv_ms, kv_ms)
        self._absorb()
        pair = (src_dc, self.decode_dc)
        start = max(ready_ms, self._cursor.get(pair, 0.0))
        segs, end = self._walk(pair, start, bits)
        if not math.isfinite(end):
            return KVQuote(prompt_tokens, src_dc, ready_ms, start,
                           float("inf"), float("inf"))
        done = end + self.topo.link(*pair).latency_ms
        return KVQuote(prompt_tokens, src_dc, ready_ms, start, done,
                       done - ready_ms, payload=(pair, segs))

    def commit(self, quote: KVQuote) -> None:
        bits = units.bytes_to_bits(quote.prompt_tokens * self.model.kv_bytes_per_token)
        if quote.payload is None:
            self.n_local += 1
            self.local_bits += bits
            return
        pair, segs = quote.payload
        self._cursor[pair] = segs[-1][1]
        cap = self._cap(pair)
        chain = self.pair_res.setdefault(pair, deque())
        for a, b, rate in segs:
            res = ChannelReservation(KV_JOB, pair, a, b, rate, rate / cap)
            self.reservations.append(res)
            chain.append(res)
            self.kv_reservations += 1
        self.n_wan += 1
        self.wan_bits += bits


# ---------------------------------------------------------------------------
# the fleet co-simulator
# ---------------------------------------------------------------------------


def simulate_fleet(
    jobs: Sequence[FleetJob],
    live_topo: TopologyMatrix,
    *,
    config: Optional[FleetConfig] = None,
    validate: bool = False,
    prefill: Optional[PrefillService] = None,
    failures: Optional[FailureTrace] = None,
    tracer=None,
) -> FleetResult:
    """Co-simulate every job of the fleet over the shared live WAN.

    Jobs advance one iteration at a time in wall-clock order (earliest
    current time first, list order on ties).  Before each iteration the
    job's grant on every pair it crosses is ``min(target, residual)`` —
    its fair-share target, clipped by whatever the other jobs' open
    windows leave free — and its runner is handed the matching contended
    topology view.  Targets are recomputed whenever the demand set
    changes (a migration re-placed a job, or a job finished and released
    its channels).  Drift fires that would exceed the cascade budget are
    suppressed until the cascade epoch closes (see module docstring).

    ``prefill`` closes the BubbleTea loop at fleet scale: the host job's
    per-iteration **contended** ``SimResult`` bubbles (a throttled job
    has longer iterations and therefore more bubble supply) become the
    controller's windows, production arrivals are fed in wall-clock
    order, and cross-DC KV handoffs are priced and reserved on the
    shared WAN (``KVFlows``).  A host window ``[t0, t1)`` is processed
    only once the fleet's minimum wall clock has passed ``t1``, so every
    training hold overlapping the window — from any job — is already in
    the ledger when the KV transfers through it are priced.

    ``failures`` injects one fleet-wide ``FailureTrace``: its bandwidth
    consequences are baked into the shared live WAN once (every job —
    reacting or not — prices the same degraded physics), its apply/heal
    steps drive forced failovers inside every runner, and each forced
    migration re-enters the normal cascade plumbing (segment close,
    admission barrier, cascade budget) like a drift migration would.
    Planners still price the raw WAN — failures are always unplanned.

    ``tracer`` (see ``repro_torch.obs``) is shared across every runner: each
    job's iteration/migration/outage spans land under its own
    ``{name}/gpu`` / ``{name}/wan`` / ``{name}/control`` lane groups,
    allocator grant/throttle instants under ``fleet/alloc``, and — at
    horizon end — one span per ledger ``ChannelReservation`` (training
    grants *and* ``~prefill`` KV handoffs) under ``fleet/wan``.
    """
    cfg = config if config is not None else FleetConfig()
    tracing = tracer is not None and getattr(tracer, "enabled", False)
    names = [j.name for j in jobs]
    assert len(set(names)) == len(names), "fleet job names must be unique"
    assert KV_JOB not in names, f"{KV_JOB!r} is reserved for KV handoff"
    planned_default = None
    if failures is not None and len(failures):
        planned_default = live_topo  # the raw WAN the planners believed
        live_topo = failures.apply_to_topology(live_topo)
    runners: Dict[str, HorizonRunner] = {
        j.name: HorizonRunner(
            j.job,
            j.gpus,
            j.P,
            live_topo,
            n_iterations=j.n_iterations,
            planned_topo=(
                j.planned_topo if j.planned_topo is not None else planned_default
            ),
            control=j.control,
            migration=cfg.migration,
            C=j.C,
            policy=j.policy,
            validate=validate,
            failures=failures,
            checkpoint=j.checkpoint,
            tracer=tracer,
            trace_label=j.name,
        )
        for j in jobs
    }
    weights = {j.name: j.weight for j in jobs}
    reservations: List[ChannelReservation] = []
    # per-pair index of *open* holds: closed windows are pruned once the
    # fleet's minimum wall clock passes them (every future window starts
    # at or after that clock, so a dead hold can never matter again) —
    # the full ledger for check_fleet lives in `reservations`
    pair_res: Dict[Pair, Deque[ChannelReservation]] = {}
    stats: Dict = {
        "sharing": cfg.sharing,
        "generations": 0,
        "cascade_replans_max": cfg.max_cascade_replans,
        "cascade_epochs": 0,
        "cascade_suppressed": 0,
        "admission_wait_ms": 0.0,
        "floor_grants": 0,
        "demand_probe_sims": 0,
        "per_job": {
            n: {"throttled_iterations": 0, "throttled_ms": 0.0} for n in names
        },
    }

    # per job, chronological demand segments (start, end, rates): the
    # job's channel demand is active only over the wall-time span that
    # generates it — job A's post-migration demand must not throttle a
    # window of job B that starts before A's migration even begins (A
    # can lag the fleet in wall time).  A migration's new demand claims
    # from the migration *start* (anticipatory: stall included), so no
    # window opened during the stall can re-occupy the migrant's share
    INF = float("inf")
    segments: Dict[str, List[Tuple[float, float, Dict[Pair, float]]]] = {
        n: [] for n in names
    }
    caps: Dict[Pair, float] = {}

    def uncontended_iter_ms(r: HorizonRunner) -> float:
        """One probe simulation of the runner's current epoch against
        the *live* (uncontended) WAN at its current wall offset — the
        full-rate iteration time its channel demand is measured over.
        Contention-independent, so the allocation cannot oscillate with
        its own throttling; one probe per job per epoch."""
        stats["demand_probe_sims"] += 1
        return simulate(
            r.epoch.spec,
            live_topo,
            policy=r.policy,
            n_pipelines=r.epoch.n_pipelines,
            dp_replicas_for_allreduce=r.epoch.dp_replicas,
            start_ms=r.t,
        ).iteration_ms

    def open_segment(name: str, start_ms: Optional[float] = None) -> None:
        """Open the job's current-epoch demand segment at ``start_ms``
        (default: the epoch start).  A migrating job passes its
        migration *start*: the claim is anticipatory — windows other
        jobs open during the stall already count the migrant as a
        demander on its new pairs and leave its fair share free."""
        r = runners[name]
        stats["generations"] += 1
        rates = pair_demand_rates(
            r.epoch.spec, r.epoch.n_pipelines, uncontended_iter_ms(r)
        )
        at = r.epoch.start_ms if start_ms is None else start_ms
        segments[name].append((at, INF, rates))
        for pair in rates:
            if pair not in caps:
                caps[pair] = live_topo.effective_bw_gbps(*pair)

    def close_segment(name: str, t: float) -> None:
        if segments[name]:
            s0, _s1, rates = segments[name][-1]
            segments[name][-1] = (s0, t, rates)

    def demand_at(t: float) -> Dict[str, Dict[Pair, float]]:
        """The demand rates of every job whose epoch is active at ``t``."""
        out: Dict[str, Dict[Pair, float]] = {}
        for n in names:
            for s0, s1, rates in reversed(segments[n]):
                if s0 <= t + 1e-9 and t < s1 - 1e-9:
                    out[n] = rates
                    break
        return out

    def residual(name: str, pair: Pair, t: float) -> float:
        """Capacity the other jobs' open holds leave free on ``pair``
        from ``t`` on.  Per other job, the largest rate among its
        reservations still open at ``t`` bounds its pointwise hold.
        ``t`` is the fleet's minimum wall clock (grants run for the
        earliest job), so heads that ended by ``t`` are dead for every
        future window and are dropped — the scan stays O(open holds),
        not O(horizon)."""
        chain = pair_res.get(pair)
        if chain is None:
            return caps[pair]
        while chain and chain[0].t1_ms <= t + 1e-9:
            chain.popleft()
        held: Dict[str, float] = {}
        for res in chain:
            if res.job != name and res.t1_ms > t + 1e-9:
                held[res.job] = max(held.get(res.job, 0.0), res.rate_gbps)
        return caps[pair] - sum(held.values())

    def grants(name: str, t: float) -> Tuple[Dict[Pair, float], Dict[Pair, float]]:
        """(mults, reserved rates) for one window of ``name`` at ``t``:
        fair-share targets over the demanders active at ``t``, clipped
        per pair by what other jobs' open holds leave free."""
        targets = channel_targets(
            demand_at(t), weights, live_topo, sharing=cfg.sharing, order=names
        )
        mults: Dict[Pair, float] = {}
        reserved: Dict[Pair, float] = {}
        for pair, (capped, target, fixed_mult) in targets.get(name, {}).items():
            allowed = min(target, max(residual(name, pair, t), 0.0))
            reserved[pair] = allowed
            if fixed_mult is not None and allowed >= target - 1e-12:
                # naive fair share, steady state: the rate is pinned to
                # the weight share regardless of demand (average usage
                # is then exactly `target`, which the ledger reserved)
                mults[pair] = fixed_mult
            elif allowed >= capped - 1e-12:
                mults[pair] = 1.0  # temporal sharing: full-rate transfers
            else:
                # residual-squeezed window (either mode): the transfers
                # themselves are slowed to the granted average so the
                # ledger never understates what the engines priced.
                # The anticipatory demand segments + admission barrier
                # keep `allowed >= target` in every constructed case;
                # the floor (1% of capacity, counted in stats) bounds
                # the stretch of the one theoretical corner — a job
                # lagging behind the migrant's claim while straddling
                # its barrier — instead of letting a ~zero residual
                # price a window at effectively no bandwidth
                if allowed < MIN_GRANT_FRAC * caps[pair]:
                    stats["floor_grants"] += 1
                mults[pair] = max(allowed / caps[pair], MIN_GRANT_FRAC)
        return mults, reserved

    for n in names:
        open_segment(n)

    # -- BubbleTea prefill service (closed loop) ---------------------------
    ctrl: Optional[BubbleTeaController] = None
    kvflows: Optional[KVFlows] = None
    arrivals: List[PrefillRequest] = []
    svc_windows: Deque[Tuple[float, float, object, object]] = deque()
    svc_state = {"next": 0, "busy_gpu_ms": 0.0, "span_gpu_ms": 0.0}
    if prefill is not None:
        assert prefill.host_job in runners, prefill.host_job
        arrivals = list(prefill.arrivals)

        def _kv_demand_rate(pair: Pair, t: float) -> float:
            total = 0.0
            for rates in demand_at(t).values():
                r = rates.get(pair, 0.0)
                if r > 0.0:
                    total += min(r, caps.get(pair, r))
            return total

        def _kv_demand_bounds():
            out = set()
            for segs_ in segments.values():
                for s0, s1, _rates in segs_:
                    out.add(s0)
                    if s1 != INF:
                        out.add(s1)
            return out

        kvflows = KVFlows(
            live_topo,
            prefill.model,
            live_topo.index_of(prefill.decode_dc),
            caps,
            pair_res,
            reservations,
            demand_rate=_kv_demand_rate,
            demand_bounds=_kv_demand_bounds,
        )
        ctrl = BubbleTeaController(
            [],
            PrefillLatencyModel(prefill.model),
            pp_degree=prefill.pp_degree,
            guard_ms=prefill.guard_ms,
            ttft_slo_ms=prefill.ttft_slo_ms,
            tiers=prefill.tiers,
            kv=kvflows,
            tracer=tracer,
        )

    def process_window(t0: float, t1: float, res, spec) -> None:
        """One matured host iteration window: swap in its contended
        bubbles (absolute wall-clock, clipped to the window — the last
        window of a horizon is fractional) and feed the arrivals that
        land inside it."""
        pp = ctrl.pp
        if pp == 1:
            keys = sorted(res.busy)
            rel = [res.bubbles[g] for g in keys]
            dcs = [spec.stage_dc[g[1]] for g in keys]
        else:
            assert pp == res.n_pipelines, (
                "pp_degree must be 1 (each GPU its own pipeline) or the "
                "host's n_pipelines (same-rank GPUs across DP cells, §5.1)"
            )
            rel = [
                intersect_bubbles(
                    [res.bubbles[(p, s)] for p in range(res.n_pipelines)]
                )
                for s in range(spec.num_stages)
            ]
            dcs = list(spec.stage_dc)
        span = t1 - t0
        pipes = []
        for windows in rel:
            absw = []
            for a, b in windows:
                b = min(b, span)
                if b - a > 1e-9:
                    absw.append((t0 + a, t0 + b))
            pipes.append(absw)
        ctrl.reset_windows(pipes, pipeline_dc=dcs)
        while (svc_state["next"] < len(arrivals)
               and arrivals[svc_state["next"]].arrival_ms < t1 - 1e-9):
            ctrl.submit(arrivals[svc_state["next"]])
            svc_state["next"] += 1
        n_gpus = len(res.busy)
        svc_state["busy_gpu_ms"] += res.utilization * span * n_gpus
        svc_state["span_gpu_ms"] += span * n_gpus

    topos: Dict[str, TopologyMatrix] = {}
    topo_keys: Dict[str, Tuple] = {}
    cascade_replans = 0
    quiesced: Set[str] = set()
    while True:
        active = [n for n in names if not runners[n].done]
        if not active:
            break
        name = min(active, key=lambda n: (runners[n].t, names.index(n)))
        r = runners[name]
        mults, reserved = grants(name, r.t)
        key = tuple(sorted(mults.items()))
        if topo_keys.get(name) != key:
            # identity-preserving: an unchanged grant keeps the runner's
            # topology object, its crossing set and its reuse cache
            topos[name] = live_topo.with_rate_multipliers(mults)
            topo_keys[name] = key
        r.set_topology(topos[name])
        t0 = r.t
        throttled = any(m < 1.0 for m in mults.values())
        ev = r.advance(allow_replan=cascade_replans < cfg.max_cascade_replans)
        iter_ms = r.iteration_times[-1]
        t_end = r.t if ev == "done" else t0 + iter_ms
        if t_end > t0:
            for pair in sorted(reserved):
                rate = reserved[pair]
                chain = pair_res.setdefault(pair, deque())
                prev = chain[-1] if chain else None
                if (
                    prev is not None
                    and prev.job == name
                    and prev.rate_gbps == rate
                    and abs(prev.t1_ms - t0) < 1e-9
                ):
                    prev.t1_ms = t_end  # coalesce back-to-back windows
                else:
                    res = ChannelReservation(
                        name, pair, t0, t_end, rate, mults.get(pair, 1.0)
                    )
                    reservations.append(res)
                    chain.append(res)
        if throttled:
            pj = stats["per_job"][name]
            pj["throttled_iterations"] += 1
            pj["throttled_ms"] += t_end - t0
        if tracing and reserved and t_end > t0:
            tracer.instant(
                "throttle" if throttled else "grant",
                obs.CAT_FLEET, "fleet/alloc", name, t0,
                pairs=len(reserved),
                min_mult=min(mults.values()) if mults else 1.0,
            )
        if (prefill is not None and name == prefill.host_job
                and t_end > t0 and r.last_result is not None):
            # queue the window; it is processed only once the fleet's
            # minimum clock passes t_end, when every overlapping
            # training hold is in the ledger (see process_window)
            svc_windows.append((t0, t_end, r.last_result, r.epoch.spec))
        if prefill is not None and svc_windows:
            tmin = min(
                (runners[n].t for n in names if not runners[n].done),
                default=INF,
            )
            while svc_windows and svc_windows[0][1] <= tmin + 1e-9:
                process_window(*svc_windows.popleft())

        if ev == "migrated":
            cascade_replans += 1
            quiesced = set()
            mig_start = r.migrations[-1].at_ms
            close_segment(name, mig_start)
            # admission barrier: entering pairs where other jobs still
            # have open windows, wait for those holds to drain — the
            # extended stall keeps the entrant's fair-share target
            # available at its first contended iteration
            new_pairs = pair_demand_rates(r.epoch.spec, r.epoch.n_pipelines, 1.0)
            t_bar = r.t
            for pair in new_pairs:
                for res in pair_res.get(pair, ()):
                    if res.job != name and res.t1_ms > t_bar:
                        t_bar = res.t1_ms
            if t_bar > r.t:
                stats["admission_wait_ms"] += t_bar - r.t
                r.defer_epoch_start(t_bar)
            # the new demand claims from the migration *start* — no
            # unclaimed gap for windows other jobs open during the stall
            open_segment(name, start_ms=mig_start)
            continue
        if ev == "suppressed":
            stats["cascade_suppressed"] += 1
        if ev == "done":
            close_segment(name, r.t)  # the job released its channels
        quiesced.add(name)
        still_active = {n for n in names if not runners[n].done}
        if cascade_replans and still_active <= quiesced:
            # every active job completed an iteration without migrating:
            # the cascade epoch closes, the re-plan budget resets
            cascade_replans = 0
            quiesced = set()
            stats["cascade_epochs"] += 1

    results = {n: runners[n].result() for n in names}
    stats["replans_total"] = sum(hr.replans for hr in results.values())
    for n in names:
        stats["per_job"][n].update(
            total_ms=results[n].total_ms,
            samples=results[n].samples,
            replans=results[n].replans,
            migration_ms=results[n].migration_ms,
            replans_suppressed=results[n].stats.get("replans_suppressed", 0),
        )
    if prefill is not None:
        while svc_windows:  # every job is done; all windows are mature
            process_window(*svc_windows.popleft())
        busy, span = svc_state["busy_gpu_ms"], svc_state["span_gpu_ms"]
        stats["prefill"] = {
            "requests_offered": svc_state["next"],
            "requests_total": len(arrivals),
            "placed": len(ctrl.placements),
            "rejected": len(ctrl.rejected),
            "rejected_slo": len(ctrl.rejected_slo),
            "acceptance": ctrl.acceptance_rate(),
            "per_tier": ctrl.tier_report(),
            "prefill_gpu_busy_ms": ctrl.prefill_gpu_busy_ms(),
            "kv_wan_transfers": kvflows.n_wan,
            "kv_local_transfers": kvflows.n_local,
            "kv_wan_bits": kvflows.wan_bits,
            "kv_reservations": kvflows.kv_reservations,
            "host_gpu_ms": span,
            "utilization_train": busy / span if span > 0 else 0.0,
            "utilization_with_prefills": utilization_with_prefills(
                busy, span, ctrl
            ),
        }
    if tracing:
        # the ledger is final only now: migrations extend holds via
        # coalescing and KV segments append out of wall-clock order
        dcn = live_topo.dc_names
        for hold in reservations:
            tracer.span(
                hold.job, obs.CAT_FLEET, "fleet/wan",
                obs.pair_lane(hold.pair, dcn),
                hold.t0_ms, hold.t1_ms,
                rate_gbps=hold.rate_gbps, mult=hold.mult,
            )
    out = FleetResult(
        jobs=results,
        reservations=reservations,
        total_ms=max((hr.total_ms for hr in results.values()), default=0.0),
        stats=stats,
        prefill=ctrl,
    )
    if validate:
        from repro_torch.core import validate as _validate

        _validate.check_fleet(out, live_topo)
    return out
