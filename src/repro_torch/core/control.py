"""Reactive control plane — mid-training re-planning under live WAN drift.

Atlas (paper §4) plans a placement *once*, pricing every link at its
worst-segment bandwidth — but the paper's own Fig 7 premise is that WAN
bandwidth drifts over 24 h, and a static plan holds exactly as long as
the WAN resembles what the planner assumed.  This module closes the
loop: it co-simulates training over a long multi-iteration horizon
against the *live* WAN (``TopologyMatrix.bw_schedules``) and reacts when
delivery deviates from the plan:

  * ``DriftDetector`` — after each iteration, compares the bandwidth
    each monitored link actually delivered (``BandwidthSchedule
    .mean_bw_gbps`` over the iteration's wall-clock span) against what
    the incumbent plan assumed for that link.  It fires only on
    *sustained* deviation: ``hysteresis`` consecutive drifted iterations
    arm it, and a post-fire ``cooldown`` stops thrash — planned diurnal
    wiggle (live trace == planned trace) produces zero deviation and
    never fires.

  * re-planner — on a fire, snapshots the WAN as currently observed
    (``TopologyMatrix.snapshot``), re-runs Algorithm 1 on the snapshot
    (re-picking D; the branch-and-bound order search is warm-started
    from the incumbent order so ties resolve to "stay put"), and prices
    the **migration**: moving every relocated stage's weights plus
    optimizer shards over the live WAN (per directed pair the moves
    serialize on the channel and integrate across bandwidth segments;
    DP replica fan-out rides the intra-DC fabric).  The switch happens
    only when ``remaining_samples × per-sample gain > migration cost +
    margin`` — a re-plan that cannot amortize its own migration is
    declined.

  * ``simulate_horizon`` — the horizon co-simulator: every iteration is
    priced by the event engines at its absolute wall-clock offset
    (``simulate(..., start_ms=t)``), so a transfer in flight when a
    bandwidth segment flips keeps its sent bits and re-integrates the
    remainder at the new rate.  Within an epoch, an iteration whose
    full span sits inside constant-bandwidth segments (for every pair
    the placement crosses) reuses the previous simulation of the same
    rates — the horizon-level steady-state fast-forward.  The reuse is
    gated off across segment boundaries and across re-plan epoch
    boundaries (``fastforward.GATE_REPLAN_EPOCH``), so complexity is
    O((bandwidth segments + re-plans) · sim + iterations), not
    O(iterations · sim).

Progress is tracked in *samples* (one iteration of a D-cell plan
consumes ``D·C·M`` microbatches), so plans with different D remain
comparable and the horizon ends when the static plan's sample budget is
exhausted — reactive and static totals are end-to-end comparable,
migration stalls included.

The port's own copy of ``repro/core/control.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs, units
from repro_torch.core import fastforward
from repro_torch.core.dc_selection import JobModel, PlanEntry, algorithm1, best_plan
from repro_torch.core.failures import CheckpointPolicy, FailureTrace, OutageWindow
from repro_torch.core.simulator import PipelineSpec, simulate
from repro_torch.core.topology import TopologyMatrix


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Knobs of the reactive control plane (defaults are deliberately
    conservative: fire on a sustained ≥20% delivery miss, wait three
    iterations, and require the projected gain to cover the migration)."""

    drift_threshold: float = 0.2  # relative |delivered − assumed| that arms
    hysteresis: int = 3  # consecutive drifted iterations before a fire
    cooldown_iterations: int = 8  # min iterations between re-plan attempts
    min_gain_ms: float = 0.0  # extra margin the switch must clear
    snapshot_window_ms: Optional[float] = None  # None: the last iteration's span


@dataclasses.dataclass(frozen=True)
class MigrationModel:
    """What moving one pipeline stage costs.

    A stage relocation ships its weights plus the optimizer shards —
    ``opt_state_mult`` bytes of optimizer state per parameter byte
    (Adam's two moments at parameter precision by default) — over the
    live WAN via the existing transfer pricing.  Replica fan-out
    (``dp_replicas`` copies of a stage live in its DC, §4.2) streams
    over the intra-DC fabric after the WAN copy lands.

    ``checkpoint`` makes recovery checkpoint-aware: when set, every
    re-plan also prices *restore from the nearest durable checkpoint
    plus lost-work replay* (``plan_restore``) against live weight
    shipment and takes the cheaper — the only recovery path at all when
    the source DC is dead enough that shipment cannot amortize, and the
    only one that exists when a forced re-plan must shrink P (live
    shards cannot be re-partitioned in flight).
    """

    opt_state_mult: float = 2.0
    checkpoint: Optional[CheckpointPolicy] = None

    def stage_bytes(self, param_bytes: float) -> float:
        return param_bytes * (1.0 + self.opt_state_mult)


@dataclasses.dataclass
class MigrationEvent:
    """One executed re-plan: the stall window and what moved.

    ``mode`` records *how* state reached the new placement: ``"ship"``
    moves live weights stage-to-stage; ``"restore"`` pulls every stage
    from a checkpoint placement DC and forfeits ``replay_samples`` of
    progress (the samples since the ``ckpt_ms``-stamped snapshot whose
    progress was ``ckpt_samples``).  ``reason`` is ``"drift"`` for
    detector-triggered re-plans, ``"elasticity"`` for opportunistic
    post-heal/join ones, and ``"dc_outage:…"``/``"slice_preemption:…"``/
    ``"link_failure:…"`` for forced failovers."""

    at_ms: float  # wall time training paused
    duration_ms: float  # stall: max over links of WAN serialization + fan-out
    bytes_per_stage: float
    moves: List[Tuple[int, int, int]]  # (stage, src_dc, dst_dc)
    transfers: List[Tuple[int, int, float, float]]  # (src, dst, start, end)
    projected_gain_ms: float
    remaining_samples: float
    from_D: int
    to_D: int
    mode: str = "ship"
    reason: str = "drift"
    replay_samples: float = 0.0
    ckpt_ms: float = math.nan
    ckpt_samples: float = math.nan

    @property
    def wan_bytes(self) -> float:
        return self.bytes_per_stage * len(self.moves)


@dataclasses.dataclass
class EpochRecord:
    """One span of the horizon governed by a single plan."""

    index: int
    start_ms: float
    start_sample: float
    plan: PlanEntry
    spec: PipelineSpec
    n_pipelines: int  # pipelines per DP-cell (the Atlas temporal-sharing D)
    dp_replicas: int  # total DP replicas (cells × pipelines per cell)
    assumed: TopologyMatrix  # the WAN the plan priced (drift reference)
    iterations: int = 0
    end_ms: float = math.nan

    @property
    def samples_per_iteration(self) -> float:
        return float(self.dp_replicas * self.spec.microbatches)


@dataclasses.dataclass
class HorizonResult:
    total_ms: float
    samples: float
    policy: str
    epochs: List[EpochRecord]
    migrations: List[MigrationEvent]
    iteration_times: List[float]
    stats: Dict
    outages: List[OutageWindow] = dataclasses.field(default_factory=list)

    @property
    def replans(self) -> int:
        return len(self.migrations)

    @property
    def migration_ms(self) -> float:
        return sum(m.duration_ms for m in self.migrations)

    @property
    def replay_samples(self) -> float:
        return sum(m.replay_samples for m in self.migrations)


# ---------------------------------------------------------------------------
# drift detection
# ---------------------------------------------------------------------------


class DriftDetector:
    """Sustained-deviation trigger with hysteresis.

    Feed it the worst per-link relative deviation of each completed
    iteration; it returns True once ``hysteresis`` consecutive
    observations exceeded ``drift_threshold`` (then resets, so the next
    fire needs a fresh streak).  One calm iteration clears the streak —
    a transient trace spike shorter than the hysteresis never fires.
    """

    def __init__(self, cfg: ControlConfig):
        self.cfg = cfg
        self.streak = 0
        self.fires = 0

    def observe(self, deviation: float) -> bool:
        if deviation > self.cfg.drift_threshold:
            self.streak += 1
        else:
            self.streak = 0
        if self.streak >= self.cfg.hysteresis:
            self.streak = 0
            self.fires += 1
            return True
        return False

    def reset(self) -> None:
        self.streak = 0


def link_deviation(
    live: TopologyMatrix, assumed, t0_ms: float, t1_ms: float
) -> float:
    """Worst relative |delivered − assumed| bandwidth across all WAN
    pairs over ``[t0_ms, t1_ms)``.  Delivery is the live schedule's
    window mean; the reference is what the incumbent plan's topology
    assumed for the same window (its own schedule's mean when the plan
    *knew* a trace — so a planned diurnal cycle deviates by exactly 0 —
    else its static link rate)."""
    worst = 0.0
    for a, b in live.wan_pairs():
        sched = live.bandwidth_schedule(a, b)
        delivered = (
            sched.mean_bw_gbps(t0_ms, t1_ms) if sched else live.link(a, b).bw_gbps
        )
        asm_sched = assumed.bandwidth_schedule(a, b)
        asm = (
            asm_sched.mean_bw_gbps(t0_ms, t1_ms)
            if asm_sched
            else assumed.link(a, b).bw_gbps
        )
        worst = max(worst, abs(delivered - asm) / asm)
    return worst


# ---------------------------------------------------------------------------
# plan -> spec, migration pricing
# ---------------------------------------------------------------------------


def plan_spec(job: JobModel, plan: PlanEntry, topo: TopologyMatrix) -> PipelineSpec:
    """The ``PipelineSpec`` a ``PlanEntry`` deploys: stages laid out in
    the plan's DC order, mapped to *topology* indices (the control plane
    requires a named topology — fleet keys are fixed WAN sites)."""
    assert topo.dc_names, "control plane needs a named topology"
    stage_dc: List[int] = []
    for dc in plan.dc_order:
        stage_dc.extend([topo.index_of(dc)] * plan.partitions.get(dc, 0))
    return PipelineSpec(
        num_stages=len(stage_dc),
        microbatches=job.microbatches,
        t_fwd_ms=job.t_fwd_ms,
        act_bytes=job.act_bytes,
        stage_dc=tuple(stage_dc),
        stage_param_bytes=job.partition_param_bytes,
        recompute=job.recompute,
        bwd_mult=job.bwd_mult,
    )


def plan_migration(
    old_stage_dc: Sequence[int],
    new_stage_dc: Sequence[int],
    *,
    param_bytes: float,
    dp_replicas_old: int,
    dp_replicas_new: int,
    topo: TopologyMatrix,
    at_ms: float,
    model: MigrationModel,
) -> MigrationEvent:
    """Price moving from one placement to another at wall time ``at_ms``.

    Every relocated stage ships ``stage_bytes`` (weights + optimizer
    shards) over its ``src → dst`` link; moves sharing a directed pair
    serialize on that channel, each priced by the bandwidth schedule in
    force at its own start (segments integrate — migrating *during* an
    outage is expensive, which is exactly the trade-off the re-planner
    weighs).  Distinct pairs run in parallel.  After the WAN copy, the
    destination DC fans the stage out to its ``dp_replicas_new``
    replicas over the intra-DC fabric; a pure D change (no relocation)
    pays only the fan-out for the extra replicas.  The stall is the
    slowest link's completion plus the slowest DC's fan-out — training
    is paused for the whole window (GPUs and links are occupied;
    ``validate.check_horizon`` asserts nothing overlaps it)."""
    stage_bytes = model.stage_bytes(param_bytes)
    moves = [
        (i, src, dst)
        for i, (src, dst) in enumerate(zip(old_stage_dc, new_stage_dc))
        if src != dst
    ]
    by_pair: Dict[Tuple[int, int], List[int]] = {}
    for i, src, dst in moves:
        by_pair.setdefault((src, dst), []).append(i)

    transfers: List[Tuple[int, int, float, float]] = []
    wan_done = 0.0
    for (src, dst), stages in sorted(by_pair.items()):
        link = topo.link(src, dst)
        sched = topo.bandwidth_schedule(src, dst)
        cur = at_ms
        for _ in stages:
            if sched is not None:
                occ = sched.transfer_ms(stage_bytes, cur)
            else:
                occ = units.serialization_ms(stage_bytes, link.bw_gbps)
            transfers.append((src, dst, cur, cur + occ))
            cur += occ
        wan_done = max(wan_done, (cur - at_ms) + link.latency_ms)

    intra_ms_one = units.serialization_ms(stage_bytes, topo.intra_bw_gbps)
    fan: Dict[int, float] = {}
    for _i, _src, dst in moves:
        fan[dst] = fan.get(dst, 0.0) + (dp_replicas_new - 1) * intra_ms_one
    if dp_replicas_new > dp_replicas_old:
        extra = dp_replicas_new - dp_replicas_old
        for i, (src, dst) in enumerate(zip(old_stage_dc, new_stage_dc)):
            if src == dst:  # unmoved stages still need the new replicas
                fan[dst] = fan.get(dst, 0.0) + extra * intra_ms_one
    fan_ms = max(fan.values(), default=0.0)

    return MigrationEvent(
        at_ms=at_ms,
        duration_ms=wan_done + fan_ms,
        bytes_per_stage=stage_bytes,
        moves=moves,
        transfers=transfers,
        projected_gain_ms=0.0,
        remaining_samples=0.0,
        from_D=dp_replicas_old,
        to_D=dp_replicas_new,
    )


def plan_restore(
    new_stage_dc: Sequence[int],
    *,
    placement_idx: Sequence[int],
    param_bytes: float,
    dp_replicas_old: int,
    dp_replicas_new: int,
    topo: TopologyMatrix,
    at_ms: float,
    model: MigrationModel,
) -> MigrationEvent:
    """Price restoring the *new* placement from checkpoint at ``at_ms``.

    Unlike ``plan_migration`` nothing moves stage-to-stage: every stage
    of the new placement pulls its ``stage_bytes`` (weights + optimizer
    shards) from the nearest *alive* checkpoint placement DC — nearest
    by a one-transfer estimate at the rate in force at ``at_ms``, so a
    placement DC behind a degraded link loses to a farther healthy one.
    Pulls sharing a directed pair serialize on the channel with full
    schedule integration (same physics ``validate.check_horizon``
    re-prices); a stage restored *in* a placement DC loads locally and
    pays only intra-DC fabric.  Fan-out mirrors ``plan_migration``:
    WAN-pulled stages replicate to the remaining ``dp_replicas_new - 1``
    replicas, local loads stream all ``dp_replicas_new`` from in-DC
    storage.  The replay debt (samples since the checkpoint) is *not*
    in the stall — the caller debits progress and the horizon re-earns
    it at the new plan's rate."""
    stage_bytes = model.stage_bytes(param_bytes)
    intra_ms_one = units.serialization_ms(stage_bytes, topo.intra_bw_gbps)
    placement = sorted(set(placement_idx))
    assert placement, "restore needs at least one alive placement DC"

    def pull_est(src: int, dst: int) -> float:
        link = topo.link(src, dst)
        sched = topo.bandwidth_schedule(src, dst)
        bw = sched.bw_at(at_ms) if sched is not None else link.bw_gbps
        return link.latency_ms + units.serialization_ms(stage_bytes, bw)

    moves: List[Tuple[int, int, int]] = []
    by_pair: Dict[Tuple[int, int], List[int]] = {}
    fan: Dict[int, float] = {}
    for i, dst in enumerate(new_stage_dc):
        if dst in placement:
            fan[dst] = fan.get(dst, 0.0) + dp_replicas_new * intra_ms_one
            continue
        src = min(placement, key=lambda p: (pull_est(p, dst), p))
        moves.append((i, src, dst))
        by_pair.setdefault((src, dst), []).append(i)
        fan[dst] = fan.get(dst, 0.0) + (dp_replicas_new - 1) * intra_ms_one

    transfers: List[Tuple[int, int, float, float]] = []
    wan_done = 0.0
    for (src, dst), stages in sorted(by_pair.items()):
        link = topo.link(src, dst)
        sched = topo.bandwidth_schedule(src, dst)
        cur = at_ms
        for _ in stages:
            if sched is not None:
                occ = sched.transfer_ms(stage_bytes, cur)
            else:
                occ = units.serialization_ms(stage_bytes, link.bw_gbps)
            transfers.append((src, dst, cur, cur + occ))
            cur += occ
        wan_done = max(wan_done, (cur - at_ms) + link.latency_ms)
    fan_ms = max(fan.values(), default=0.0)

    return MigrationEvent(
        at_ms=at_ms,
        duration_ms=wan_done + fan_ms,
        bytes_per_stage=stage_bytes,
        moves=moves,
        transfers=transfers,
        projected_gain_ms=0.0,
        remaining_samples=0.0,
        from_D=dp_replicas_old,
        to_D=dp_replicas_new,
        mode="restore",
    )


# ---------------------------------------------------------------------------
# the horizon co-simulator
# ---------------------------------------------------------------------------


def _crossing_schedules(spec: PipelineSpec, topo: TopologyMatrix):
    """Bandwidth schedules governing any directed pair this placement's
    boundaries cross (deduped, deterministic order) — the set whose
    segment boundaries invalidate iteration reuse."""
    out = []
    seen = set()
    for s in range(spec.num_stages - 1):
        for a, b in ((spec.stage_dc[s], spec.stage_dc[s + 1]),
                     (spec.stage_dc[s + 1], spec.stage_dc[s])):
            if a == b:
                continue
            sched = topo.bandwidth_schedule(a, b)
            # dedup by schedule identity, not directed pair: the
            # reverse-pair fallback hands both directions one object
            if sched is None or sched.is_flat() or id(sched) in seen:
                continue
            seen.add(id(sched))
            out.append(sched)
    return out


class HorizonRunner:
    """Stepwise horizon co-simulator — one job, one iteration per call.

    ``simulate_horizon`` drives a runner to completion against the live
    topology; the multi-job fleet (``repro_torch.core.fleet``) interleaves N
    runners in wall-clock order and injects a *contended* topology view
    (``set_topology``) whenever the channel allocator re-partitions the
    shared WAN — every engine underneath (event simulator, Atlas
    list-scheduler, the invariant checker) then prices this job's
    transfers at contended effective bandwidth, and the drift detector
    compares contended delivery against the plan's assumption, which is
    what lets one job's re-plan trigger another's (the cascade).

    ``advance()`` runs exactly one iteration plus the control-plane
    decision for it and returns an event tag:

      ``"done"``       the sample budget is exhausted (partial last
                       iteration included);
      ``"iter"``       a plain iteration (no detector, or no deviation);
      ``"drift"``      deviation above threshold, streak still arming;
      ``"calm"``       deviation below threshold (streak cleared);
      ``"cooldown"``   the detector fired inside the cooldown window;
      ``"suppressed"`` the detector fired but the caller disallowed
                       re-planning (the fleet's cascade guard);
      ``"declined"``   a re-plan was evaluated and rejected (infeasible
                       or the migration cannot amortize);
      ``"noop"``       the re-plan kept the deployment and re-anchored
                       the drift reference;
      ``"migrated"``   a migration executed and a new epoch opened.
    """

    def __init__(
        self,
        job: JobModel,
        fleet: Dict[str, int],
        P: int,
        live_topo: TopologyMatrix,
        *,
        n_iterations: int,
        planned_topo: Optional[TopologyMatrix] = None,
        control: Optional[ControlConfig] = None,
        migration: Optional[MigrationModel] = None,
        C: Optional[int] = None,
        policy: str = "atlas",
        validate: bool = False,
        failures: Optional[FailureTrace] = None,
        checkpoint: Optional[CheckpointPolicy] = None,
        tracer=None,
        trace_label: str = "job",
    ):
        assert live_topo.dc_names, "control plane needs a named topology"
        planned = planned_topo if planned_topo is not None else live_topo
        self.job = job
        self.fleet = fleet
        self.P = P
        self.live_topo = live_topo
        self.topo = live_topo  # current pricing view (fleet may contend it)
        self.control = control
        self.mig_model = migration if migration is not None else MigrationModel()
        self.policy = policy
        self.validate = validate

        # --- tracing: iteration spans are emitted from last_result as
        # each iteration is booked (reused iterations replay the
        # representative result's intervals at their own offset);
        # migration / outage spans wait for _trace_flush because the
        # fleet's admission barrier (defer_epoch_start) can extend a
        # stall after advance() returned
        self.tracer = tracer
        self.trace_label = trace_label
        self._tracing = tracer is not None and getattr(tracer, "enabled", False)
        self._trace_flushed = False
        self._last_dev: Optional[float] = None
        self._last_tag: Optional[str] = None

        job0 = dataclasses.replace(job, topology=planned)
        if C is None:
            C = max(1, round(job0.comm_compute_ratio))
        self.C = C
        plan0 = best_plan(algorithm1(job0, fleet, P, C=C))
        if not math.isfinite(plan0.total_ms):
            raise ValueError("initial plan infeasible for this fleet/P/C")

        self.epoch = self._open_epoch(0, 0.0, 0.0, plan0, planned)
        self.epochs: List[EpochRecord] = [self.epoch]
        self.migrations: List[MigrationEvent] = []
        self.iteration_times: List[float] = []
        self.detector = DriftDetector(control) if control is not None else None
        self.stats: Dict = {
            "iter_sims": 0,
            "iter_reused": 0,
            "drift_iterations": 0,
            "drift_fires": 0,
            "replans_declined": 0,
            "replans_noop": 0,
            "replans_suppressed": 0,
            "replans_forced": 0,
            "fast_forward_gates": {},
        }
        self.samples_total = float(n_iterations) * self.epoch.samples_per_iteration
        self.t = 0.0
        self.samples = 0.0
        self.k = 0  # completed full iterations (cooldown clock)
        self.last_replan_k = -(10 ** 9)
        self._cache: Dict[Tuple, object] = {}
        self.last_result = None  # SimResult of the latest _run_iteration
        # (cache hits reuse the representative result: its busy/bubble
        # intervals are relative to iteration start, so they re-anchor at
        # any wall-clock offset — the fleet's BubbleTea loop relies on
        # this to read *contended* bubbles per iteration window)
        self._crossing = _crossing_schedules(self.epoch.spec, self.topo)
        # an empty budget is already exhausted — advance() must never
        # simulate a phantom iteration for n_iterations=0
        self._done = self.samples_total <= 1e-9

        # --- failure & elasticity state (inert when failures is None;
        # the caller is responsible for running on a live topology with
        # the trace's bandwidth consequences baked in — simulate_horizon
        # and simulate_fleet apply trace.apply_to_topology themselves)
        self.failures = failures
        self.fleet_now: Dict[str, int] = dict(fleet)
        self.dead_dcs: set = set()
        self.dead_pairs: set = set()
        self.outages: List[OutageWindow] = []
        self._timeline = failures.timeline() if failures is not None else []
        self._fail_i = 0
        self._forced_handled: Optional[str] = None  # noop'd forced reason
        self._P0 = P  # original partition count (P-fallback scales from it)
        self._job0 = job

        # --- checkpoint state: the newest *durable* snapshot is what a
        # restore rolls back to (t=0 initial weights are durable by
        # definition); stamps are wall-clock periodic, writes land
        # write_ms later (async — training does not stall for them)
        self.checkpoint = (
            checkpoint if checkpoint is not None else self.mig_model.checkpoint
        )
        if self.checkpoint is not None:
            self._ck_bytes = float(P) * self.mig_model.stage_bytes(
                job.partition_param_bytes
            )
            self._ck_write_ms = self.checkpoint.write_ms(self._ck_bytes)
            self._last_durable = (0.0, 0.0)  # (stamp_ms, samples)
            self._next_ck = self.checkpoint.interval_ms
            self._pending_cks: List[Tuple[float, float, float]] = []

    # -- plumbing ----------------------------------------------------------

    def _open_epoch(self, index, t, samples, plan, assumed) -> EpochRecord:
        spec = plan_spec(self.job, plan, self.live_topo)
        return EpochRecord(
            index=index,
            start_ms=t,
            start_sample=samples,
            plan=plan,
            spec=spec,
            n_pipelines=self.C,
            dp_replicas=plan.D * self.C,
            assumed=assumed,
        )

    @property
    def done(self) -> bool:
        return self._done

    def set_topology(self, topo: TopologyMatrix) -> None:
        """Swap the pricing view (the fleet's contended topology).  The
        iteration-reuse cache and the crossing-schedule set are tied to
        the old view and are rebuilt; passing the current view is a
        no-op so the single-job path keeps its cache across calls."""
        if topo is self.topo:
            return
        self.topo = topo
        self._cache = {}
        self._crossing = _crossing_schedules(self.epoch.spec, topo)

    def _run_iteration(self) -> float:
        t = self.t
        key = tuple(s.bw_at(t) for s in self._crossing)
        hit = self._cache.get(key)
        if hit is not None and all(
            s.constant_over(t, t + hit.iteration_ms) for s in self._crossing
        ):
            self.stats["iter_reused"] += 1
            self.last_result = hit
            return hit.iteration_ms
        # first iteration after a re-plan never extrapolates across the
        # migration (the epoch-boundary gate); otherwise the single-
        # iteration fast-forward engages whenever its own gates allow
        boundary = self.epoch.index > 0 and self.epoch.iterations == 0
        gate = fastforward.fast_forward_gate(
            self.epoch.spec, self.topo, epoch_boundary=boundary
        )
        res = simulate(
            self.epoch.spec,
            self.topo,
            policy=self.policy,
            n_pipelines=self.epoch.n_pipelines,
            dp_replicas_for_allreduce=self.epoch.dp_replicas,
            start_ms=t,
            fast_forward=False if gate is not None else None,
            validate=self.validate,
            # tracing wants every result to carry its transfer log so a
            # (possibly cache-reused) iteration re-anchors channel spans;
            # the tracer itself is NOT passed down — emission happens
            # once per *booked* iteration in advance(), not per sim call
            record_transfers=True if self._tracing else None,
        )
        self.stats["iter_sims"] += 1
        if gate is not None:
            self.stats["fast_forward_gates"][gate] = (
                self.stats["fast_forward_gates"].get(gate, 0) + 1
            )
        if all(s.constant_over(t, t + res.iteration_ms) for s in self._crossing):
            self._cache[key] = res
        self.last_result = res
        return res.iteration_ms

    # -- one iteration + its control decision ------------------------------

    def advance(self, *, allow_replan: bool = True) -> str:
        t0 = self.t
        # the iteration runs under the *incumbent* epoch's placement —
        # capture it now, a "migrated" tag swaps self.epoch before the
        # trace is emitted
        spec0 = self.epoch.spec
        self._last_dev = None
        tag = self._advance_inner(allow_replan=allow_replan)
        if self._tracing:
            self._trace_advance(t0, spec0, tag)
        self._last_tag = tag
        return tag

    def _trace_advance(self, t0: float, spec0, tag: str) -> None:
        """Emit the iteration just booked at its wall-clock start —
        GPU / bubble / allreduce spans plus channel spans from the
        result's transfer log — and the control-plane decision for it.
        The final fractional iteration emits its full window: the
        sample budget ends mid-flight, the spans show the flight."""
        res = self.last_result
        lbl = self.trace_label
        obs.trace_sim_result(
            self.tracer, res, spec0,
            label=lbl, t0_ms=t0, dc_names=self.live_topo.dc_names,
        )
        pid = f"{lbl}/control"
        t_end = t0 + res.iteration_ms  # decision time (pre-stall on "migrated")
        self.tracer.counter("iteration_ms", pid, t_end, res.iteration_ms)
        self.tracer.counter("utilization", pid, t_end, res.utilization)
        emit = tag
        if tag == "iter":
            return
        if tag == "calm":
            if self._last_tag != "drift":
                return  # plain calm iteration, not a drift streak clearing
            emit = "drift_clear"
        args: Dict = {}
        if self._last_dev is not None:
            args["deviation"] = self._last_dev
        if tag == "migrated":
            mig = self.migrations[-1]
            args.update(
                mode=mig.mode, reason=mig.reason, at_ms=mig.at_ms,
                from_D=mig.from_D, to_D=mig.to_D,
            )
        self.tracer.instant(emit, obs.CAT_CONTROL, pid, "decisions", t_end, **args)

    def _advance_inner(self, *, allow_replan: bool = True) -> str:
        assert not self._done, "horizon already exhausted"
        iter_ms = self._run_iteration()
        spi = self.epoch.samples_per_iteration
        if self.samples + spi >= self.samples_total - 1e-9:
            frac = (self.samples_total - self.samples) / spi
            self.t += iter_ms * frac
            self.samples = self.samples_total
            self.epoch.iterations += 1
            self.iteration_times.append(iter_ms)
            self._done = True
            return "done"
        self.t += iter_ms
        self.samples += spi
        self.k += 1
        self.epoch.iterations += 1
        self.iteration_times.append(iter_ms)
        self._note_checkpoints(spi)
        if self._fail_i < len(self._timeline) and (
            self._timeline[self._fail_i][0] <= self.t
        ):
            tag = self._handle_failures(allow_replan=allow_replan, iter_ms=iter_ms)
            if tag is not None:
                return tag
        if self.detector is None:
            return "iter"

        control = self.control
        dev = link_deviation(self.topo, self.epoch.assumed, self.t - iter_ms, self.t)
        self._last_dev = dev
        drifted = dev > control.drift_threshold
        self.stats["drift_iterations"] += int(drifted)
        if not self.detector.observe(dev):
            return "drift" if drifted else "calm"
        self.stats["drift_fires"] += 1
        if self.k - self.last_replan_k < control.cooldown_iterations:
            return "cooldown"
        if not allow_replan:
            # the fleet's cascade guard: the fire is real but this round
            # of the cascade is over budget — treat like a declined
            # attempt (the cooldown clock resets, the budget pressure
            # cannot re-fire every iteration)
            self.last_replan_k = self.k
            self.stats["replans_suppressed"] += 1
            return "suppressed"
        self.last_replan_k = self.k
        return self._attempt_replan(iter_ms=iter_ms, forced=False, reason="drift")

    # -- failure & elasticity ----------------------------------------------

    def _alive_fleet(self) -> Dict[str, int]:
        """The per-DC slices with capacity right now; dead DCs are
        excluded at the Algorithm-1 layer (``exclude_dcs``), not here —
        their GPUs are unreachable, not merely shrunk."""
        return {dc: g for dc, g in self.fleet_now.items() if g > 0}

    def _close_window(self, kind: str, *, dc=None, pair=None) -> None:
        for w in reversed(self.outages):
            if (
                w.kind == kind and w.dc == dc and w.pair == pair
                and math.isinf(w.t1_ms)
            ):
                w.t1_ms = self.t
                return

    def _forced_reason(self) -> Optional[str]:
        """Why the incumbent deployment can no longer run, or None.
        Checked against the *current* epoch: a dead DC hosting stages, a
        preempted slice below the plan's per-DC GPU need (partitions ×
        D × C), or a stage boundary riding a failed link."""
        spec = self.epoch.spec
        used = set(spec.stage_dc)
        for dc in sorted(self.dead_dcs):
            if self.live_topo.index_of(dc) in used:
                return f"dc_outage:{dc}"
        for dc, parts in sorted(self.epoch.plan.partitions.items()):
            if parts <= 0 or dc in self.dead_dcs:
                continue
            if self.fleet_now.get(dc, 0) < parts * self.epoch.dp_replicas:
                return f"slice_preemption:{dc}"
        for fs in sorted(self.dead_pairs, key=sorted):
            a, b = sorted(fs)
            ia, ib = self.live_topo.index_of(a), self.live_topo.index_of(b)
            for s in range(spec.num_stages - 1):
                if {spec.stage_dc[s], spec.stage_dc[s + 1]} == {ia, ib}:
                    return f"link_failure:{a}-{b}"
        return None

    def _handle_failures(self, *, allow_replan: bool, iter_ms: float) -> Optional[str]:
        """Consume every timeline step due by now, then react once: a
        forced failover if the incumbent can no longer run (ignores the
        cascade guard and cooldown — survival is not optional), else an
        opportunistic re-plan after a heal/join (control plane only,
        normal gain gating).  Outage windows open/close at *handled*
        time — iteration granularity, matching what actually ran.
        Returns an event tag for ``advance`` or None to fall through to
        drift detection."""
        healed = joined = False
        while self._fail_i < len(self._timeline) and (
            self._timeline[self._fail_i][0] <= self.t
        ):
            _te, phase, ev = self._timeline[self._fail_i]
            self._fail_i += 1
            self._forced_handled = None
            if phase == "apply":
                if ev.kind == "dc_outage":
                    self.dead_dcs.add(ev.dc)
                    self.outages.append(
                        OutageWindow("dc_outage", t0_ms=self.t, dc=ev.dc)
                    )
                elif ev.kind == "link_failure":
                    self.dead_pairs.add(frozenset(ev.pair))
                    self.outages.append(
                        OutageWindow("link_failure", t0_ms=self.t,
                                     pair=tuple(ev.pair))
                    )
                elif ev.kind == "slice_preemption":
                    self.fleet_now[ev.dc] = max(
                        0, self.fleet_now.get(ev.dc, 0) - ev.gpus
                    )
                else:  # dc_join
                    self.fleet_now[ev.dc] = self.fleet_now.get(ev.dc, 0) + ev.gpus
                    joined = True
            else:  # heal
                healed = True
                if ev.kind == "dc_outage":
                    self.dead_dcs.discard(ev.dc)
                    self._close_window("dc_outage", dc=ev.dc)
                elif ev.kind == "link_failure":
                    self.dead_pairs.discard(frozenset(ev.pair))
                    self._close_window("link_failure", pair=tuple(ev.pair))
                else:  # slice_preemption returns
                    self.fleet_now[ev.dc] = self.fleet_now.get(ev.dc, 0) + ev.gpus

        reason = self._forced_reason()
        if reason is not None and reason != self._forced_handled:
            self.stats["replans_forced"] += 1
            self.last_replan_k = self.k
            tag = self._attempt_replan(iter_ms=iter_ms, forced=True, reason=reason)
            if tag == "noop":
                # bnb kept the incumbent (no viable alternative, e.g. a
                # failed link on a two-DC WAN): remember so the forced
                # path doesn't re-run Algorithm 1 every iteration until
                # the failure state actually changes
                self._forced_handled = reason
            return tag
        if (healed or joined) and self.control is not None:
            if not allow_replan:
                self.stats["replans_suppressed"] += 1
                self.last_replan_k = self.k
                return "suppressed"
            self.last_replan_k = self.k
            return self._attempt_replan(
                iter_ms=iter_ms, forced=False, reason="elasticity"
            )
        return None

    def _note_checkpoints(self, spi: float) -> None:
        """Stamp the checkpoints due by now and promote landed writes.
        A stamp strictly inside the just-finished iteration captures the
        *previous* optimizer step (``samples − spi``: no mid-iteration
        state exists); the async write lands ``write_ms`` later, and
        only a landed write is a restore point."""
        ck = self.checkpoint
        if ck is None:
            return
        while self._next_ck <= self.t + 1e-9:
            stamp = self._next_ck
            snap_samples = (
                self.samples - spi if stamp < self.t - 1e-9 else self.samples
            )
            self._pending_cks.append(
                (stamp + self._ck_write_ms, stamp, max(0.0, snap_samples))
            )
            if self._tracing:
                self.tracer.instant(
                    "checkpoint_stamp", obs.CAT_CONTROL,
                    f"{self.trace_label}/control", "checkpoints", stamp,
                    samples=max(0.0, snap_samples),
                )
            self._next_ck += ck.interval_ms
        while self._pending_cks and self._pending_cks[0][0] <= self.t + 1e-9:
            durable_at, stamp, s = self._pending_cks.pop(0)
            self._last_durable = (stamp, s)
            if self._tracing:
                self.tracer.instant(
                    "checkpoint_durable", obs.CAT_CONTROL,
                    f"{self.trace_label}/control", "checkpoints", durable_at,
                    stamp_ms=stamp, samples=s,
                )

    # -- the re-plan attempt (drift, elasticity, and forced failover) ------

    def _job_for_P(self, P_try: int) -> JobModel:
        """The job re-partitioned into ``P_try`` layer-partitions: each
        partition holds ``P0/P_try ×`` the layers, so per-partition
        weights and forward time scale together; boundary activations
        and the microbatch count are partition-size-independent."""
        if P_try == self.P:
            return self.job
        scale = self._P0 / P_try
        return dataclasses.replace(
            self._job0,
            partition_param_bytes=self._job0.partition_param_bytes * scale,
            t_fwd_ms=self._job0.t_fwd_ms * scale,
        )

    def _attempt_replan(self, *, iter_ms: float, forced: bool, reason: str) -> str:
        """Re-run Algorithm 1 on the observed WAN over the surviving
        fleet and execute the cheaper of live-weight shipment vs
        checkpoint restore (+ replay debt) when the switch pays for
        itself — forced failovers skip the gain test (the incumbent
        cannot run at all) and may shrink P when no placement at the
        current partition count survives (divisors of the original P,
        largest first; shrinking P requires a checkpoint — live shards
        cannot be re-partitioned in flight)."""
        control = self.control
        t = self.t
        window = control.snapshot_window_ms if control is not None else None
        snap = self.topo.snapshot(t, window_ms=iter_ms if window is None else window)
        alive = self._alive_fleet()
        if forced:
            P_candidates = [
                p for p in range(self._P0, 0, -1)
                if self._P0 % p == 0 and p <= self.P
            ]
        else:
            P_candidates = [self.P]
        cand = cand_P = job_p = None
        surviving = {dc for dc in alive if dc not in self.dead_dcs}
        for P_try in P_candidates:
            if not surviving:
                break
            job_try = self._job_for_P(P_try)
            job_s = dataclasses.replace(job_try, topology=snap)
            incumbent = self.epoch.plan.dc_order if P_try == self.P else None
            c = best_plan(
                algorithm1(
                    job_s, alive, P_try, C=self.C,
                    incumbent_order=incumbent,
                    exclude_dcs=sorted(self.dead_dcs) if self.dead_dcs else None,
                )
            )
            if math.isfinite(c.total_ms):
                cand, cand_P, job_p = c, P_try, job_try
                break
        if cand is None:
            if forced:
                raise ValueError(
                    f"forced failover ({reason}): no feasible placement "
                    f"survives on fleet {alive} at any P in {P_candidates}"
                )
            self.stats["replans_declined"] += 1
            return "declined"
        cand_spec = plan_spec(job_p, cand, self.live_topo)
        if (
            cand_P == self.P
            and cand_spec.stage_dc == self.epoch.spec.stage_dc
            and cand.D == self.epoch.plan.D
        ):
            # same deployment under current conditions: re-anchor the
            # drift reference so the detector stops firing on a change
            # the plan already tolerates best
            self.epoch.assumed = snap
            self.stats["replans_noop"] += 1
            return "noop"

        # price the recovery modes: live shipment (stage-to-stage, only
        # meaningful at unchanged P) vs checkpoint restore + replay
        dp_new = cand.D * self.C
        options: List[Tuple[str, MigrationEvent, float]] = []
        if cand_P == self.P:
            options.append((
                "ship",
                plan_migration(
                    self.epoch.spec.stage_dc,
                    cand_spec.stage_dc,
                    param_bytes=job_p.partition_param_bytes,
                    dp_replicas_old=self.epoch.dp_replicas,
                    dp_replicas_new=dp_new,
                    topo=self.topo,
                    at_ms=t,
                    model=self.mig_model,
                ),
                0.0,
            ))
        ck = None
        if self.checkpoint is not None:
            placement_alive = self.checkpoint.alive_placement(self.dead_dcs)
            if placement_alive:
                ck = self._last_durable
                options.append((
                    "restore",
                    plan_restore(
                        cand_spec.stage_dc,
                        placement_idx=[
                            self.live_topo.index_of(d) for d in placement_alive
                        ],
                        param_bytes=job_p.partition_param_bytes,
                        dp_replicas_old=self.epoch.dp_replicas,
                        dp_replicas_new=dp_new,
                        topo=self.topo,
                        at_ms=t,
                        model=self.mig_model,
                    ),
                    max(0.0, self.samples - ck[1]),
                ))
        if not options:
            if forced:
                raise ValueError(
                    f"forced failover ({reason}) must shrink P to {cand_P} "
                    "but no checkpoint policy is configured — live shards "
                    "cannot be re-partitioned in flight"
                )
            self.stats["replans_declined"] += 1
            return "declined"

        best = None
        for mode, mig, replay in options:
            cand_res = simulate(
                cand_spec,
                self.topo,
                policy=self.policy,
                n_pipelines=self.C,
                dp_replicas_for_allreduce=dp_new,
                start_ms=t + mig.duration_ms,
            )
            cand_per_sample = cand_res.iteration_ms / (
                dp_new * job_p.microbatches
            )
            # effective cost: the stall plus the wall time to re-earn
            # the forfeited samples at the candidate's own rate
            cost = mig.duration_ms + replay * cand_per_sample
            if best is None or cost < best[4]:
                best = (mode, mig, replay, cand_per_sample, cost)
        mode, mig, replay, cand_per_sample, cost = best
        inc_per_sample = iter_ms / self.epoch.samples_per_iteration
        remaining = self.samples_total - self.samples
        gain = remaining * (inc_per_sample - cand_per_sample)
        if not forced and gain <= cost + control.min_gain_ms:
            self.stats["replans_declined"] += 1
            return "declined"

        mig.projected_gain_ms = gain
        mig.remaining_samples = remaining
        mig.reason = reason
        self.migrations.append(mig)
        self.epoch.end_ms = t
        self.t = t + mig.duration_ms
        if mode == "restore":
            mig.replay_samples = replay
            mig.ckpt_ms, mig.ckpt_samples = ck
            self.samples = ck[1]
            # in-flight snapshot writes die with the old deployment; the
            # cadence restarts from the restore point
            self._pending_cks = []
            self._next_ck = self.t + self.checkpoint.interval_ms
        if cand_P != self.P:
            self.P = cand_P
            self.job = job_p
        self.epoch = self._open_epoch(
            self.epoch.index + 1, self.t, self.samples, cand, snap
        )
        self.epochs.append(self.epoch)
        if self.detector is not None:
            self.detector.reset()
        self._cache = {}
        self._crossing = _crossing_schedules(self.epoch.spec, self.topo)
        self._forced_handled = None
        return "migrated"

    def defer_epoch_start(self, new_t_ms: float) -> None:
        """Admission barrier hook for the fleet: extend the migration
        stall that just opened the current epoch so the epoch starts at
        ``new_t_ms`` — a job migrating *onto* channels other jobs hold
        in-flight windows on waits for those windows to drain before its
        first contended iteration.  Epoch/migration tiling is preserved
        (the wait is part of the stall; ``validate.check_horizon`` still
        holds) and the migration's transfers stay inside the window."""
        assert self.migrations and self.epoch.iterations == 0, (
            "defer_epoch_start only applies to a freshly migrated epoch"
        )
        assert abs(self.epoch.start_ms - self.t) < 1e-9
        if new_t_ms <= self.t:
            return
        self.migrations[-1].duration_ms += new_t_ms - self.t
        self.t = new_t_ms
        self.epoch.start_ms = new_t_ms

    def _trace_flush(self) -> None:
        """One-shot end-of-run emission of everything whose extent is
        only final at horizon end: migration stall spans (the fleet's
        admission barrier may have extended them via
        ``defer_epoch_start``), per-lane ``migration-stall`` GPU spans
        on the *new* epoch's lane grid, and outage windows (still-open
        windows clamp to the horizon end)."""
        if not self._tracing or self._trace_flushed:
            return
        self._trace_flushed = True
        tr = self.tracer
        lbl = self.trace_label
        pid = f"{lbl}/control"
        # migration i opened epoch i+1 — its stall stands on that
        # epoch's lane grid (n_pipelines × stages matches busy keys on
        # every engine path)
        for mig, ep in zip(self.migrations, self.epochs[1:]):
            t1 = mig.at_ms + mig.duration_ms
            tr.span(
                f"migration:{mig.mode}", obs.CAT_CONTROL, pid, "migrations",
                mig.at_ms, t1,
                reason=mig.reason, from_D=mig.from_D, to_D=mig.to_D,
                moves=len(mig.moves), wan_bytes=mig.wan_bytes,
                replay_samples=mig.replay_samples,
                projected_gain_ms=mig.projected_gain_ms,
                duration_ms=mig.duration_ms,
            )
            for p in range(ep.n_pipelines):
                for s in range(ep.spec.num_stages):
                    tr.span(
                        "migration-stall", obs.CAT_GPU, f"{lbl}/gpu",
                        f"p{p}/s{s}", mig.at_ms, t1, dc=ep.spec.stage_dc[s],
                    )
        for w in self.outages:
            t1 = self.t if math.isinf(w.t1_ms) else w.t1_ms
            tr.span(
                f"outage:{w.kind}", obs.CAT_CONTROL, pid, "failures",
                w.t0_ms, t1, **w.trace_args(self.live_topo),
            )

    def result(self) -> HorizonResult:
        self.epoch.end_ms = self.t
        self._trace_flush()
        return HorizonResult(
            total_ms=self.t,
            samples=self.samples,
            policy=self.policy,
            epochs=self.epochs,
            migrations=self.migrations,
            iteration_times=self.iteration_times,
            stats=self.stats,
            outages=self.outages,
        )


def simulate_horizon(
    job: JobModel,
    fleet: Dict[str, int],
    P: int,
    live_topo: TopologyMatrix,
    *,
    n_iterations: int,
    planned_topo: Optional[TopologyMatrix] = None,
    control: Optional[ControlConfig] = None,
    migration: Optional[MigrationModel] = None,
    C: Optional[int] = None,
    policy: str = "atlas",
    validate: bool = False,
    failures: Optional[FailureTrace] = None,
    checkpoint: Optional[CheckpointPolicy] = None,
    tracer=None,
    trace_label: str = "job",
) -> HorizonResult:
    """Co-simulate ``n_iterations`` (of the initial plan's global batch)
    against the live WAN, optionally with the reactive control plane.

    ``planned_topo`` is what Algorithm 1 believed at t=0 (default: the
    live topology — the planner knew the whole trace); the live/planned
    split is how an *unplanned* outage is modelled.  ``control=None``
    runs the static PR-3 behaviour — plan once, never react — so the
    same call is both arms of the reactive-vs-static comparison.  ``C``
    (pipelines per DP-cell) is pinned across re-plans: re-sizing a cell
    is a full re-shard, not a migration; D is re-picked freely.

    ``failures`` injects a seeded ``FailureTrace``: its bandwidth
    consequences are baked into the live topology here
    (``apply_to_topology`` — the planner still prices the *raw* WAN, so
    failures are always unplanned), and its apply/heal steps drive
    forced failovers and opportunistic elasticity re-plans inside the
    runner.  ``checkpoint`` (or ``migration.checkpoint``) makes those
    recoveries checkpoint-aware.

    This is the single-job driver of ``HorizonRunner``; the multi-job
    fleet (``repro_torch.core.fleet.simulate_fleet``) interleaves several
    runners over one shared WAN and is differentially identical to this
    function when the fleet has exactly one job.
    """
    if failures is not None and len(failures):
        if planned_topo is None:
            planned_topo = live_topo
        live_topo = failures.apply_to_topology(live_topo)
    runner = HorizonRunner(
        job, fleet, P, live_topo,
        n_iterations=n_iterations,
        planned_topo=planned_topo,
        control=control,
        migration=migration,
        C=C,
        policy=policy,
        validate=validate,
        failures=failures,
        checkpoint=checkpoint,
        tracer=tracer,
        trace_label=trace_label,
    )
    while not runner.done:
        runner.advance()
    return runner.result()
