"""Seeded failure & elasticity engine — DC loss, spot preemption, joins.

The reactive control plane (``repro_torch.core.control``) assumes every DC
survives the horizon: drift can re-route a placement, but nothing can
*force* one — a dead DC still hosts stages, a preempted spot slice still
counts toward capacity, and a freshly joined DC is invisible until the
next drift fire happens to re-plan.  Real geo-distributed fleets lose
DCs, get slices reclaimed, and gain capacity mid-run (ATOM's join/leave
elasticity; "99 Problems But FLOPS Ain't One" on WAN-scale failure
planning).  This module supplies the missing event model:

  * ``FailureEvent`` — one timestamped event: ``dc_outage`` (optionally
    healing after ``recover_ms``), ``slice_preemption`` (a DC's GPU
    slice shrinks), ``dc_join`` (capacity arrives), ``link_failure``
    (one WAN pair degrades, optionally healing).

  * ``FailureTrace`` — an ordered, optionally seed-generated sequence of
    events.  ``apply_to_topology`` bakes the bandwidth consequences into
    a ``TopologyMatrix`` (every directed pair touching a dead DC — or
    the failed pair itself — drops to ``residual_frac`` of its nominal
    rate for the outage window), so the *same physics* degrade a static
    run, a ship-live-weights recovery, and a checkpoint-aware one.
    ``timeline()`` yields the apply/heal steps the ``HorizonRunner``
    consumes to mutate its surviving fleet and force re-plans.

  * ``CheckpointPolicy`` — periodic async checkpoints written to
    ``placement`` DCs at ``write_bw_gbps``; feeds checkpoint *recency*
    (how many samples a restore forfeits) and *placement* (which DC a
    restore pulls from) into ``control.plan_restore`` so recovery can
    price restore-plus-replay against live weight shipment.

  * ``OutageWindow`` — the audit record of one outage's span, consumed
    by ``validate.check_horizon``/``check_fleet`` to assert nothing ran
    on (or reserved a channel into) a dead DC while it was down.

Bandwidth during an outage is *residual*, not zero: a reclaimed or
partitioned DC can usually still be reached over a trickle path (spot
grace periods, partial partitions), which is exactly what makes
"ship the live weights out anyway" finite-but-expensive — the trade
checkpoint-aware recovery is designed to win.  ``BandwidthSchedule``
also requires strictly positive rates, so a true hard-zero is
approximated by a small ``residual_frac``.

No jax imports here: the failure engine must run in the numpy-only
perf-smoke environment.

The port's own copy of ``repro/core/failures.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch import units
from repro_torch.core import wan
from repro_torch.core.topology import TopologyMatrix

KINDS = ("dc_outage", "slice_preemption", "dc_join", "link_failure")


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One timestamped failure/elasticity event.

    ``dc_outage``       ``dc`` goes dark at ``at_ms``; every WAN pair
                        touching it delivers ``residual_frac`` of its
                        nominal rate until ``at_ms + recover_ms`` (or
                        forever when ``recover_ms`` is None), and the
                        DC's GPUs leave the schedulable fleet.
    ``slice_preemption``  ``gpus`` GPUs of ``dc``'s slice are reclaimed
                        (per affected job — spot slices are per-tenant).
                        Bandwidth is untouched.
    ``dc_join``         ``dc`` offers ``gpus`` additional GPUs from
                        ``at_ms`` on — an opportunity, never a forced
                        re-plan.
    ``link_failure``    both directions of WAN pair ``pair`` drop to
                        ``residual_frac`` until recovery.
    """

    at_ms: float
    kind: str
    dc: Optional[str] = None
    gpus: int = 0
    pair: Optional[Tuple[str, str]] = None
    recover_ms: Optional[float] = None
    residual_frac: float = 0.05

    def __post_init__(self):
        assert self.kind in KINDS, f"unknown failure kind {self.kind!r}"
        assert self.at_ms >= 0.0, self.at_ms
        assert 0.0 < self.residual_frac < 1.0, self.residual_frac
        if self.kind == "link_failure":
            assert self.pair is not None and len(self.pair) == 2, self.pair
        else:
            assert self.dc is not None, f"{self.kind} needs a dc"
        if self.kind in ("slice_preemption", "dc_join"):
            assert self.gpus > 0, f"{self.kind} needs gpus > 0"
        if self.recover_ms is not None:
            assert self.recover_ms > 0.0, self.recover_ms

    @property
    def recovery_ms(self) -> Optional[float]:
        """Absolute heal time, or None when the failure is permanent."""
        if self.recover_ms is None:
            return None
        return self.at_ms + self.recover_ms

    def degrades_bandwidth(self) -> bool:
        return self.kind in ("dc_outage", "link_failure")


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Periodic async checkpointing for checkpoint-aware recovery.

    Every ``interval_ms`` of wall time the job snapshots its full state
    (weights + optimizer shards) and streams it to the ``placement``
    DCs at ``write_bw_gbps`` — the write is *asynchronous* (training
    does not stall for it), but a snapshot only becomes restorable once
    the write lands, ``write_ms`` after its stamp.  A restore pulls
    from the nearest *alive* placement DC and forfeits every sample
    since the newest durable snapshot (the replay debt
    ``control.plan_restore`` prices against live weight shipment).
    """

    interval_ms: float
    placement: Tuple[str, ...]
    write_bw_gbps: float = 1.0

    def __post_init__(self):
        assert self.interval_ms > 0.0, self.interval_ms
        assert self.placement, "checkpoint policy needs at least one placement DC"
        assert self.write_bw_gbps > 0.0, self.write_bw_gbps

    def write_ms(self, nbytes: float) -> float:
        """Async-write landing latency of one ``nbytes`` snapshot."""
        return units.serialization_ms(nbytes, self.write_bw_gbps)

    def alive_placement(self, dead_dcs) -> Tuple[str, ...]:
        return tuple(dc for dc in self.placement if dc not in dead_dcs)


@dataclasses.dataclass
class OutageWindow:
    """Audit record of one outage span — the negative-checkable fact
    ``validate.check_horizon``/``check_fleet`` test GPU busy time and
    channel reservations against.  ``t1_ms`` stays ``inf`` while the
    outage is unresolved at horizon end.  Windows open at the wall time
    the runner *handled* the event (iteration granularity): the
    iteration in flight when the failure lands completes, and only the
    span after the forced failover is claimed dead."""

    kind: str
    t0_ms: float
    t1_ms: float = math.inf
    dc: Optional[str] = None
    pair: Optional[Tuple[str, str]] = None

    def trace_args(self, topo: Optional[TopologyMatrix] = None) -> Dict:
        """Span args for the tracing layer: the named dc/pair plus their
        topology indices (when resolvable), so a trace validator can
        match outage windows against GPU-span ``dc`` indices without a
        name table."""
        out: Dict = {}
        if self.dc is not None:
            out["dc"] = self.dc
            if topo is not None and topo.dc_names:
                out["dc_index"] = topo.index_of(self.dc)
        if self.pair is not None:
            out["pair"] = list(self.pair)
            if topo is not None and topo.dc_names:
                out["pair_index"] = [topo.index_of(d) for d in self.pair]
        return out


@dataclasses.dataclass(frozen=True)
class FailureTrace:
    """An ordered, replayable sequence of failure/elasticity events.

    Events are sorted by ``at_ms`` on construction; ``timeline()``
    interleaves each event's apply step with its heal step (when it
    recovers), so a runner consumes one monotone stream.  The same
    trace (same ``seed`` through ``generate``) always replays the same
    cascade — determinism is a tested property.
    """

    events: Tuple[FailureEvent, ...]
    seed: Optional[int] = None

    def __post_init__(self):
        evs = tuple(sorted(self.events, key=lambda e: e.at_ms))
        object.__setattr__(self, "events", evs)

    def __len__(self) -> int:
        return len(self.events)

    def timeline(self) -> List[Tuple[float, str, FailureEvent]]:
        """Monotone ``(t_ms, phase, event)`` steps, ``phase`` in
        ``("apply", "heal")``; heals only exist for recovering
        ``dc_outage``/``link_failure`` events.  Ties order applies
        before heals, then by event order."""
        steps: List[Tuple[float, int, int, str, FailureEvent]] = []
        for i, ev in enumerate(self.events):
            steps.append((ev.at_ms, 0, i, "apply", ev))
            if ev.degrades_bandwidth() and ev.recover_ms is not None:
                steps.append((ev.recovery_ms, 1, i, "heal", ev))
            elif ev.kind == "slice_preemption" and ev.recover_ms is not None:
                steps.append((ev.recovery_ms, 1, i, "heal", ev))
        steps.sort(key=lambda s: (s[0], s[1], s[2]))
        return [(t, phase, ev) for t, _p, _i, phase, ev in steps]

    @classmethod
    def generate(
        cls,
        dcs: Sequence[str],
        *,
        seed: int,
        horizon_ms: float,
        n_events: int = 3,
        kinds: Sequence[str] = ("dc_outage", "slice_preemption", "dc_join"),
        mean_recover_frac: float = 0.3,
        max_slice_gpus: int = 4,
        residual_frac: float = 0.05,
    ) -> "FailureTrace":
        """A seeded random trace over ``dcs`` — same seed, same trace,
        same cascade.  Events land uniformly in the middle 80% of the
        horizon; outages recover after an exponential holding time of
        mean ``mean_recover_frac · horizon_ms`` (clamped away from
        zero) so some traces heal in-horizon and some don't."""
        rng = random.Random(seed)
        events: List[FailureEvent] = []
        names = list(dcs)
        for _ in range(n_events):
            kind = rng.choice(list(kinds))
            at = rng.uniform(0.1, 0.9) * horizon_ms
            if kind == "link_failure":
                a, b = rng.sample(names, 2)
                events.append(FailureEvent(
                    at_ms=at, kind=kind, pair=(a, b),
                    recover_ms=max(1.0, rng.expovariate(
                        1.0 / (mean_recover_frac * horizon_ms))),
                    residual_frac=residual_frac,
                ))
                continue
            dc = rng.choice(names)
            if kind == "dc_outage":
                rec = None
                if rng.random() < 0.7:
                    rec = max(1.0, rng.expovariate(
                        1.0 / (mean_recover_frac * horizon_ms)))
                events.append(FailureEvent(
                    at_ms=at, kind=kind, dc=dc, recover_ms=rec,
                    residual_frac=residual_frac,
                ))
            else:  # slice_preemption / dc_join
                events.append(FailureEvent(
                    at_ms=at, kind=kind, dc=dc,
                    gpus=rng.randint(1, max_slice_gpus),
                ))
        return cls(events=tuple(events), seed=seed)

    # -- bandwidth consequences -------------------------------------------

    def degraded_windows(
        self, topo: TopologyMatrix
    ) -> Dict[Tuple[int, int], List[Tuple[float, float, float]]]:
        """Per directed pair, the ``(t0, t1, frac)`` degradation windows
        this trace imposes (``t1`` may be ``inf``)."""
        assert topo.dc_names, "failure traces need a named topology"
        out: Dict[Tuple[int, int], List[Tuple[float, float, float]]] = {}
        for ev in self.events:
            if not ev.degrades_bandwidth():
                continue
            t1 = math.inf if ev.recover_ms is None else ev.recovery_ms
            if ev.kind == "dc_outage":
                idx = topo.index_of(ev.dc)
                pairs = [(a, b) for a, b in topo.wan_pairs() if idx in (a, b)]
            else:
                ia, ib = topo.index_of(ev.pair[0]), topo.index_of(ev.pair[1])
                pairs = [(ia, ib), (ib, ia)]
            for p in pairs:
                out.setdefault(p, []).append((ev.at_ms, t1, ev.residual_frac))
        return out

    def apply_to_topology(self, topo: TopologyMatrix) -> TopologyMatrix:
        """The live WAN with this trace's outages baked in: every
        affected directed pair carries a ``BandwidthSchedule`` whose
        rate drops to ``residual_frac ×`` nominal inside each outage
        window (overlapping windows compound to the worst fraction).
        Pairs the trace never touches keep their original links and
        schedules.  Existing schedules on affected pairs must be
        aperiodic (a periodic diurnal trace has no single composition
        grid); both directions of every touched pair are materialized
        so the reverse-pair fallback cannot alias a degraded direction
        onto a healthy one."""
        windows = self.degraded_windows(topo)
        if not windows:
            return topo
        # materialize both directions of touched pairs (fallback aliasing)
        touched = set(windows)
        for a, b in sorted(touched):
            touched.add((b, a))
        scheds = dict(topo.bw_schedules)
        for a, b in sorted(touched):
            base = topo.bandwidth_schedule(a, b)
            wins = windows.get((a, b), [])
            if base is not None:
                assert base.period_ms is None, (
                    "cannot compose failure windows onto a periodic schedule; "
                    "flatten it first (BandwidthSchedule.from_samples)"
                )
                bounds = set(base.times_ms)
                base_bw = base.bw_at
            else:
                bw0 = topo.link(a, b).bw_gbps
                bounds = {0.0}
                base_bw = lambda _t, _bw=bw0: _bw  # noqa: E731
            for t0, t1, _f in wins:
                bounds.add(t0)
                if math.isfinite(t1):
                    bounds.add(t1)
            times = sorted(bounds)
            rates = []
            for t in times:
                frac = 1.0
                for t0, t1, f in wins:
                    if t0 <= t < t1:
                        frac = min(frac, f)
                rates.append(base_bw(t) * frac)
            # coalesce equal-rate neighbours
            ct, cr = [times[0]], [rates[0]]
            for t, r in zip(times[1:], rates[1:]):
                if r != cr[-1]:
                    ct.append(t)
                    cr.append(r)
            scheds[(a, b)] = wan.BandwidthSchedule(tuple(ct), tuple(cr))
        return topo.with_bandwidth_schedules(scheds)

    # -- fleet consequences ------------------------------------------------

    def dead_dcs_at(self, t_ms: float) -> FrozenSet[str]:
        """DCs inside a ``dc_outage`` window at ``t_ms`` (event-time
        granularity — the runner's own windows open at handled time)."""
        dead = set()
        for ev in self.events:
            if ev.kind != "dc_outage" or ev.at_ms > t_ms:
                continue
            if ev.recover_ms is None or t_ms < ev.recovery_ms:
                dead.add(ev.dc)
        return frozenset(dead)
