"""Schedule-invariant checker — differential testing for the schedulers.

Any schedule the repo produces (a reactive ``SimResult`` from
``repro_torch.core.simulator.simulate`` or a precomputed Atlas ``Schedule`` from
``repro_torch.core.temporal``) must obey the physics of the machine it models:

  * a GPU never executes two tasks at once;
  * every (pipeline, stage) runs exactly M forwards and M backwards, with
    the documented durations (backward = bwd_mult·t_fwd, + recompute);
  * backward-after-forward causality per microbatch, and stage-order
    causality along the pipeline (an activation cannot be consumed before
    it was produced; a gradient cannot flow upstream before the
    downstream backward finished);
  * the in-flight memory cap holds (forwards never run more than ``cap``
    ahead of backwards on a stage);
  * WAN transfers serialize per (boundary, direction) channel and occupy
    it for at least the bytes/bandwidth serialization time (temporal
    sharing: 1/D of it) — priced against the ``wan.BandwidthSchedule``
    in force at the transfer's start when the pair is time-varying;
  * utilization ∈ [0, 1] and the reported bubbles exactly tile the
    complement of busy time within the pipeline span (the trailing DP
    all-reduce is busy communication, never a bubble);
  * the precomputed Atlas schedule and the event-driven simulator agree
    on iteration time.

Violations raise ``InvariantViolation`` (an ``AssertionError``, so these
work directly as pytest helpers).  ``simulate(..., validate=True)`` runs
the checker as an opt-in runtime assertion mode.

The port's own copy of ``repro/core/validate.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional, Tuple

from repro_torch import units
from repro_torch.core import wan

EPS = 1e-6


class InvariantViolation(AssertionError):
    """A schedule broke a physical invariant."""


def _fail(msg: str, *ctx) -> None:
    raise InvariantViolation(msg + (f" :: {ctx}" if ctx else ""))


# ---------------------------------------------------------------------------
# SimResult checks (any policy)
# ---------------------------------------------------------------------------


def _default_cap(spec, policy: Optional[str]) -> Optional[int]:
    if spec.inflight_cap is not None:
        return spec.inflight_cap
    if policy == "gpipe":
        return spec.microbatches
    if policy in ("megatron", "varuna", "atlas"):
        return spec.num_stages
    return None


def check_sim_result(
    res,
    spec,
    *,
    policy: Optional[str] = None,
    inflight_cap: Optional[int] = None,
) -> None:
    """Assert the physical invariants on a ``simulator.SimResult``."""
    P, M = spec.num_stages, spec.microbatches
    t_f = spec.t_fwd_ms
    t_b = spec.bwd_mult * t_f
    total = res.iteration_ms
    cap = inflight_cap if inflight_cap is not None else _default_cap(spec, policy)

    if not (-EPS <= res.utilization <= 1.0 + EPS):
        _fail("utilization outside [0, 1]", res.utilization)
    if total < -EPS:
        _fail("negative iteration time", total)
    if set(res.busy) != {(p, s) for p in range(res.n_pipelines) for s in range(P)}:
        _fail("busy map does not cover pipelines x stages")

    busy_sum = 0.0
    for g, ivs in res.busy.items():
        ivs = sorted(ivs, key=lambda iv: iv.start)
        by_kind: Dict[str, List] = {"fwd": [], "bwd": []}
        prev_end = 0.0
        for iv in ivs:
            if iv.start < -EPS or iv.end > total + EPS:
                _fail("interval outside [0, iteration]", g, iv)
            if iv.end <= iv.start + EPS:
                _fail("empty/negative interval", g, iv)
            if iv.start < prev_end - EPS:
                _fail("GPU executes two tasks at once", g, iv, prev_end)
            prev_end = iv.end
            busy_sum += iv.end - iv.start
            if iv.kind not in by_kind:
                _fail("unknown task kind", g, iv)
            by_kind[iv.kind].append(iv)
            dur = iv.end - iv.start
            if iv.kind == "fwd":
                if abs(dur - t_f) > EPS:
                    _fail("forward duration != t_fwd", g, iv, t_f)
            else:
                if not (abs(dur - t_b) < EPS or abs(dur - (t_b + t_f)) < EPS):
                    _fail("backward duration != t_bwd (+recompute)", g, iv, t_b)
        if len(by_kind["fwd"]) != M or len(by_kind["bwd"]) != M:
            _fail("stage did not run M forwards + M backwards", g,
                  len(by_kind["fwd"]), len(by_kind["bwd"]))
        micros_f = sorted(iv.micro for iv in by_kind["fwd"])
        micros_b = sorted(iv.micro for iv in by_kind["bwd"])
        if micros_f != list(range(M)) or micros_b != list(range(M)):
            _fail("microbatch indices not a permutation of 0..M-1", g)

        # backward-after-forward per microbatch
        f_end = {iv.micro: iv.end for iv in by_kind["fwd"]}
        for iv in by_kind["bwd"]:
            if iv.start < f_end[iv.micro] - EPS:
                _fail("backward before its forward", g, iv)

        # memory cap: completed forwards minus completed backwards at any
        # forward's start must leave room for it (sorted ends + bisect —
        # the naive quadratic scan dominated validation at paper-scale M)
        if cap is not None:
            f_ends = sorted(o.end for o in by_kind["fwd"])
            b_ends = sorted(o.end for o in by_kind["bwd"])
            for iv in by_kind["fwd"]:
                in_flight = bisect_right(f_ends, iv.start + EPS) \
                    - bisect_right(b_ends, iv.start + EPS)
                if in_flight >= cap:
                    _fail("in-flight cap exceeded", g, iv, in_flight, cap)

    # stage-order causality (transfers only delay, never advance)
    for p in range(res.n_pipelines):
        for s in range(P - 1):
            fa = {iv.micro: iv for iv in res.busy[(p, s)] if iv.kind == "fwd"}
            fb = {iv.micro: iv for iv in res.busy[(p, s + 1)] if iv.kind == "fwd"}
            ba = {iv.micro: iv for iv in res.busy[(p, s)] if iv.kind == "bwd"}
            bb = {iv.micro: iv for iv in res.busy[(p, s + 1)] if iv.kind == "bwd"}
            for m in range(M):
                if fb[m].start < fa[m].end - EPS:
                    _fail("activation consumed before produced", p, s, m)
                if ba[m].start < bb[m].end - EPS:
                    _fail("gradient consumed before produced", p, s, m)

    # bubbles tile the complement of busy within the pipeline span
    # [0, pp_end]: the trailing DP all-reduce is busy communication, so
    # no reported bubble may overlap it
    pp_end = total - res.allreduce_ms
    for g, ivs in res.busy.items():
        gaps = []
        cur = 0.0
        for iv in sorted(ivs, key=lambda iv: iv.start):
            if iv.start > cur + 1e-9:
                gaps.append((cur, iv.start))
            cur = max(cur, iv.end)
        if cur < pp_end - 1e-9:
            gaps.append((cur, pp_end))
        rec = res.bubbles.get(g)
        # exact tiling against gaps capped at pp_end also guarantees no
        # recorded bubble overlaps the all-reduce span
        if rec is None or len(rec) != len(gaps) or any(
            abs(a - c) > 1e-6 or abs(b - d) > 1e-6
            for (a, b), (c, d) in zip(gaps, rec)
        ):
            _fail("bubbles do not tile the complement of busy", g)

    n_gpus = len(res.busy)
    if total > 0:
        want_util = busy_sum / (total * n_gpus)
        if abs(want_util - res.utilization) > 1e-6:
            _fail("utilization inconsistent with busy intervals",
                  res.utilization, want_util)


# ---------------------------------------------------------------------------
# Atlas Schedule checks (transfers + channels)
# ---------------------------------------------------------------------------


def check_schedule(
    sched, spec, topo, *, inflight_cap: Optional[int] = None, start_ms: float = 0.0
) -> None:
    """Assert the §4.4 invariants on a precomputed ``temporal.Schedule``.

    ``start_ms`` anchors the schedule at an absolute wall-clock offset
    (matching ``temporal.atlas_schedule(..., start_ms=...)``): transfer
    occupancies are priced against the bandwidth segments in force at
    ``start_ms + tr.start``, so a per-epoch plan inside a re-planning
    horizon is checked against the WAN it actually ran on."""
    P, M = spec.num_stages, spec.microbatches
    D = sched.num_pipelines
    t_f = spec.t_fwd_ms
    t_b = spec.bwd_mult * t_f

    tasks_by_gpu: Dict[Tuple[int, int], List] = {}
    task_index: Dict[Tuple[str, int, int, int], object] = {}
    for t in sched.tasks:
        if not (0 <= t.stage < P and 0 <= t.pipeline < D and 0 <= t.micro < M):
            _fail("task outside spec ranges", t)
        tasks_by_gpu.setdefault((t.pipeline, t.stage), []).append(t)
        task_index[(t.kind, t.pipeline, t.stage, t.micro)] = t

    for g, ts in tasks_by_gpu.items():
        ts.sort(key=lambda t: t.start)
        prev = 0.0
        for t in ts:
            if t.start < prev - EPS:
                _fail("GPU executes two tasks at once (schedule)", g, t)
            prev = t.end
            dur = t.end - t.start
            want = t_f if t.kind == "fwd" else (
                t_b + (t_f if (spec.recompute and t.stage != P - 1) else 0.0)
            )
            if abs(dur - want) > EPS:
                _fail("task duration mismatch", g, t, want)
        nf = sum(1 for t in ts if t.kind == "fwd")
        nb = sum(1 for t in ts if t.kind == "bwd")
        if nf != M or nb != M:
            _fail("stage did not run M forwards + M backwards (schedule)", g, nf, nb)

    cap = inflight_cap if inflight_cap is not None else (
        spec.inflight_cap if spec.inflight_cap is not None else P
    )
    for g, ts in tasks_by_gpu.items():
        f_starts = sorted(t.start for t in ts if t.kind == "fwd")
        b_ends = sorted(t.end for t in ts if t.kind == "bwd")
        for t in ts:
            if t.kind != "fwd":
                continue
            in_flight = bisect_right(f_starts, t.start + EPS) \
                - bisect_right(b_ends, t.start + EPS)
            if in_flight > cap:
                _fail("in-flight cap exceeded (schedule)", g, t, in_flight, cap)

    # transfers: channel serialization, bandwidth, and dependency edges
    get_sched = getattr(topo, "bandwidth_schedule", None)
    chan: Dict[Tuple[int, str], List] = {}
    for tr in sched.transfers:
        b = tr.boundary
        dc_a, dc_b = spec.stage_dc[b], spec.stage_dc[b + 1]
        # activations ride b -> b+1, gradients the reverse link (matters
        # on asymmetric topologies)
        src, dst = (dc_a, dc_b) if tr.direction == "act" else (dc_b, dc_a)
        link = topo.link(src, dst)
        is_wan_b = dc_a != dc_b
        # minimum physical occupancy, priced against the bandwidth
        # schedule in force over [tr.start, tr.end) when the pair is
        # time-varying (temporal sharing: the cell transfers at D×)
        bw_sched = get_sched(src, dst) if get_sched is not None else None
        if bw_sched is not None:
            ser = bw_sched.transfer_ms(
                spec.act_bytes, start_ms + tr.start, rate_mult=D if is_wan_b else 1
            )
        else:
            ser_one = units.serialization_ms(spec.act_bytes, link.bw_gbps)
            ser = ser_one / D if is_wan_b else ser_one
        occupancy = tr.end - tr.start
        if occupancy < ser - EPS:
            _fail("transfer faster than link bandwidth allows", tr, ser)
        if tr.arrive < tr.end + link.latency_ms - EPS:
            _fail("transfer arrives before propagation latency", tr, link)
        src_kind, src_stage = ("fwd", b) if tr.direction == "act" else ("bwd", b + 1)
        dst_kind, dst_stage = ("fwd", b + 1) if tr.direction == "act" else ("bwd", b)
        src = task_index.get((src_kind, tr.pipeline, src_stage, tr.micro))
        dst = task_index.get((dst_kind, tr.pipeline, dst_stage, tr.micro))
        if src is None or dst is None:
            _fail("transfer without producer/consumer task", tr)
        if tr.start < src.end - EPS:
            _fail("transfer starts before its producer finished", tr, src)
        if dst.start < tr.arrive - EPS:
            _fail("consumer starts before transfer arrived", tr, dst)
        if is_wan_b:
            chan.setdefault((b, tr.direction), []).append(tr)

    for key, trs in chan.items():
        trs.sort(key=lambda tr: tr.start)
        prev = trs[0]
        for tr in trs[1:]:
            if tr.start < prev.end - EPS:
                _fail("two transfers share a WAN channel at once", key, prev, tr)
            prev = tr

    last = max([t.end for t in sched.tasks] + [tr.arrive for tr in sched.transfers])
    if abs(last - sched.makespan) > EPS:
        _fail("makespan inconsistent with tasks/transfers", last, sched.makespan)


# ---------------------------------------------------------------------------
# differential: precomputed Atlas schedule vs event-driven simulation
# ---------------------------------------------------------------------------


def check_atlas_consistency(
    spec, topo, n_pipelines: int = 1, dp_replicas: int = 1, start_ms: float = 0.0
) -> None:
    """The precomputed §4.4 schedule and the event-driven simulator must
    report the same iteration time (the simulator's atlas policy wraps the
    schedule; this guards the wrapper AND re-validates both artifacts)."""
    from repro_torch.core import simulator, temporal

    sched = temporal.atlas_schedule(
        spec, topo, n_pipelines, inflight_cap=spec.inflight_cap, start_ms=start_ms
    )
    check_schedule(sched, spec, topo, start_ms=start_ms)
    res = simulator.simulate(
        spec, topo, policy="atlas", n_pipelines=n_pipelines,
        dp_replicas_for_allreduce=dp_replicas, start_ms=start_ms,
    )
    check_sim_result(res, spec, policy="atlas")
    ar = wan.allreduce_ms(
        spec.stage_param_bytes, dp_replicas, topo.intra_bw_gbps
    )
    if abs((sched.makespan + ar) - res.iteration_ms) > EPS:
        _fail("precomputed schedule and simulator disagree on iteration time",
              sched.makespan + ar, res.iteration_ms)


def check_horizon(hr, live_topo, *, check_epoch_schedules: bool = True) -> None:
    """Assert the control-plane invariants on a ``control.HorizonResult``.

      * epochs and migration windows tile ``[0, total_ms]`` exactly —
        training never overlaps a migration (the stall occupies the
        GPUs), and every migration sits between the epoch it closed and
        the epoch it opened;
      * each per-epoch plan passes ``check_schedule`` *independently*,
        anchored at its own wall-clock offset (transfers priced against
        the live bandwidth segments in force during that epoch);
      * migration transfers serialize per directed WAN pair, stay inside
        their stall window, and occupy the channel for at least the
        physical (schedule-integrated) serialization of the moved bytes;
      * failure/elasticity (``hr.outages`` non-empty): no epoch with GPU
        busy time places a stage in a dead DC inside its outage window,
        and sample accounting is consistent with checkpoint recency —
        a ship-mode migration carries zero replay debt and preserves
        sample continuity exactly; a restore-mode one resumes at its
        checkpoint's sample count with ``replay_samples`` equal to the
        progress it forfeited.
    """
    import math

    migs = list(hr.migrations)
    if len(hr.epochs) != len(migs) + 1:
        _fail("epoch/migration counts inconsistent", len(hr.epochs), len(migs))
    prev_end = 0.0
    for i, ep in enumerate(hr.epochs):
        if abs(ep.start_ms - prev_end) > EPS:
            _fail("epoch does not start where the previous span ended",
                  i, ep.start_ms, prev_end)
        if math.isnan(ep.end_ms) or ep.end_ms < ep.start_ms - EPS:
            _fail("epoch end missing or before its start", i, ep.end_ms)
        if i < len(migs):
            m = migs[i]
            if abs(m.at_ms - ep.end_ms) > EPS:
                _fail("migration does not begin when its epoch ends",
                      i, m.at_ms, ep.end_ms)
            prev_end = m.at_ms + m.duration_ms
        else:
            prev_end = ep.end_ms
    if abs(prev_end - hr.total_ms) > EPS:
        _fail("epoch/migration spans do not tile the horizon",
              prev_end, hr.total_ms)

    if check_epoch_schedules and hr.policy == "atlas":
        from repro_torch.core import temporal

        for ep in hr.epochs:
            sched = temporal.atlas_schedule(
                ep.spec, live_topo, ep.n_pipelines,
                inflight_cap=ep.spec.inflight_cap, start_ms=ep.start_ms,
            )
            check_schedule(sched, ep.spec, live_topo, start_ms=ep.start_ms)

    get_sched = getattr(live_topo, "bandwidth_schedule", None)
    for m in migs:
        window_end = m.at_ms + m.duration_ms
        by_pair: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
        for src, dst, s, e in m.transfers:
            if s < m.at_ms - EPS or e > window_end + EPS:
                _fail("migration transfer outside its stall window", m.at_ms, (s, e))
            link = live_topo.link(src, dst)
            bw_sched = get_sched(src, dst) if get_sched is not None else None
            if bw_sched is not None:
                ser = bw_sched.transfer_ms(m.bytes_per_stage, s)
            else:
                ser = units.serialization_ms(m.bytes_per_stage, link.bw_gbps)
            if (e - s) < ser - EPS:
                _fail("migration transfer faster than the live link allows",
                      (src, dst), (s, e), ser)
            by_pair.setdefault((src, dst), []).append((s, e))
        for pair, ws in by_pair.items():
            ws.sort()
            for (s0, e0), (s1, e1) in zip(ws, ws[1:]):
                if s1 < e0 - EPS:
                    _fail("two migration transfers share a WAN channel at once",
                          pair, (s0, e0), (s1, e1))

    # --- failure & elasticity invariants (inert without outages) ---------
    for w in getattr(hr, "outages", None) or []:
        if w.kind != "dc_outage":
            continue
        idx = live_topo.index_of(w.dc)
        t1 = min(w.t1_ms, hr.total_ms)
        for ep in hr.epochs:
            if ep.iterations <= 0:
                continue
            end = ep.end_ms if not math.isnan(ep.end_ms) else hr.total_ms
            if end <= w.t0_ms + EPS or ep.start_ms >= t1 - EPS:
                continue
            if idx in ep.spec.stage_dc:
                _fail("GPU busy time inside a dead DC's outage window",
                      w.dc, (w.t0_ms, t1), ep.index, ep.spec.stage_dc)

    for i, m in enumerate(migs):
        if m.replay_samples < -EPS:
            _fail("negative replay debt", i, m.replay_samples)
        ep, nxt = hr.epochs[i], hr.epochs[i + 1]
        progress = ep.start_sample + ep.iterations * ep.samples_per_iteration
        if getattr(m, "mode", "ship") == "restore":
            if math.isnan(m.ckpt_samples):
                _fail("restore-mode migration missing its checkpoint stamp", i)
            if abs(nxt.start_sample - m.ckpt_samples) > 1e-6:
                _fail("restored epoch does not resume at its checkpoint's "
                      "sample count", i, nxt.start_sample, m.ckpt_samples)
            if abs(m.replay_samples - (progress - m.ckpt_samples)) > 1e-6:
                _fail("replay debt inconsistent with checkpoint recency",
                      i, m.replay_samples, progress, m.ckpt_samples)
        else:
            if m.replay_samples != 0.0:
                _fail("ship-mode migration claims replay debt", i,
                      m.replay_samples)
            if abs(nxt.start_sample - progress) > 1e-6:
                _fail("sample accounting broken across a migration",
                      i, nxt.start_sample, progress)


def check_fleet(fr, live_topo, *, check_jobs: bool = True) -> None:
    """Assert the multi-job fleet invariants on a ``fleet.FleetResult``.

      * per job: epochs and migration windows tile its horizon exactly
        (``check_horizon`` without per-epoch schedule re-derivation —
        fleet epochs ran on *contended* topology views that change with
        the allocation generation, so re-pricing them against the live
        matrix would be checking different physics);
      * the fleet capacity invariant: on every directed channel, the
        aggregate rate the allocator reserved never exceeds the
        schedule's capacity at any instant.  Reservations are
        piecewise-constant, so the check walks the elementary intervals
        of their union and compares the rate sum against the channel's
        *lowest* rate in force anywhere in the interval
        (``wan.BandwidthSchedule.min_bw_over``) — a pointwise bound,
        not an integral one;
      * per (job, channel): reservation windows never overlap.  Training
        windows are recorded sequentially per job (coalesced when
        contiguous) and KV-handoff transfers (the ``~prefill`` pseudo-
        job of ``fleet.KVFlows``) serialize behind a per-channel cursor,
        so an overlap means double-booking — e.g. a KV transfer priced
        before its predecessor's segments were committed.
    """
    if check_jobs:
        for hr in fr.jobs.values():
            check_horizon(hr, live_topo, check_epoch_schedules=False)

    # failure invariant: none of a job's channel reservations may touch a
    # dead DC (or ride a failed pair) inside that job's outage windows —
    # the straddling iteration ends exactly where the window opens, and
    # every post-failover placement must have routed off the dead
    # resources.  Windows are per-job (handled-time granularity), so one
    # job's outage never indicts another job's healthy reservation; the
    # KV pseudo-job carries no outage record and is exempt.
    for jname, hr in sorted(fr.jobs.items()):
        for w in getattr(hr, "outages", None) or []:
            t1 = min(w.t1_ms, hr.total_ms)
            if w.kind == "dc_outage":
                idx = live_topo.index_of(w.dc)
                affected = lambda p: idx in p  # noqa: E731
            else:  # link_failure
                dead = {live_topo.index_of(w.pair[0]),
                        live_topo.index_of(w.pair[1])}
                affected = lambda p: set(p) == dead  # noqa: E731
            for r in fr.reservations:
                if r.job != jname or r.rate_gbps <= EPS:
                    continue
                if not affected(tuple(r.pair)):
                    continue
                if r.t0_ms < t1 - EPS and r.t1_ms > w.t0_ms + EPS:
                    _fail("channel reservation touches dead resources "
                          "during an outage window", jname, w.kind,
                          w.dc or w.pair, (w.t0_ms, t1), r)

    by_pair: Dict[Tuple[int, int], List] = {}
    by_job_pair: Dict[Tuple[str, Tuple[int, int]], List] = {}
    for r in fr.reservations:
        if r.t1_ms < r.t0_ms - EPS:
            _fail("reservation window inverted", r)
        if r.rate_gbps < -EPS:
            _fail("negative reservation rate", r)
        by_pair.setdefault(tuple(r.pair), []).append(r)
        by_job_pair.setdefault((r.job, tuple(r.pair)), []).append(r)

    for (job, pair), rs in sorted(by_job_pair.items()):
        ws = sorted((r.t0_ms, r.t1_ms) for r in rs)
        for (s0, e0), (s1, e1) in zip(ws, ws[1:]):
            if s1 < e0 - EPS:
                _fail(
                    "one job's reservations overlap on a channel",
                    job, pair, (s0, e0), (s1, e1),
                )

    get_sched = getattr(live_topo, "bandwidth_schedule", None)
    for pair, rs in sorted(by_pair.items()):
        link = live_topo.link(*pair)
        sched = get_sched(*pair) if get_sched is not None else None
        # sweep over the sorted window endpoints (+rate at t0, −rate at
        # t1): one O(R log R) pass maintains the pointwise rate sum —
        # re-scanning all reservations per elementary interval would be
        # O(R²) on a hot channel
        events = sorted(
            [(r.t0_ms, r.rate_gbps) for r in rs]
            + [(r.t1_ms, -r.rate_gbps) for r in rs]
        )
        total = 0.0
        for i, (x0, delta) in enumerate(events):
            total += delta
            x1 = events[i + 1][0] if i + 1 < len(events) else x0
            if x1 - x0 <= EPS or total <= EPS:
                continue
            cap = (
                sched.min_bw_over(x0, x1) if sched is not None else link.bw_gbps
            )
            if total > cap * (1.0 + 1e-9) + EPS:
                _fail(
                    "aggregate channel reservations exceed capacity",
                    pair, (x0, x1), total, cap,
                )


def check_policy(spec, topo, policy: str, n_pipelines: int = 1):
    """Simulate one policy with validation on; returns the SimResult."""
    from repro_torch.core import simulator

    res = simulator.simulate(spec, topo, policy=policy, n_pipelines=n_pipelines)
    check_sim_result(res, spec, policy=policy)
    return res


# ---------------------------------------------------------------------------
# differential: two SimResults must be interval-identical
# ---------------------------------------------------------------------------


def check_equivalent(res_a, res_b, *, eps: float = EPS) -> None:
    """Assert two ``SimResult``s describe the *same* schedule: identical
    interval sets per GPU (start, end, kind, micro), iteration time,
    utilization and bubbles.  The engine-equivalence net: optimized
    engine vs ``repro_torch.core.reference``, and steady-state fast-forward vs
    full event replay."""
    if res_a.n_pipelines != res_b.n_pipelines:
        _fail("pipeline counts differ", res_a.n_pipelines, res_b.n_pipelines)
    if set(res_a.busy) != set(res_b.busy):
        _fail("busy maps cover different GPUs")
    if abs(res_a.iteration_ms - res_b.iteration_ms) > eps:
        _fail("iteration times differ", res_a.iteration_ms, res_b.iteration_ms)
    if abs(res_a.allreduce_ms - res_b.allreduce_ms) > eps:
        _fail("all-reduce times differ", res_a.allreduce_ms, res_b.allreduce_ms)
    if abs(res_a.utilization - res_b.utilization) > 1e-9:
        _fail("utilizations differ", res_a.utilization, res_b.utilization)
    key = lambda iv: (iv.start, iv.kind, iv.micro)  # noqa: E731
    for g in res_a.busy:
        ivs_a = sorted(res_a.busy[g], key=key)
        ivs_b = sorted(res_b.busy[g], key=key)
        if len(ivs_a) != len(ivs_b):
            _fail("interval counts differ", g, len(ivs_a), len(ivs_b))
        for a, b in zip(ivs_a, ivs_b):
            if (
                abs(a.start - b.start) > eps
                or abs(a.end - b.end) > eps
                or a.kind != b.kind
                or a.micro != b.micro
            ):
                _fail("intervals differ", g, a, b)
        gaps_a, gaps_b = res_a.bubbles[g], res_b.bubbles[g]
        if len(gaps_a) != len(gaps_b) or any(
            abs(x0 - y0) > eps or abs(x1 - y1) > eps
            for (x0, x1), (y0, y1) in zip(gaps_a, gaps_b)
        ):
            _fail("bubbles differ", g)


def check_trace(tracer) -> int:
    """Second-witness trace check as an engine invariant: re-derive
    utilization / bubble / allreduce / wan_bits totals from the spans a
    :class:`repro_torch.obs.RecordingTracer` collected and compare against the
    expectations the engines registered at emission time.  Wraps
    ``obs.crosscheck`` so trace mismatches surface as the same
    ``InvariantViolation`` family every other checker raises.  Returns
    the number of iteration windows verified."""
    from repro_torch import obs

    try:
        return obs.verify_trace(tracer)
    except obs.TraceMismatch as e:
        _fail(f"trace crosscheck failed: {e}")


def check_fast_forward(spec, topo, policy: str, n_pipelines: int = 1):
    """Cross-check the steady-state fast-forward against full event
    replay: both paths must produce interval-identical results (and both
    must pass the physical invariants).  Returns (fast result, whether
    the fast-forward actually engaged)."""
    from repro_torch.core import simulator

    full = simulator.simulate(
        spec, topo, policy=policy, n_pipelines=n_pipelines, fast_forward=False
    )
    fast = simulator.simulate(
        spec, topo, policy=policy, n_pipelines=n_pipelines, fast_forward=True
    )
    check_sim_result(full, spec, policy=policy)
    check_sim_result(fast, spec, policy=policy)
    check_equivalent(full, fast)
    return fast, bool(fast.stats and fast.stats.get("fast_forward"))
