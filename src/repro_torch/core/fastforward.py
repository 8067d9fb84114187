"""Steady-state fast-forward — analytic skip of the periodic middle.

After pipeline fill, every schedule this repo produces (1F1B variants,
GPipe's two phases, the precomputed Atlas schedule) settles into a
*periodic* steady state: per (pipeline, stage, kind) stream the interval
of microbatch m+k is the interval of microbatch m shifted by a constant
Λ, for some small period k (k = 1 for GPipe's phases; k = the in-flight
cap for 1F1B-family schedules, whose forwards run in cap-sized bursts).
A full event replay spends O(M·P·D) events re-deriving a pattern that is
fixed after O(P·D) of them.  This module detects the pattern from short
*probe* replays of the real engine and emits the middle microbatches
analytically — the result is interval-identical to full replay
(differentially tested in ``tests/test_engine_equiv.py``), so
M=4096-microbatch GPT-3-scale specs simulate in milliseconds.

Model.  Write ``start(m | M)`` for the start of microbatch m's interval
in an M-microbatch iteration of one stream.  With a global period K (the
lcm of the per-stream periods) and probes at M1 ≡ M (mod K) and
M2 = M1 + K, the schedule fast-forwards iff every stream decomposes as::

    start(m | M) = A[m]                                  m < a     (head:
                                                         fill, M-invariant)
                 = A[a+r] + j·Λ + n·γ   r=(m-a)%K,       a ≤ m < M-t (mid:
                                        j=(m-a)//K       periodic)
                 = A[m-(M-M1)] + n·σ                     m ≥ M-t   (tail:
                                                         drain, end-anchored)

where n = (M - M1)/K extra periods, σ = makespan(M2) - makespan(M1) is
the global per-period makespan growth, Λ the stream's per-period
advance, and γ the per-extra-period shift of the whole mid block (0 for
1F1B — the mid is M-invariant; the forward-phase slot for GPipe
backwards — the barrier moves with M).  Consistency requires σ = Λ + γ
wherever a stream has both a mid and a tail.  Everything — k, a, t, Λ,
γ — is *measured* from the probes, never assumed from policy semantics,
and every constraint (head equality across probes, the periodic mid in
both probes, the σ-shifted tail) is checked explicitly.  Any mismatch —
an aperiodic schedule, a period too long for the probes, M too small to
amortize them — returns ``None`` and the caller falls back to full
event replay.

Time-varying bandwidth (``TopologyMatrix.bw_schedules``) invalidates
the whole model: a segment boundary anywhere in the iteration breaks
the constant-Λ steady state, and the short probes cannot observe
changes beyond their own horizon — ``fast_forward_gate`` therefore
refuses to probe at all when any WAN boundary carries a non-flat
schedule (recorded by the caller in ``stats["fast_forward_gate"]``);
flat schedules are interval-identical to the static engine and pass.

Probing at M ≡ M1 (mod K) matters: the drain's shape depends on where
the last microbatch lands in the period, so probes are phase-aligned
with the target before the tail is compared.  Durations are taken
verbatim from probe intervals (per-stream constants), so generated
intervals carry exactly the event engine's task durations; only starts
are extrapolated, anchored at measured probe values so float error
stays far below the invariant checker's 1e-6 EPS.

The port's own copy of ``repro/core/fastforward.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.simulator import Interval, PipelineSpec

MIN_MID = 6  # minimum mid-window length (starts) per stream
MIN_HEADROOM = 8  # auto mode: M must exceed the probes by at least this
K_MAX = 32  # give up on periods longer than this

GATE_TIME_VARYING = "time-varying-bandwidth"
GATE_REPLAN_EPOCH = "replan-epoch-boundary"


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-7 + 1e-9 * max(abs(a), abs(b))


def fast_forward_gate(
    spec: PipelineSpec, topo, *, epoch_boundary: bool = False
) -> Optional[str]:
    """A reason the fast-forward must not even be *attempted* for this
    (spec, topo), or ``None`` when probing is sound.

    Time-varying bandwidth is a hard gate rather than a detection
    failure: the probes are short-M replays whose events all land early
    in the timeline, so a bandwidth change beyond the probe horizon
    (e.g. an outage at hour 3 of a 6-hour iteration) would be invisible
    to them — the probes would "detect" a period and extrapolate
    through the change, silently diverging from full replay.  Flat
    schedules (and schedule-free topologies) keep the static engine's
    periodicity and pass.  The caller records the gate in
    ``stats["fast_forward_gate"]``.

    ``epoch_boundary`` gates the first iteration after a control-plane
    re-plan (``repro_torch.core.control``): the placement, D, and channel
    state just changed under the job, so no steady state measured before
    the migration may be extrapolated across it — the horizon simulator
    full-replays that iteration and records ``GATE_REPLAN_EPOCH``."""
    from repro_torch.core.simulator import has_time_varying_wan

    if epoch_boundary:
        return GATE_REPLAN_EPOCH
    if has_time_varying_wan(spec, topo):
        return GATE_TIME_VARYING
    return None


def probe_sizes(spec: PipelineSpec, n_pipelines: int) -> Tuple[int, int]:
    """(first-probe microbatches, worst-case second-probe microbatches).

    The probe must contain the fill (≈P slots + the Atlas DP stagger),
    the drain, an explicit in-flight cap's transient, and at least two
    full periods of the steady state (period ≤ max(cap, P))."""
    P = spec.num_stages
    cap = spec.inflight_cap if spec.inflight_cap is not None else P
    base = max(5 * P + 2 * n_pipelines, 3 * cap)
    m1 = base + 24
    return m1, m1 + 2 * K_MAX  # second probe is m1 + K for the detected K


def try_fast_forward(
    spec: PipelineSpec,
    run: Callable[[PipelineSpec], Tuple[Dict, float, Dict]],
    *,
    n_pipelines: int,
    force: bool = False,
) -> Optional[Tuple[Dict, float, Dict]]:
    """Attempt the fast-forward; ``None`` means: do a full replay.

    ``run(spec)`` is the raw engine — returns (busy, pipeline end, stats)
    for any microbatch count.  ``force`` attempts whenever the probes fit
    below M (used by tests); the default additionally requires enough
    headroom for the probes to be a clear win.
    """
    M = spec.microbatches
    m1a, m2_worst = probe_sizes(spec, n_pipelines)
    needed = m1a + 1 if force else m2_worst + MIN_HEADROOM
    if M < needed:
        return None

    # some schedules settle only after a long transient (e.g. 1F1B at
    # P=8 becomes period-16 around microbatch ~50): when the first probe
    # sees no period, retry once with a doubled window before giving up
    attempt = 0
    for m1a in (m1a, 2 * m1a + 32):
        attempt += 1
        needed = m1a + 1 if force else m1a + 2 * K_MAX + MIN_HEADROOM
        if M < needed:
            return None
        busy1, pp1, st1 = run(dataclasses.replace(spec, microbatches=m1a))
        streams1 = _streams(busy1, m1a)
        if streams1 is None:
            return None

        # global period K = lcm of the per-stream periods found in probe 1
        K: Optional[int] = 1
        for starts, _dur in streams1.values():
            k = _detect_period(starts)
            if k is None or K * k // math.gcd(K, k) > K_MAX:
                K = None
                break
            K = K * k // math.gcd(K, k)
        if K is not None:
            break
    if K is None:
        return None

    # phase-align: the drain's shape depends on M mod K, so compare
    # probes whose microbatch counts are congruent to the target's
    m1 = m1a + (M - m1a) % K
    m2 = m1 + K
    if M <= m2:
        return None
    if m1 != m1a:
        busy1, pp1, st1 = run(dataclasses.replace(spec, microbatches=m1))
        streams1 = _streams(busy1, m1)
        if streams1 is None:
            return None
    busy2, pp2, st2 = run(dataclasses.replace(spec, microbatches=m2))
    streams2 = _streams(busy2, m2)
    if streams2 is None or streams1.keys() != streams2.keys():
        return None
    sigma = pp2 - pp1  # makespan growth per extra period (K microbatches)

    fits: Dict[Tuple[int, int, str], Tuple[int, int, float, float]] = {}
    for skey, (starts1, dur1) in streams1.items():
        starts2, dur2 = streams2[skey]
        if not _close(dur1, dur2):
            return None
        fit = _fit_stream(starts1, starts2, K, sigma)
        if fit is None:
            return None
        fits[skey] = fit

    # generate the full-M result stream by stream, then merge per GPU
    n_extra = (M - m1) // K  # whole periods inserted into the mid
    busy: Dict[Tuple[int, int], List[List[Interval]]] = {g: [] for g in busy1}
    max_end = 0.0
    for (p, s, kind), (a, t, lam, gam) in fits.items():
        starts1, dur = streams1[(p, s, kind)]
        tail_shift = n_extra * sigma
        mid_shift = n_extra * gam
        out = []
        for m in range(M):
            if m < a:
                start = starts1[m]
            elif m < M - t:
                q, r = divmod(m - a, K)
                start = starts1[a + r] + q * lam + mid_shift
            else:
                start = starts1[m - (M - m1)] + tail_shift
            out.append(Interval(start, start + dur, kind, m))
        if out and out[-1].end > max_end:
            max_end = out[-1].end
        busy[(p, s)].append(out)

    merged = {g: _merge_streams(pair) for g, pair in busy.items()}

    # pipeline end: baselines define it as the last interval end; Atlas
    # adds trailing transfer arrivals — extrapolate those linearly.
    maxend1 = max(iv.end for ivs in busy1.values() for iv in ivs)
    if _close(pp1, maxend1):
        pp_full = max_end
    else:
        pp_full = pp1 + n_extra * sigma
        if max_end > pp_full + 1e-7:
            return None  # generated compute outruns the extrapolated makespan

    stats = {
        "engine": st1.get("engine", "?"),
        "events": st1.get("events", 0) + st2.get("events", 0),
        "fast_forward": True,
        "period": K,
        "probe_attempts": attempt,
        "probe_microbatches": (m1, m2),
        "extrapolated_microbatches": n_extra * K,
    }
    return merged, pp_full, stats


# ---------------------------------------------------------------------------


def _streams(
    busy: Dict, M: int
) -> Optional[Dict[Tuple[int, int, str], Tuple[List[float], float]]]:
    """busy -> {(p, s, kind): (starts indexed by micro, duration)}.

    Requires each stream to hold exactly microbatches 0..M-1 once, with
    starts nondecreasing in m and a constant duration — anything else is
    not a schedule we know how to extrapolate."""
    out: Dict[Tuple[int, int, str], Tuple[List[float], float]] = {}
    for (p, s), ivs in busy.items():
        per_kind: Dict[str, List[Optional[Interval]]] = {}
        for iv in ivs:
            slots = per_kind.setdefault(iv.kind, [None] * M)
            if not (0 <= iv.micro < M) or slots[iv.micro] is not None:
                return None
            slots[iv.micro] = iv
        for kind, slots in per_kind.items():
            if any(iv is None for iv in slots):
                return None
            dur = slots[0].end - slots[0].start
            starts = []
            prev = -math.inf
            for iv in slots:
                if iv.start < prev or not _close(iv.end - iv.start, dur):
                    return None
                prev = iv.start
                starts.append(iv.start)
            out[(p, s, kind)] = (starts, dur)
    return out


def _window_for_period(s: List[float], k: int) -> Optional[Tuple[int, int]]:
    """Longest contiguous window [a, b) of starts with constant k-lag
    differences (later windows win ties — the steady state sits after the
    fill).  None unless the window holds ≥ max(2k+2, MIN_MID) starts and
    leaves at most a third of the stream as drain."""
    m1 = len(s)
    n_e = m1 - k  # k-lag difference count
    if n_e < 2:
        return None
    best = (0, 0)
    lo = 0
    for i in range(1, n_e):
        if not _close(s[i + k] - s[i], s[lo + k] - s[lo]):
            if i - lo >= best[1] - best[0]:
                best = (lo, i)
            lo = i
    if n_e - lo >= best[1] - best[0]:
        best = (lo, n_e)
    a, b = best[0], best[1] + k  # starts s[a..b) follow the period
    if b - a < max(2 * k + 2, MIN_MID):
        return None
    if m1 - b > m1 // 3:
        return None  # "steady state" nowhere near the end: not a mid
    return a, b


def _detect_period(s: List[float]) -> Optional[int]:
    """Smallest period k whose k-lag differences are constant over a
    window long enough to extrapolate from."""
    for k in range(1, K_MAX + 1):
        if len(s) - k < MIN_MID:
            return None
        if _window_for_period(s, k) is not None:
            return k
    return None


def _fit_stream(
    s1: List[float], s2: List[float], K: int, sigma: float
) -> Optional[Tuple[int, int, float, float]]:
    """Fit (a, t, Λ, γ) for one stream at global period K; None = no fit."""
    m1, m2 = len(s1), len(s2)
    win = _window_for_period(s1, K)
    if win is None:
        return None
    a, b = win
    t = m1 - b
    # per-period advance Λ from the window endpoints of residue class 0
    n_per = (b - 1 - a) // K
    if n_per < 1:
        return None
    lam = (s1[a + n_per * K] - s1[a]) / n_per
    gamma = s2[a] - s1[a]  # mid-block shift per extra period (Δ = K)

    # (A) probe-1 mid is exactly the periodic pattern anchored at [a, a+K)
    for m in range(a, b):
        q, r = divmod(m - a, K)
        if not _close(s1[m], s1[a + r] + q * lam):
            return None
    # (B) probe-2 mid: same pattern, whole block shifted by γ, and it
    # extends by exactly one period
    for m in range(a, m2 - t):
        q, r = divmod(m - a, K)
        if not _close(s2[m], s1[a + r] + q * lam + gamma):
            return None
    # (C) head is M-invariant
    for m in range(a):
        if not _close(s2[m], s1[m]):
            return None
    # (D) tail is anchored to the end, shifted by the global σ
    for j in range(t):
        if not _close(s2[m2 - 1 - j], s1[m1 - 1 - j] + sigma):
            return None
    # (E) mid growth and tail shift must agree: one extra period pushes
    # the drain by exactly one mid period
    if t > 0 and not _close(sigma, lam + gamma):
        return None
    return a, t, lam, gamma


def _merge_streams(streams: List[List[Interval]]) -> List[Interval]:
    """Merge per-kind interval lists (each start-sorted) into one
    start-sorted list — any number of kinds per GPU."""
    if len(streams) == 1:
        return streams[0]
    import heapq

    return list(heapq.merge(*streams, key=lambda iv: iv.start))
