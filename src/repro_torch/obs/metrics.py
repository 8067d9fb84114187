"""Run-metrics registry: counters, gauges, histograms and a diffable
snapshot.

A :class:`MetricsRegistry` is a plain accumulator; the interesting
entry point is :func:`metrics_from_tracer`, which distills the standard
run metrics out of a recorded trace — iteration times, bubble
fractions, channel traffic, TTFT, migration and replay cost — so the
``python -m repro_torch.obs report`` CLI (and tests) can summarize any run
the same way regardless of which engine produced it.

Snapshots are frozen and deterministic (sorted keys, sorted histogram
samples), so two snapshots of the same run compare equal and
``MetricsSnapshot.diff`` gives a stable, reviewable delta between two
runs.

The port's own copy of ``repro/obs/metrics.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from repro_torch.obs.tracer import BUSY_KINDS, CAT_GPU, CAT_PREFILL


def _pctl(sorted_vals: Tuple[float, ...], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return math.nan
    idx = max(0, min(len(sorted_vals) - 1, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[idx]


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """Frozen view of a registry; fields are sorted ``(name, ...)``."""

    counters: Tuple[Tuple[str, float], ...]
    gauges: Tuple[Tuple[str, float], ...]
    histograms: Tuple[Tuple[str, Tuple[float, ...]], ...]

    def as_dict(self) -> Dict:
        out: Dict = {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {},
        }
        for name, vals in self.histograms:
            out["histograms"][name] = {
                "count": len(vals),
                "min": vals[0] if vals else math.nan,
                "max": vals[-1] if vals else math.nan,
                "mean": sum(vals) / len(vals) if vals else math.nan,
                "p50": _pctl(vals, 0.50),
                "p95": _pctl(vals, 0.95),
                "p99": _pctl(vals, 0.99),
            }
        return out

    def diff(self, other: "MetricsSnapshot") -> Dict:
        """What changed from ``other`` to ``self``: counter deltas,
        gauge (old, new) pairs, histogram count deltas.  Unchanged
        entries are omitted, so ``snap.diff(snap) == {}``."""
        mine_c, theirs_c = dict(self.counters), dict(other.counters)
        mine_g, theirs_g = dict(self.gauges), dict(other.gauges)
        mine_h = {k: v for k, v in self.histograms}
        theirs_h = {k: v for k, v in other.histograms}
        out: Dict = {}
        for name in sorted(set(mine_c) | set(theirs_c)):
            delta = mine_c.get(name, 0.0) - theirs_c.get(name, 0.0)
            if delta != 0.0:
                out.setdefault("counters", {})[name] = delta
        for name in sorted(set(mine_g) | set(theirs_g)):
            old = theirs_g.get(name, math.nan)
            new = mine_g.get(name, math.nan)
            same = (old == new) or (math.isnan(old) and math.isnan(new))
            if not same:
                out.setdefault("gauges", {})[name] = (old, new)
        for name in sorted(set(mine_h) | set(theirs_h)):
            delta = len(mine_h.get(name, ())) - len(theirs_h.get(name, ()))
            if delta != 0:
                out.setdefault("histograms", {})[name] = delta
        return out


class MetricsRegistry:
    """Counters accumulate, gauges hold the latest value, histograms
    collect samples.  ``snapshot()`` freezes the current state."""

    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}

    def count(self, name: str, inc: float = 1.0) -> None:
        self._counters[name] = self._counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        self._hists.setdefault(name, []).append(value)

    def snapshot(self) -> MetricsSnapshot:
        return MetricsSnapshot(
            counters=tuple(sorted(self._counters.items())),
            gauges=tuple(sorted(self._gauges.items())),
            histograms=tuple(
                (name, tuple(sorted(vals)))
                for name, vals in sorted(self._hists.items())
            ),
        )


def metrics_from_tracer(tracer) -> MetricsRegistry:
    """Standard run metrics derived from a recorded trace.

    Per GPU lane group (``<label>/gpu``): busy / bubble / allreduce /
    migration-stall milliseconds and a ``bubble_frac`` gauge.  Per
    channel lane group: transfer counts and bits.  Prefill spans feed a
    ``ttft_ms`` histogram; per-iteration counter samples feed
    ``iteration_ms`` / ``utilization`` histograms; migration spans feed
    ``migration_ms`` and ``replay_samples`` counters.
    """
    reg = MetricsRegistry()
    for sp in tracer.spans:
        if sp.cat == CAT_GPU:
            if sp.name in BUSY_KINDS:
                reg.count(f"{sp.pid}/busy_ms", sp.duration_ms)
            elif sp.name == "bubble":
                reg.count(f"{sp.pid}/bubble_ms", sp.duration_ms)
            elif sp.name == "allreduce":
                reg.count(f"{sp.pid}/allreduce_ms", sp.duration_ms)
            elif sp.name == "migration-stall":
                reg.count(f"{sp.pid}/migration_stall_ms", sp.duration_ms)
        elif sp.cat == CAT_PREFILL:
            ttft = sp.arg("ttft_ms")
            if ttft is not None:
                reg.observe("ttft_ms", ttft)
        elif sp.name == "transfer":
            reg.count(f"{sp.pid}/transfers", 1.0)
            reg.count(f"{sp.pid}/wan_bits", sp.arg("bits", 0.0))
        elif sp.name.startswith("migration:"):
            reg.count("migration_ms", sp.duration_ms)
            reg.count("replay_samples", sp.arg("replay_samples", 0.0))
    for cnt in tracer.counters:
        if cnt.name in ("iteration_ms", "utilization"):
            reg.observe(cnt.name, cnt.value)
    pids = sorted({sp.pid for sp in tracer.spans if sp.cat == CAT_GPU})
    snap_counters = dict(reg.snapshot().counters)
    for pid in pids:
        busy = snap_counters.get(f"{pid}/busy_ms", 0.0)
        bubble = snap_counters.get(f"{pid}/bubble_ms", 0.0)
        denom = busy + bubble
        reg.gauge(f"{pid}/bubble_frac", bubble / denom if denom > 0 else 0.0)
    return reg
