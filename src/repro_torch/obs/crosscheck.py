"""Second-witness cross-check: the trace must re-derive the engine's
own accounting.

``verify_trace`` takes a :class:`~repro_torch.obs.tracer.RecordingTracer`
whose expectations were registered at emission time (each one is the
engine's first-witness totals for one iteration window) and recomputes,
from the emitted spans alone:

* GPU utilization — busy span time over ``window * n_lanes``, the same
  quotient ``simulator._finalize`` forms;
* bubble totals — the sum of ``bubble`` span durations;
* per-lane allreduce durations;
* per-directed-pair WAN bits — the sum of ``transfer`` span ``bits``
  args, which count ``bytes_to_bits(act_bytes) * replicas`` per
  recorded transfer.  The expectation side is the engines' *analytic*
  ``stats["wan_bits"]`` (``simulator.iteration_wan_bits``), so the two
  witnesses really are independent: one counts what moved on the wire,
  the other derives what must move from the model.

Comparisons use ``math.isclose`` at ``rel_tol=1e-9`` — the only
admissible slack is float summation order (the witness accumulates in
sorted-lane order, ``_finalize`` in dict order), orders of magnitude
below any real corruption.  This intentionally mirrors
``validate.check_sim_result``'s bubble-tiling/utilization accounting
(``validate.EPS``-style tolerances on derived quantities, exact
identity on counts).

The port's own copy of ``repro/obs/crosscheck.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from repro_torch.obs.tracer import BUSY_KINDS, Expectation, SpanEvent

#: tolerance for re-derived totals: float summation order only
REL_TOL = 1e-9
ABS_TOL = 1e-6


class TraceMismatch(AssertionError):
    """The spans do not re-derive the engine's accounting."""


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=REL_TOL, abs_tol=ABS_TOL)


def _in_window(sp: SpanEvent, t0_ms: float, t1_ms: float) -> bool:
    return sp.t0_ms >= t0_ms - ABS_TOL and sp.t1_ms <= t1_ms + ABS_TOL


def _check_window(exp: Expectation, spans: List[SpanEvent]) -> None:
    gpu_pid = f"{exp.label}/gpu"
    sel = [
        sp for sp in spans
        if sp.pid == gpu_pid and _in_window(sp, exp.t0_ms, exp.t1_ms)
    ]
    window_ms = exp.t1_ms - exp.t0_ms
    busy_sum = 0.0
    bubble_sum = 0.0
    lanes = set()
    for sp in sel:
        lanes.add(sp.tid)
        if sp.name in BUSY_KINDS:
            busy_sum += sp.duration_ms
        elif sp.name == "bubble":
            bubble_sum += sp.duration_ms
        elif sp.name == "allreduce":
            if not _close(sp.duration_ms, exp.allreduce_ms):
                raise TraceMismatch(
                    f"{exp.label} @ {exp.t0_ms}: allreduce span "
                    f"{sp.duration_ms} != {exp.allreduce_ms}"
                )
    if len(lanes) != exp.n_lanes:
        raise TraceMismatch(
            f"{exp.label} @ {exp.t0_ms}: {len(lanes)} GPU lanes traced, "
            f"engine accounted {exp.n_lanes}"
        )
    util = (
        busy_sum / (window_ms * exp.n_lanes)
        if window_ms > 0 and exp.n_lanes
        else 0.0
    )
    if not _close(util, exp.utilization):
        raise TraceMismatch(
            f"{exp.label} @ {exp.t0_ms}: span-derived utilization {util} "
            f"!= engine utilization {exp.utilization}"
        )
    if not _close(bubble_sum, exp.bubble_ms):
        raise TraceMismatch(
            f"{exp.label} @ {exp.t0_ms}: span-derived bubble total "
            f"{bubble_sum} != engine bubble total {exp.bubble_ms}"
        )
    if exp.wan_bits is None:
        return
    chan_pid = f"{exp.label}/wan"
    derived: Dict[Tuple[int, int], float] = {}
    for sp in spans:
        if sp.pid != chan_pid or not _in_window(sp, exp.t0_ms, exp.t1_ms):
            continue
        pair = tuple(sp.arg("pair"))
        derived[pair] = derived.get(pair, 0.0) + sp.arg("bits", 0.0)
    expected = dict(exp.wan_bits)
    for pair in sorted(set(derived) | set(expected)):
        got = derived.get(pair, 0.0)
        want = expected.get(pair, 0.0)
        if not _close(got, want):
            raise TraceMismatch(
                f"{exp.label} @ {exp.t0_ms}: channel {pair} moved {got} "
                f"bits in spans, engine accounted {want}"
            )


def verify_trace(tracer) -> int:
    """Check every registered expectation against the recorded spans;
    returns the number of windows verified.  Raises
    :class:`TraceMismatch` on the first disagreement."""
    spans = list(tracer.spans)
    for exp in tracer.expectations:
        _check_window(exp, spans)
    return len(tracer.expectations)
