"""Typed structured events and the ``Tracer`` protocol.

All timestamps are **sim time** — milliseconds on the simulated wall
clock the engines advance — never the host clock.  A recorded trace is
therefore a pure function of the run's inputs and seeds: two runs of
the same scenario produce byte-identical exports (regression-tested
across ``PYTHONHASHSEED`` values).

Three event shapes, mirroring the Chrome trace-event model the exporter
targets:

* :class:`SpanEvent` — a closed interval on one lane (a GPU doing
  ``fwd`` work, a WAN channel occupied by a transfer, a prefill running
  in a bubble, a migration stall).
* :class:`InstantEvent` — a point event (drift fire, re-plan decision,
  admission rejection, checkpoint stamp).
* :class:`CounterEvent` — a sampled scalar (per-iteration utilization).

Lanes are addressed by ``(pid, tid)`` string pairs — ``pid`` is the
process-level group (``"jobA/gpu"``, ``"fleet/wan"``), ``tid`` the lane
inside it (``"p0/s1"``, ``"a->b"``).  The exporter assigns numeric ids
deterministically by sorting these names.

``Tracer`` is duck-typed: engines only call ``span``/``instant``/
``counter``/``expect`` and read ``enabled``.  :class:`NullTracer` keeps
``enabled`` False so engines skip even argument construction;
:class:`RecordingTracer` appends frozen events to plain lists.

The port's own copy of ``repro/obs/tracer.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

#: Interval kinds that count as productive GPU work in the second
#: witness (``repro_torch.obs.crosscheck``) — must mirror the ``Interval``
#: kinds the engines emit plus BubbleTea's ``prefill``.
BUSY_KINDS = ("fwd", "rec", "bwd", "prefill")

CAT_GPU = "gpu"  # per-(pipeline, stage) GPU lanes
CAT_CHANNEL = "channel"  # directed WAN channel lanes (per-transfer spans)
CAT_PREFILL = "prefill"  # BubbleTea admission / placement lanes
CAT_CONTROL = "control"  # control-plane instants + migration/outage spans
CAT_FLEET = "fleet"  # allocator reservation / grant / throttle lanes

#: frozen ``(key, value)`` representation of event args — sorted by key
#: at construction so event identity is independent of kwargs order.
Args = Tuple[Tuple[str, object], ...]


def _freeze(args: dict) -> Args:
    return tuple(sorted(args.items(), key=lambda kv: kv[0]))


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One closed interval ``[t0_ms, t1_ms]`` on lane ``(pid, tid)``."""

    name: str
    cat: str
    pid: str
    tid: str
    t0_ms: float
    t1_ms: float
    args: Args = ()

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default

    @property
    def duration_ms(self) -> float:
        return self.t1_ms - self.t0_ms


@dataclasses.dataclass(frozen=True)
class InstantEvent:
    """One point event at ``t_ms`` on lane ``(pid, tid)``."""

    name: str
    cat: str
    pid: str
    tid: str
    t_ms: float
    args: Args = ()

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default


@dataclasses.dataclass(frozen=True)
class CounterEvent:
    """One sampled scalar at ``t_ms`` on counter track ``(pid, name)``."""

    name: str
    pid: str
    t_ms: float
    value: float


@dataclasses.dataclass(frozen=True)
class Expectation:
    """First-witness totals registered at emission time.

    Whenever an engine emits the spans of one iteration window it also
    registers what its *own* accounting said the window contains
    (``SimResult.utilization``, ``allreduce_ms``, bubble totals,
    ``stats["wan_bits"]``).  ``crosscheck.verify_trace`` re-derives the
    same totals from the emitted spans alone and compares — a corrupted
    or double-counted span set fails the check.

    ``wan_bits`` is ``None`` when the window carries no transfer log
    (e.g. a result emitted without transfer recording); the channel leg
    of the check is then skipped for that window.
    """

    label: str  # lane prefix: gpu spans on f"{label}/gpu", channels on f"{label}/wan"
    t0_ms: float
    t1_ms: float
    n_lanes: int
    utilization: float
    allreduce_ms: float
    bubble_ms: float
    wan_bits: Optional[Tuple[Tuple[Tuple[int, int], float], ...]] = None


class Tracer:
    """Duck-typed tracing protocol; the base class is a no-op.

    Engines must guard emission with ``tracer is not None and
    tracer.enabled`` so the disabled path never builds event
    arguments.
    """

    enabled: bool = False

    def span(self, name: str, cat: str, pid: str, tid: str,
             t0_ms: float, t1_ms: float, **args) -> None:
        pass

    def instant(self, name: str, cat: str, pid: str, tid: str,
                t_ms: float, **args) -> None:
        pass

    def counter(self, name: str, pid: str, t_ms: float, value: float) -> None:
        pass

    def expect(self, expectation: Expectation) -> None:
        pass


class NullTracer(Tracer):
    """Explicit no-op tracer — behaviourally identical to passing
    ``tracer=None`` (the overhead budget is benchmarked in
    ``benchmarks/sim_bench.py``'s ``trace_overhead`` cell)."""

    __slots__ = ()


class RecordingTracer(Tracer):
    """Collects every event in emission order, in sim time."""

    enabled = True

    def __init__(self) -> None:
        self.spans: List[SpanEvent] = []
        self.instants: List[InstantEvent] = []
        self.counters: List[CounterEvent] = []
        self.expectations: List[Expectation] = []

    def span(self, name: str, cat: str, pid: str, tid: str,
             t0_ms: float, t1_ms: float, **args) -> None:
        self.spans.append(
            SpanEvent(name, cat, pid, tid, t0_ms, t1_ms, _freeze(args))
        )

    def instant(self, name: str, cat: str, pid: str, tid: str,
                t_ms: float, **args) -> None:
        self.instants.append(
            InstantEvent(name, cat, pid, tid, t_ms, _freeze(args))
        )

    def counter(self, name: str, pid: str, t_ms: float, value: float) -> None:
        self.counters.append(CounterEvent(name, pid, t_ms, value))

    def expect(self, expectation: Expectation) -> None:
        self.expectations.append(expectation)

    @property
    def n_events(self) -> int:
        return len(self.spans) + len(self.instants) + len(self.counters)

    def clear(self) -> None:
        self.spans.clear()
        self.instants.clear()
        self.counters.clear()
        self.expectations.clear()
