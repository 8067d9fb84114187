"""Unified observability layer: structured sim tracing, Perfetto export,
and a run-metrics report.

Every engine in ``repro_torch.core`` accepts an optional :class:`Tracer`.  The
default (``None`` or :class:`NullTracer`) is near-zero overhead — the
engines guard every emission behind ``tracer.enabled`` — while a
:class:`RecordingTracer` collects typed span/instant/counter events
stamped in **sim time** (milliseconds on the simulated wall clock, never
the host clock), so a recorded trace is a pure function of the run's
inputs and seeds.

Layers on top:

* ``repro_torch.obs.export`` — byte-deterministic Chrome trace-event JSON
  (load in Perfetto / ``chrome://tracing``): GPU lanes, WAN channel
  lanes, prefill lanes, control-plane instants.
* ``repro_torch.obs.crosscheck`` — the *second witness*: busy/bubble/
  utilization/wan_bits re-derived from the emitted spans must agree
  with the engine's own ``SimResult`` accounting, turning the trace
  into a falsifiable invariant rather than a log stream.
* ``repro_torch.obs.metrics`` — counters/gauges/histograms distilled from a
  trace, with a diffable :class:`MetricsSnapshot`.
* ``repro_torch.obs.schema`` — the registry of every ``SimResult.stats`` key
  the engines emit, with units-suffix-conformant names.
* ``python -m repro_torch.obs report|validate`` — CLI over exported traces.

This package deliberately imports nothing from ``repro_torch.core`` at module
level, so the engines can import it without cycles.

The port's own copy of ``repro/obs/__init__.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from repro_torch.obs.tracer import (
    BUSY_KINDS,
    CAT_CHANNEL,
    CAT_CONTROL,
    CAT_FLEET,
    CAT_GPU,
    CAT_PREFILL,
    CounterEvent,
    Expectation,
    InstantEvent,
    NullTracer,
    RecordingTracer,
    SpanEvent,
    Tracer,
)
from repro_torch.obs.emit import pair_lane, trace_schedule, trace_sim_result
from repro_torch.obs.crosscheck import TraceMismatch, verify_trace
from repro_torch.obs.export import (
    chrome_trace,
    dump_chrome_trace,
    read_chrome_trace,
    write_chrome_trace,
)
from repro_torch.obs.metrics import MetricsRegistry, MetricsSnapshot, metrics_from_tracer
from repro_torch.obs.schema import (
    REGISTRY,
    StatKey,
    conformance_errors,
    unregistered_keys,
)

__all__ = [
    "BUSY_KINDS",
    "CAT_CHANNEL",
    "CAT_CONTROL",
    "CAT_FLEET",
    "CAT_GPU",
    "CAT_PREFILL",
    "CounterEvent",
    "Expectation",
    "InstantEvent",
    "MetricsRegistry",
    "MetricsSnapshot",
    "NullTracer",
    "REGISTRY",
    "RecordingTracer",
    "SpanEvent",
    "StatKey",
    "TraceMismatch",
    "Tracer",
    "chrome_trace",
    "conformance_errors",
    "dump_chrome_trace",
    "metrics_from_tracer",
    "pair_lane",
    "read_chrome_trace",
    "trace_schedule",
    "trace_sim_result",
    "unregistered_keys",
    "verify_trace",
    "write_chrome_trace",
]
