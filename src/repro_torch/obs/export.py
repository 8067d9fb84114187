"""Byte-deterministic Chrome trace-event JSON export.

The output loads in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``: one process per ``pid`` lane group (a job's GPU
grid, the shared WAN, the prefill service), one thread per lane, with
span (``"X"``), instant (``"i"``), counter (``"C"``) and metadata
(``"M"``) events.  Timestamps are microseconds in the trace format, so
sim-time milliseconds are scaled by 1e3 at the boundary and rounded to
nanosecond resolution to keep the file stable and small.

Determinism contract (regression-tested byte-for-byte across process
restarts and ``PYTHONHASHSEED`` values):

* numeric pid/tid ids are assigned by *sorting* the string lane names,
  never by first-seen or hash order;
* events are emitted in a total sort order (timestamp, lane, phase,
  name, payload);
* the JSON is dumped with sorted keys and fixed separators.

The port's own copy of ``repro/obs/export.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

#: Chrome trace-event timestamps are microseconds; sim time is ms.
_US_PER_MS = 1e3


def _us(t_ms: float) -> float:
    return round(t_ms * _US_PER_MS, 3)


def _jsonable(value):
    if isinstance(value, tuple):
        return [_jsonable(v) for v in value]
    if isinstance(value, list):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in sorted(value.items(), key=lambda kv: str(kv[0]))}
    return value


def _args_dict(args) -> Dict[str, object]:
    return {k: _jsonable(v) for k, v in args}


def chrome_trace(tracer, *, label: Optional[str] = None) -> Dict:
    """Render a :class:`~repro_torch.obs.tracer.RecordingTracer` as a Chrome
    trace-event dict (``{"traceEvents": [...], ...}``)."""
    pids = sorted(
        {ev.pid for ev in tracer.spans}
        | {ev.pid for ev in tracer.instants}
        | {ev.pid for ev in tracer.counters}
    )
    pid_id = {name: i + 1 for i, name in enumerate(pids)}
    tids_by_pid: Dict[str, List[str]] = {}
    for name in pids:
        lanes = sorted(
            {ev.tid for ev in tracer.spans if ev.pid == name}
            | {ev.tid for ev in tracer.instants if ev.pid == name}
        )
        tids_by_pid[name] = lanes
    tid_id = {
        (pname, t): j + 1
        for pname in pids
        for j, t in enumerate(tids_by_pid[pname])
    }

    events: List[Dict] = []
    for pname in pids:
        events.append({
            "ph": "M", "name": "process_name", "pid": pid_id[pname],
            "tid": 0, "args": {"name": pname},
        })
        events.append({
            "ph": "M", "name": "process_sort_index", "pid": pid_id[pname],
            "tid": 0, "args": {"sort_index": pid_id[pname]},
        })
        for t in tids_by_pid[pname]:
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid_id[pname],
                "tid": tid_id[(pname, t)], "args": {"name": t},
            })
            events.append({
                "ph": "M", "name": "thread_sort_index", "pid": pid_id[pname],
                "tid": tid_id[(pname, t)],
                "args": {"sort_index": tid_id[(pname, t)]},
            })

    body: List[Dict] = []
    for sp in tracer.spans:
        body.append({
            "ph": "X", "name": sp.name, "cat": sp.cat,
            "pid": pid_id[sp.pid], "tid": tid_id[(sp.pid, sp.tid)],
            "ts": _us(sp.t0_ms), "dur": _us(sp.t1_ms - sp.t0_ms),
            "args": _args_dict(sp.args),
        })
    for ins in tracer.instants:
        body.append({
            "ph": "i", "s": "t", "name": ins.name, "cat": ins.cat,
            "pid": pid_id[ins.pid], "tid": tid_id[(ins.pid, ins.tid)],
            "ts": _us(ins.t_ms), "args": _args_dict(ins.args),
        })
    for cnt in tracer.counters:
        body.append({
            "ph": "C", "name": cnt.name, "pid": pid_id[cnt.pid], "tid": 0,
            "ts": _us(cnt.t_ms), "args": {"value": cnt.value},
        })
    body.sort(
        key=lambda ev: (
            ev["ts"], ev["pid"], ev["tid"], ev["ph"], ev["name"],
            json.dumps(ev, sort_keys=True),
        )
    )
    trace = {
        "displayTimeUnit": "ms",
        "traceEvents": events + body,
    }
    if label is not None:
        trace["otherData"] = {"label": label}
    return trace


def dump_chrome_trace(tracer, *, label: Optional[str] = None) -> str:
    """Byte-deterministic JSON string for :func:`chrome_trace`."""
    trace = chrome_trace(tracer, label=label)
    return json.dumps(trace, sort_keys=True, separators=(",", ":")) + "\n"


def write_chrome_trace(tracer, path: str, *, label: Optional[str] = None) -> str:
    """Write the trace to ``path``; returns the path for chaining."""
    payload = dump_chrome_trace(tracer, label=label)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(payload)
    return path


def read_chrome_trace(path: str):
    """Load an exported trace back into a ``RecordingTracer``.

    The inverse of :func:`write_chrome_trace` up to expectation records
    (first-witness totals are engine state, not part of the file — the
    second-witness crosscheck runs on live tracers, while the CLI's
    structural validation and the metrics report run on loaded ones).
    Unknown / foreign trace-event phases are ignored, so the loader also
    tolerates hand-edited files."""
    from repro_torch.obs.tracer import RecordingTracer

    with open(path, "r", encoding="utf-8") as fh:
        trace = json.load(fh)
    pid_name: Dict[int, str] = {}
    tid_name: Dict[tuple, str] = {}
    events = trace.get("traceEvents", [])
    for ev in events:
        if ev.get("ph") != "M":
            continue
        if ev.get("name") == "process_name":
            pid_name[ev["pid"]] = ev["args"]["name"]
        elif ev.get("name") == "thread_name":
            tid_name[(ev["pid"], ev["tid"])] = ev["args"]["name"]
    tr = RecordingTracer()
    for ev in events:
        ph = ev.get("ph")
        if ph not in ("X", "i", "C"):
            continue
        pid = pid_name.get(ev["pid"], str(ev["pid"]))
        if ph == "C":
            tr.counter(ev["name"], pid, ev["ts"] / _US_PER_MS,
                       ev.get("args", {}).get("value", 0.0))
            continue
        tid = tid_name.get((ev["pid"], ev["tid"]), str(ev["tid"]))
        args = ev.get("args", {})
        if ph == "X":
            t0 = ev["ts"] / _US_PER_MS
            tr.span(ev["name"], ev.get("cat", ""), pid, tid,
                    t0, t0 + ev.get("dur", 0.0) / _US_PER_MS, **args)
        else:
            tr.instant(ev["name"], ev.get("cat", ""), pid, tid,
                       ev["ts"] / _US_PER_MS, **args)
    return tr
