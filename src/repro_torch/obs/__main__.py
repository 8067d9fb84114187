"""CLI over exported traces: ``python -m repro_torch.obs <report|validate> trace.json``.

``report`` distills the standard run metrics (busy/bubble/allreduce
time, bubble fractions, channel traffic, TTFT/iteration histograms,
migration cost) out of an exported Chrome trace and prints them as
deterministic JSON — the same summary regardless of which engine
produced the trace.

``validate`` structurally checks an exported trace file:

* every event carries its required fields for its phase and references
  a metadata-named process/thread;
* span bounds are monotone (``dur >= 0``) and finite;
* no productive GPU span sits inside a dead-DC outage window (windows
  are reconstructed from the ``outage:dc_outage`` spans the control
  plane emits; the span's ``dc`` arg is matched against the outage's
  ``dc_index``) — the trace-level form of ``validate.check_horizon``'s
  nothing-ran-on-a-dead-DC invariant.

Exit status 0 on success, 1 with one line per violation on failure.

The port's own copy of ``repro/obs/__main__.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import List

from repro_torch.obs.export import read_chrome_trace
from repro_torch.obs.metrics import metrics_from_tracer
from repro_torch.obs.tracer import BUSY_KINDS, CAT_GPU

_REQUIRED = {
    "X": ("name", "cat", "pid", "tid", "ts", "dur"),
    "i": ("name", "pid", "tid", "ts"),
    "C": ("name", "pid", "ts", "args"),
    "M": ("name", "pid", "args"),
}


def validate_trace_file(path: str) -> List[str]:
    """Structural violations in an exported trace (empty when valid)."""
    errors: List[str] = []
    with open(path, "r", encoding="utf-8") as fh:
        trace = json.load(fh)
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return [f"{path}: no traceEvents array"]
    named_pids = set()
    named_tids = set()
    for ev in events:
        if ev.get("ph") == "M":
            if ev.get("name") == "process_name":
                named_pids.add(ev.get("pid"))
            elif ev.get("name") == "thread_name":
                named_tids.add((ev.get("pid"), ev.get("tid")))
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in _REQUIRED:
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        missing = [f for f in _REQUIRED[ph] if f not in ev]
        if missing:
            errors.append(f"event {i} (ph={ph}): missing fields {missing}")
            continue
        if ph in ("X", "i", "C") and not math.isfinite(ev["ts"]):
            errors.append(f"event {i}: non-finite ts")
        if ph == "X":
            if not math.isfinite(ev["dur"]) or ev["dur"] < 0.0:
                errors.append(
                    f"event {i} ({ev['name']}): non-monotone span "
                    f"(dur={ev['dur']})"
                )
            if (ev["pid"], ev["tid"]) not in named_tids:
                errors.append(
                    f"event {i} ({ev['name']}): unnamed lane "
                    f"pid={ev['pid']} tid={ev['tid']}"
                )
        if ph in ("X", "i", "C") and ev["pid"] not in named_pids:
            errors.append(f"event {i} ({ev['name']}): unnamed pid {ev['pid']}")

    # dead-DC invariant: reconstruct outage windows, then reject any
    # productive GPU span on the dead DC fully inside one
    tr = read_chrome_trace(path)
    outages = [
        (sp.t0_ms, sp.t1_ms, sp.arg("dc_index"))
        for sp in tr.spans
        if sp.name == "outage:dc_outage" and sp.arg("dc_index") is not None
    ]
    if outages:
        eps = 1e-6
        for sp in tr.spans:
            if sp.cat != CAT_GPU or sp.name not in BUSY_KINDS:
                continue
            dc = sp.arg("dc")
            for t0, t1, dead in outages:
                if dc == dead and sp.t0_ms >= t0 - eps and sp.t1_ms <= t1 + eps:
                    errors.append(
                        f"{sp.name} span [{sp.t0_ms}, {sp.t1_ms}] on "
                        f"{sp.pid}/{sp.tid} runs on dead dc {dead} inside "
                        f"outage [{t0}, {t1}]"
                    )
    return errors


def report(path: str) -> str:
    """Deterministic JSON metrics report for an exported trace."""
    snap = metrics_from_tracer(read_chrome_trace(path)).snapshot()
    return json.dumps(snap.as_dict(), sort_keys=True, indent=2) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Inspect and validate exported simulation traces.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_rep = sub.add_parser("report", help="print run metrics as JSON")
    p_rep.add_argument("trace", help="exported Chrome trace-event JSON file")
    p_val = sub.add_parser("validate", help="structurally validate a trace")
    p_val.add_argument("trace", help="exported Chrome trace-event JSON file")
    args = parser.parse_args(argv)
    if args.cmd == "report":
        sys.stdout.write(report(args.trace))
        return 0
    errors = validate_trace_file(args.trace)
    if errors:
        for e in errors:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print(f"OK: {args.trace} passes structural validation")
    return 0


if __name__ == "__main__":
    sys.exit(main())
