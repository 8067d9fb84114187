"""The mean device milliseconds a step of ``adamw_update`` (the clip and the
update of every leaf), between CUDA events, over the traced run's window."""
import statistics


def read(r):
    ms = r["run"].get("adamw_ms")
    return statistics.fmean(ms) if ms else None
