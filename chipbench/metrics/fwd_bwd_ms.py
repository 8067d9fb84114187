"""The mean device milliseconds a step of ``accumulated_value_and_grad``
(every microbatch's loss and gradients, summed), between CUDA events, over
the traced run's window."""
import statistics


def read(r):
    ms = r["run"].get("fwd_bwd_ms")
    return statistics.fmean(ms) if ms else None
