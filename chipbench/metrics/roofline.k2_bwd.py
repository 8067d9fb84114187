"""K2's backward: the least time its call's work needs (``costs/k2_bwd.py``)
over the call's device time, the traced kernels of its calls summed and
divided by its calls, in %.  Read where the traced steps ran it."""
from chipbench.costs import k2_bwd


def read(r):
    window = r["run"].get("trace")
    if window is None:
        return None
    seconds, calls = window.seconds_and_calls(k2_bwd.KERNELS, k2_bwd.CALL)
    if not calls or seconds <= 0:
        return None
    m, mix = r["config"]["model"], r["traffic"]
    least, _ = k2_bwd.bound(mix["micro_batch"], mix["seq_len"], m["num_heads"], m["head_dim"])
    return 100.0 * least / (seconds / calls)
