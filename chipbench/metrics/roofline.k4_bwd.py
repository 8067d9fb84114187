"""K4's backward on its chunked route: the least time its call's work needs
(``costs/k4_bwd.py``) over the call's device time, the traced kernels of its
calls summed and divided by its calls, in %."""
from chipbench.costs import k4_bwd


def read(r):
    window = r["run"].get("trace")
    if window is None:
        return None
    seconds, calls = window.seconds_and_calls(k4_bwd.KERNELS, k4_bwd.CALL)
    if not calls or seconds <= 0:
        return None
    m, mix = r["config"]["model"], r["traffic"]
    D = m["rwkv"]["head_dim"]
    least, _ = k4_bwd.bound(mix["micro_batch"], mix["seq_len"], m["d_model"] // D, D)
    return 100.0 * least / (seconds / calls)
