"""The model operations of the steps the traced run did not profile
(``costs/model_flops.py``: forward and backward, nothing recomputed) over
their wall time, as a share of one H100's bf16 peak, in %."""
from chipbench.costs import model_flops, peaks


def read(r):
    run = r["run"]
    if not run.get("untraced_steps"):
        return None
    flops = model_flops.train_step(r["config"], r["traffic"]) * run["untraced_steps"]
    return 100.0 * flops / run["untraced_s"] / peaks.BF16_FLOPS_PER_S
