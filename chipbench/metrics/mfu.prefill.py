"""The model operations of the valid prompt tokens of the calls the run did
not trace (``costs/model_flops.py``: each prompt's layers and causal
attention, the head at its last position; padding not counted) over those
calls' wall time, as a share of one H100's bf16 peak, in %."""
from chipbench.costs import model_flops, peaks


def read(r):
    batches = [b for b in r["run"].get("batch_log", []) if not b["traced"]]
    if not batches:
        return None
    flops = sum(model_flops.prefill(r["config"], n) for b in batches for n in b["lengths"])
    return 100.0 * flops / sum(b["seconds"] for b in batches) / peaks.BF16_FLOPS_PER_S
