"""Model operations, from a configuration's shapes: what the model's
mathematics needs, with nothing recomputed (remat is not counted) and no
padding.  A product of (n, a) by (a, b) is 2 n a b operations; the backward
of the whole step is twice its forward.

A layer's operations over a sequence come from the family's reference
module (``chipbench/reference/<reference>.py``, ``layer_flops``), so that a
new family brings its count in its own file; the head, 2 d V at each
position it is taken at, is common to all."""
from typing import Any, Dict

from chipbench.spec import load_module, shapes


def forward(config: Dict[str, Any], n: int, head_positions: int) -> float:
    """One sequence of n tokens through every layer, the head at ``head_positions`` of them."""
    m = shapes(config)
    layer = load_module("reference", config["reference"]).layer_flops(m, n)
    return m["num_layers"] * layer + 2 * m["d_model"] * m["vocab_size"] * head_positions


def train_step(config: Dict[str, Any], mix: Dict[str, Any]) -> float:
    """One optimizer step of the mix: every row forward and backward, the head at every position."""
    rows = mix["accum_steps"] * mix["micro_batch"]
    return 3 * rows * forward(config, mix["seq_len"], mix["seq_len"])


def prefill(config: Dict[str, Any], n: int) -> float:
    """One prompt of n tokens, the head at its last position."""
    return forward(config, n, 1)
