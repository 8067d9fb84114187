"""The numbers that decide ``correct``, each with its limit from
``chipbench/limits/<workload>.json``.  A number without a limit there fails,
unless the file lists it under ``not_compared`` (a number whose readings found
no control or fault that it separates from sound runs): a cell is correct only
when every number it compares is at or under its limit.

Training (``train_numbers``), each a relative gap against the reference:
  loss_<i>     step i's loss, for each checked step;
  grad_norm    step 1's global gradient norm;
  grad_leaf    the worst leaf's gradient norm as AdamW took it at step 1,
               against the larger of that leaf's norm and the median leaf's;
  grad_diff    the worst leaf's || g - g_ref || at step 1, estimated from
               the gaps of their products with a few random vectors (the
               train driver's ``_sketch``), likewise: rounding in each
               element enters it at first order, a gap of norms at second;
  change_leaf  the worst leaf's change over the steps before the last, likewise; a
               leaf whose reference gradient is under a thousandth of the
               median leaf's is left out (it moves by round-off alone).

Serving (``serve_numbers``):
  served_gap   the widest gap by which a served token's reference logit lies
               below the reference's best at that position;
  cache_gap    the worst layer's relative gap of the handed-off K and V,
               projected on a fixed random probe, against the reference's."""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Optional, Tuple

Numbers = List[Tuple[str, float, Optional[float]]]
IGNORED_GRAD = 1e-3  # of the median leaf's gradient norm


def _rel(a: float, b: float, base: float) -> float:
    return abs(a - b) / base if base > 0 else (0.0 if a == b else float("inf"))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep=lambda k: True) -> Dict[str, float]:
    """Each kept leaf's relative gap, against the larger of its norm and the median leaf's."""
    keys = [k for k in want if keep(k)]
    med = statistics.median(want[k] for k in keys)
    return {k: _rel(got[k], want[k], max(want[k], med)) for k in keys}


def _sketch_gap(got: List[float], want: List[float]) -> float:
    """|| x - y || estimated from the products of x and y with the same Gaussian vectors."""
    return math.sqrt(sum((a - b) ** 2 for a, b in zip(got, want)) / len(want))


def train_numbers(got: Dict[str, Any], want: Dict[str, Any], limits: Dict[str, Any]) -> Numbers:
    med_grad = statistics.median(want["grad_leaf"].values())
    moved = lambda k: want["grad_leaf"][k] >= IGNORED_GRAD * med_grad  # noqa: E731
    values = {f"loss_{i + 1}": _rel(g, w, abs(w)) for i, (g, w) in enumerate(zip(got["loss"], want["loss"]))}
    values.update({
        "grad_norm": _rel(got["grad_norm"], want["grad_norm"], want["grad_norm"]),
        "grad_leaf": max(leaf_gaps(got["grad_leaf"], want["grad_leaf"]).values()),
        "grad_diff": max(_sketch_gap(got["grad_sketch"][k], want["grad_sketch"][k]) / max(n, med_grad)
                         for k, n in want["grad_leaf"].items()),
        "change_leaf": max(leaf_gaps(got["change_leaf"], want["change_leaf"], moved).values()),
    })
    return _compared(values, limits)


def serve_numbers(served_gap: float, cache_gap: float, limits: Dict[str, Any]) -> Numbers:
    return _compared({"served_gap": served_gap, "cache_gap": cache_gap}, limits)


def _compared(values: Dict[str, float], limits: Dict[str, Any]) -> Numbers:
    skip = limits.get("not_compared", [])
    return [(k, v, limits.get(k)) for k, v in values.items() if k not in skip]


def correct(numbers: Numbers, failed: int) -> bool:
    return failed == 0 and all(limit is not None and value <= limit for _, value, limit in numbers)


def as_dict(numbers: Numbers) -> Dict[str, Dict[str, Any]]:
    """The numbers for the result line; one that is not finite is written as text."""
    return {k: {"value": v if math.isfinite(v) else str(v), "limit": lim} for k, v, lim in numbers}
