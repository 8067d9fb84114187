"""The one traffic generator.  A mix (``chipbench/traffic/<name>.json``) is
parameters only; its ``kind`` says which of the two shapes of traffic it is:

* ``"train"``: token batches of ``accum_steps * micro_batch`` rows of
  ``seq_len`` tokens, batch ``i`` seeded by (seed, i): Zipf(``zipf_a``) ids
  with a per-row lag copied with probability ``structure``.  This is the
  program's ``data/pipeline.py`` recipe (``_lm_tokens``), copied here so that
  the benchmark's inputs do not move with the program.
* ``"prefill_closed_loop"``: ``clients`` clients, each issuing its next
  request when its last one is answered, a prompt of uniform random ids.  The
  lengths come in cycles of ``cycle``: the quantiles of a log-normal
  (``median``, ``sigma``) clipped to [``min``, ``max``], cut once into groups
  of ``max_batch`` (``GROUPING``, the same groups for every seed); in each
  cycle the groups come in an order drawn from the seed, and each group's
  lengths too.  Served oldest first, ``max_batch`` at a time, by twice as many
  clients, each group is one batch: every seed does the same work in its own
  order, and draws its own ids."""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, Iterator, List

import numpy as np


def _lm_tokens(rng: np.random.Generator, rows: int, seq_len: int, vocab: int, zipf_a: float,
               structure: float) -> np.ndarray:
    base = rng.zipf(zipf_a, size=(rows, seq_len)).astype(np.int64) % vocab
    lags = rng.integers(1, 8, size=(rows, 1))
    copy = rng.random((rows, seq_len)) < structure
    idx = np.maximum(np.arange(seq_len)[None, :] - lags, 0)
    return np.where(copy, np.take_along_axis(base, idx, axis=1), base).astype(np.int32)


def train_batches(mix: Dict[str, Any], vocab: int, seed: int) -> Iterator[np.ndarray]:
    """Batch after batch, (accum_steps * micro_batch, seq_len) int32."""
    rows = mix["accum_steps"] * mix["micro_batch"]
    step = 0
    while True:
        rng = np.random.default_rng((int(seed), step))
        yield _lm_tokens(rng, rows, mix["seq_len"], vocab, mix["zipf_a"], mix["structure"])
        step += 1


def length_pool(lengths: Dict[str, Any], n: int) -> List[int]:
    """n prompt lengths of the mix, in increasing order."""
    dist = statistics.NormalDist()
    out = []
    for i in range(n):
        z = dist.inv_cdf((i + 0.5) / n)
        out.append(int(min(max(round(lengths["median"] * math.exp(lengths["sigma"] * z)), lengths["min"]),
                           lengths["max"])))
    return out


GROUPING = 0  # the seed of the one cut of a cycle's lengths into groups


def groups(mix: Dict[str, Any]) -> List[List[int]]:
    """A cycle's lengths in the groups that every seed serves."""
    lengths = np.random.default_rng(GROUPING).permutation(length_pool(mix["lengths"], mix["lengths"]["cycle"]))
    b = mix["max_batch"]
    return [[int(n) for n in lengths[i:i + b]] for i in range(0, len(lengths), b)]


def prompts(mix: Dict[str, Any], vocab: int, seed: int) -> Iterator[np.ndarray]:
    """The prompts in the order the clients issue them, without end."""
    cut = groups(mix)
    ids = np.random.default_rng((int(seed), 3))
    cycle = 0
    while True:
        order = np.random.default_rng((int(seed), 4, cycle))
        for g in order.permutation(len(cut)):
            for n in order.permutation(cut[g]):
                yield ids.integers(0, vocab, size=int(n), dtype=np.int32)
        cycle += 1
