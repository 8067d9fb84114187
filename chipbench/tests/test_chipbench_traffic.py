"""The generator repeats exactly for a seed and differs across seeds; every
seed of a prefill mix serves the same groups of lengths, in its own order."""
import itertools

import numpy as np

from chipbench import generator
from chipbench.spec import load_cell

import chipbench_cpu  # noqa: F401  (puts the checkout on the path)


def _mix(name):
    return load_cell(name).traffic


def test_train_batches_repeat_for_a_seed_and_differ_across_seeds():
    mix = dict(_mix("gpta-stage-train"), seq_len=64)
    a = generator.train_batches(mix, 50304, 2**31 + 5)
    b = generator.train_batches(mix, 50304, 2**31 + 5)
    c = generator.train_batches(mix, 50304, 2**31 + 6)
    first, again, other = next(a), next(b), next(c)
    assert first.shape == (8, 64) and first.dtype == np.int32
    assert (first == again).all() and (next(a) == next(b)).all()
    assert not (first == other).all()
    assert len({tuple(row) for row in first}) == 8  # rows all differ


def _prompts(mix, seed, n):
    return list(itertools.islice(generator.prompts(mix, 50304, seed), n))


def test_prompts_repeat_for_a_seed_and_serve_the_same_groups_across_seeds():
    mix = _mix("gpta-prefill-ragged")
    cycle, b = mix["lengths"]["cycle"], mix["max_batch"]
    n = 3 * cycle
    a, again, c = _prompts(mix, 2**32 + 1, n), _prompts(mix, 2**32 + 1, n), _prompts(mix, 7, n)
    assert all((x == y).all() for x, y in zip(a, again))
    assert [len(x) for x in a] != [len(x) for x in c]  # the seed orders the groups and their prompts
    assert not (a[0][:100] == c[0][:100]).all()  # ... and draws its own ids

    def batches(prompts, k):  # the groups of cycle k, as multisets
        chunk = prompts[k * cycle:(k + 1) * cycle]
        return sorted(tuple(sorted(len(p) for p in chunk[i:i + b])) for i in range(0, cycle, b))

    cut = sorted(tuple(sorted(g)) for g in generator.groups(mix))
    assert all(batches(p, k) == cut for p in (a, c) for k in range(3))
    lengths = [len(p) for p in a]
    assert min(lengths) >= mix["lengths"]["min"] and max(lengths) == mix["lengths"]["max"]
    assert sorted(lengths[:cycle]) == generator.length_pool(mix["lengths"], cycle)
