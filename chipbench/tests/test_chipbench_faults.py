"""Each fault a cell can have, planted under a run driven past the harness's
look for a card, turns ``correct`` false; the same run without it is correct.
Small sizes on the CPU in float32, held at the committed limits."""
import pytest

import chipbench_cpu as cpu

TRAIN_FAULTS = ["frozen", "half_batch"]  # the state handed back unchanged; the mean over half of each microbatch
SERVE_FAULTS = ["frozen", "half_batch", "token"]  # the handed-over cache empty; half a batch unserved; a token altered


def _cell(name):
    from chipbench.spec import load_cell

    return cpu.small_cell(name, remat="full", limits=load_cell(name).limits)


@pytest.mark.parametrize("name", ["gpta-stage-train", "rwkv6-stage-train"])
@pytest.mark.parametrize("fault", [None] + TRAIN_FAULTS)
def test_train_faults_are_not_correct(name, fault):
    result = cpu.drive(_cell(name), fault=fault)
    assert result["correct"] == (fault is None), result["checks"]


@pytest.mark.parametrize("fault", [None] + SERVE_FAULTS)
def test_serve_faults_are_not_correct(fault):
    result = cpu.drive(_cell("gpta-prefill-ragged"), fault=fault)
    assert result["correct"] == (fault is None), (result["failed"], result["checks"])
