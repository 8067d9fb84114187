"""The control, the reference in float8 in the program's place, comes out
not correct under the committed limits; here at a size a test can hold (on
the card at the cells' own sizes: ``chipbench/tools/readings.py``)."""
import pytest
import torch

import chipbench_cpu as cpu
from chipbench import compare
from chipbench.reference.common import Precision
from chipbench.spec import load_cell, load_module, shapes


@pytest.mark.parametrize("name", ["gpta-stage-train", "rwkv6-stage-train"])
def test_the_train_control_is_not_correct(name):
    cell = cpu.small_cell(name, limits=load_cell(name).limits)
    driver, ref = load_module("drivers", "train"), load_module("reference", cell.config["reference"])
    m, mix = shapes(cell.config), cell.traffic

    def follow(prec):
        return driver.follow(ref, m, mix, ref.layout(m), 5, torch.device("cpu"), prec, driver.CHECKED_STEPS)

    numbers = compare.train_numbers(follow(Precision("fp8")), follow(Precision("f32")), cell.limits)
    assert not compare.correct(numbers, 0), numbers


def test_the_serve_control_is_not_correct():
    name = "gpta-prefill-ragged"
    cell = cpu.small_cell(name, limits=load_cell(name).limits)
    # the served depth, at a test's width: the control's error grows with the layers it passes
    cell.config["model"].update(num_layers=24, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64, d_ff=1024)
    got = cpu.drive(cell)["_run"]["got"]
    driver, ref = load_module("drivers", "prefill_closed_loop"), load_module("reference", cell.config["reference"])
    numbers = compare.serve_numbers(*driver.control(ref, shapes(cell.config), 3, torch.device("cpu"), got),
                                    cell.limits)
    assert not compare.correct(numbers, 0), numbers
