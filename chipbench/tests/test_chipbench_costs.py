"""The frozen counts against counts worked out by hand at one small shape,
and the model operations of MFU against ``FlopCounterMode`` on the program's
CPU path with nothing recomputed."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chipbench_cpu as cpu
from chipbench.costs import k2_bwd, k4_bwd, model_flops, peaks


def test_k2_bwd_by_hand():
    # B 1, T 128, H 2, D 64, bf16: q, k, v, o, dO read and dq, dk, dv written, 8 x 128 x 2 x 64 x 2 B
    # = 262,144 B, the LSE 1 x 2 x 128 x 4 = 1,024 B; causal pairs 128 x 129 / 2 = 8,256,
    # five products of 2 x 64 each a pair and head: 5 x 128 x 2 x 8,256 = 10,567,680
    assert k2_bwd.work(1, 128, 2, 64) == (263_168, 10_567_680)
    seconds, by = k2_bwd.bound(1, 128, 2, 64)
    assert by == "bytes" and seconds == pytest.approx(263_168 / 3.35e12)


def test_k4_bwd_by_hand():
    # B 1, T 128, H 2, D 64: n = 16,384; 7 n x 2 B + 2 n x 4 B + 2 x 2 x 64 x 4 B = 229,376 + 131,072 + 1,024
    # two chunks of 64: per chunk 756 + 716 + 676 + 636 = 2,784 products, the states 384 for the first chunk
    # (2 x 2,784 + 384) x 2 heads x 4,096 operations = 48,758,784
    assert k4_bwd.work(1, 128, 2, 64) == (361_472, 48_758_784)
    assert k4_bwd.bound(1, 128, 2, 64)[1] == "bytes"


def test_model_flops_by_hand():
    m = {"num_layers": 1, "d_model": 8, "num_heads": 2, "head_dim": 4, "d_ff": 16, "vocab_size": 10}
    # projections 2 x 3 x (4 x 8 x 8 + 2 x 8 x 16) = 3,072; attention 4 x 2 x 4 x 6 pairs = 192; head 2 x 8 x 10 = 160
    assert model_flops.prefill({"reference": "dense", "model": m}, 3) == 3_072 + 192 + 160
    r = {"num_layers": 1, "d_model": 64, "d_ff": 32, "vocab_size": 10, "rwkv": {"head_dim": 64}}
    # 2 x (6 x 4,096 + 2 x 64 x 16 + 2 x 64 x 32) = 61,440 and 5 x 4,096 + 320 = 20,800 a token; head 1,280
    config = {"reference": "rwkv6", "model": r, "fixed": {"decay_lora_rank": 16}}
    assert model_flops.prefill(config, 1) == 61_440 + 20_800 + 1_280
    assert peaks.BF16_FLOPS_PER_S == 989e12


@pytest.mark.parametrize("cell", ["gpta-stage-train", "rwkv6-stage-train"])
def test_mfu_counts_the_program_step_with_nothing_recomputed(cell):
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.optimizer import accumulated_value_and_grad

    from chipbench import generator, weights
    from chipbench.spec import load_module, model_config, shapes

    c = cpu.small_cell(cell, remat="none")
    m, mix = shapes(c.config), c.traffic
    ref = load_module("reference", c.config["reference"])
    params = weights.make(ref.layout(m), 1, "cpu", lambda p: torch.float32)
    model = build_model(model_config(c.config))
    tokens = torch.from_numpy(next(generator.train_batches(mix, m["vocab_size"], 1)))
    with FlopCounterMode(display=False) as counter:
        accumulated_value_and_grad(model.loss, params, {"tokens": tokens}, accum_steps=mix["accum_steps"])
    counts = {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}
    products = sum(n for op, n in counts.items() if op.startswith("aten.mm") or op.startswith("aten.addmm"))
    rows, T, L = mix["accum_steps"] * mix["micro_batch"], mix["seq_len"], m["num_layers"]
    attention = 0 if m.get("rwkv") else 4 * m["num_heads"] * m["head_dim"] * T * (T + 1) // 2
    recurrence = m["d_model"] // 64 * (5 * 64 * 64 + 5 * 64) * T if m.get("rwkv") else 0
    expected_products = model_flops.train_step(c.config, mix) - 3 * rows * L * (attention + recurrence)
    assert products == expected_products
    if not m.get("rwkv"):
        # the plain attention computes all T x T pairs, where the model counts the causal ones, and its
        # backward computes the scores again (K2 bwd's five products a pair), which MFU does not count:
        # two products a pair forward and five backward, each of 2 D operations a head
        full = sum(n for op, n in counts.items() if op.startswith("aten.bmm"))
        assert full == rows * L * (2 + 5) * 2 * m["num_heads"] * m["head_dim"] * T * T
