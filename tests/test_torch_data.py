"""The port's data pipeline (``repro_torch.data.pipeline``) against the
reference's: the same seed gives bit-equal batches for the LM, audio and VLM
families, and the same batches every time."""
import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.data import pipeline as ref_pipeline
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, input_batch_for, make_batches
from repro_torch.models.modules import ModelConfig

# the reference's smoke configs of each family against the port's own (every
# family here is ported; ``_port_cfg`` builds a config with the fields the
# pipeline reads for an architecture the port has not)
FAMILIES = {"gpt_a": {"tokens"}, "minitron_4b": {"tokens"}, "hubert_xlarge": {"embeds", "labels", "mask"},
            "qwen2_vl_7b": {"embeds", "positions", "labels", "mask"}}


def _port_cfg(arch):
    if arch in configs.ARCHS:
        return configs.get_smoke_config(arch)
    ref = ref_configs.get_smoke_config(arch)
    return ModelConfig(name=ref.name, family=ref.family, num_layers=ref.num_layers, d_model=ref.d_model,
                       num_heads=ref.num_heads, num_kv_heads=ref.num_kv_heads, d_ff=ref.d_ff,
                       vocab_size=ref.vocab_size)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_batches_are_bit_equal_to_the_reference(arch):
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), _port_cfg(arch)
    assert (cfg.family, cfg.d_model, cfg.vocab_size) == (ref_cfg.family, ref_cfg.d_model, ref_cfg.vocab_size)
    dc = DataConfig(seed=7, batch_size=3, seq_len=40)
    ref_dc = ref_pipeline.DataConfig(**dataclasses.asdict(dc))
    got = list(make_batches(cfg, dc, num_steps=3))
    want = list(ref_pipeline.make_batches(ref_cfg, ref_dc, num_steps=3))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w) == FAMILIES[arch]
        for k in g:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_batches_are_deterministic_and_steps_differ(arch):
    cfg = _port_cfg(arch)
    b1, b2 = input_batch_for(cfg, 4, 32, seed=7), input_batch_for(cfg, 4, 32, seed=7)
    assert set(b1) == FAMILIES[arch]
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    first, second = make_batches(cfg, DataConfig(seed=7, batch_size=4, seq_len=32), num_steps=2)
    key = "tokens" if "tokens" in first else "embeds"
    assert not np.array_equal(first[key], second[key])
    if "tokens" in b1:
        assert b1["tokens"].dtype == np.int32 and b1["tokens"].min() >= 0 and b1["tokens"].max() < cfg.vocab_size
