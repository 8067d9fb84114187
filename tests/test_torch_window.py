"""The sliding window against the reference: GPT-A smoke with a window of 16,
a prompt of 40 prefilled into a ring of min(max_len, 16) slots, and decode
steps across the ring's wrap; the routes (a windowed prefill takes the masked
plain sdpa, as the reference's kernel route requires ``window is None``; a
windowed decode step goes to the decode kernel with its window); and greedy
token ids through the engine.  No shipped config has a window."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.transformer import build_model as ref_build_model
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefServingEngine
from repro.serving.engine import zeros_cache as ref_zeros_cache
from repro_torch import configs, convert
from repro_torch.kernels import ops as kops
from repro_torch.models import attention
from repro_torch.models.transformer import build_model
from repro_torch.serving.engine import Request, ServingEngine, zeros_cache
from torch_helpers import as_f32, reference_params

WINDOW, PROMPT, MAX_LEN, STEPS, B = 16, 40, 64, 20, 2
# as tests/test_torch_model.py
LOGIT_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _setup(dtype):
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("gpt_a"), dtype=jdt, window=WINDOW)
    cfg = dataclasses.replace(configs.get_smoke_config("gpt_a"), dtype=tdt, window=WINDOW)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    return ref_cfg, cfg, ref_params, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prompt_of_40_then_decode_across_the_wrap_matches_reference(dtype, monkeypatch):
    ref_cfg, cfg, ref_params, tree = _setup(dtype)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    params = model.cast_params(convert.from_reference(tree, cfg))
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32)
    windows = []
    decode = kops.decode_attention

    def spy(q, k, v, q_pos, kv_pos, *, window=None, scale=None):
        windows.append(window)
        return decode(q, k, v, q_pos, kv_pos, window=window, scale=scale)

    monkeypatch.setattr(kops, "decode_attention", spy)
    monkeypatch.setattr(kops, "flash_attention", lambda *a, **k: pytest.fail("a windowed prefill reached flash"))
    ref_logits, ref_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                                              ref_zeros_cache(ref_model, B, MAX_LEN))
    before = attention.sdpa_masked_calls
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, zeros_cache(model, B, MAX_LEN, "cpu"))
    assert attention.sdpa_masked_calls == before + cfg.num_layers
    assert cache["k"].shape[2] == WINDOW  # the ring: min(max_len, window) slots
    np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), **LOGIT_TOL[dtype])
    # the prompt's last 16 positions fill the ring, slot p % 16
    assert sorted(cache["pos"][0, 0].tolist()) == list(range(PROMPT - WINDOW, PROMPT))
    nxt = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    for step in range(STEPS):  # positions 40..59: 48 wraps round to slot 0
        pos = np.full((B,), PROMPT + step, np.int32)
        ref_logits, ref_cache = ref_model.decode_step(ref_params, ref_cache, jnp.asarray(nxt), jnp.asarray(pos))
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache, torch.from_numpy(nxt), torch.from_numpy(pos))
        np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), **LOGIT_TOL[dtype])
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
        nxt = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    assert windows == [WINDOW] * (cfg.num_layers * STEPS)
    assert sorted(cache["pos"][0, 0].tolist()) == list(range(PROMPT + STEPS - WINDOW, PROMPT + STEPS))


def test_the_window_changes_the_answer():
    """Past the window the logits differ from the unwindowed model's on the same weights."""
    _, cfg, _, tree = _setup("float32")
    tokens = torch.from_numpy(np.random.default_rng(8).integers(0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32))
    params = convert.from_reference(tree, cfg)
    with torch.no_grad():
        windowed, _ = build_model(cfg).prefill(params, {"tokens": tokens}, None)
        full, _ = build_model(dataclasses.replace(cfg, window=None)).prefill(params, {"tokens": tokens}, None)
    assert (windowed - full).abs().max() > 1e-2


def test_greedy_token_ids_equal_the_reference_engine_with_a_window():
    """Dense and ragged batches whose prompts and generations cross the ring's wrap (f32)."""
    ref_cfg, cfg, ref_params, tree = _setup("float32")
    ref_engine = RefServingEngine(ref_cfg, ref_params, max_batch=3, max_len=MAX_LEN)
    engine = ServingEngine(cfg, convert.from_reference(tree, cfg), max_batch=3, max_len=MAX_LEN, device="cpu")
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (30, 30, 12, 21)]
    for batch in (prompts[:2], prompts[1:]):
        want = ref_engine.generate([RefRequest(i, p.copy(), max_new_tokens=10) for i, p in enumerate(batch)])
        got = engine.generate([Request(i, p.copy(), max_new_tokens=10) for i, p in enumerate(batch)])
        assert [r.generated for r in got] == [r.generated for r in want]
