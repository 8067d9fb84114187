"""HuBERT-XLarge's bidirectional encoder (smoke config) against the reference
on converted weights: frame classification (``Model.loss`` on the pipeline's
audio batch: precomputed frame embeddings, labels, mask) and its gradients,
and ``Model.prefill(..., cache=None)``, which attends both ways through the
flash route (non-causal); with a cache a prefill is causal, in both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.transformer import build_model as ref_build_model
from repro.serving.engine import zeros_cache as ref_zeros_cache
from repro_torch import configs, convert
from repro_torch.data.pipeline import input_batch_for
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import build_model
from repro_torch.serving.engine import zeros_cache
from torch_helpers import as_f32, reference_params

ARCH = "hubert_xlarge"
# as tests/test_torch_model.py and tests/test_torch_loss.py
LOGIT_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, T = 2, 40


def _setup(dtype):
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), dtype=tdt)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    return ref_cfg, cfg, ref_params, tree, input_batch_for(cfg, B, T, seed=4)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frame_classification_loss_and_grads_match_reference(dtype):
    ref_cfg, cfg, ref_params, tree, batch = _setup(dtype)
    assert set(batch) == {"embeds", "labels", "mask"} and not cfg.causal
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(ref_build_model(ref_cfg).loss, has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.from_reference(tree, cfg)
    flat = convert.flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, metrics = build_model(cfg).loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    # the token table is not read by frames: no gradient here, zeros in the reference
    grads = {p: torch.zeros_like(flat[p]) if g is None else g for p, g in zip(flat, grads)}
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_TOL[dtype], atol=LOSS_TOL[dtype])
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(ref_metrics["ce"]), rtol=LOSS_TOL[dtype],
                               atol=LOSS_TOL[dtype])
    ref_flat = convert.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), ref_grads))
    assert set(grads) == set(ref_flat) and not ref_flat["embed"].any()
    for path, g in grads.items():
        assert _rel(g.numpy(), ref_flat[path]) <= GRAD_TOL[dtype], (path, _rel(g.numpy(), ref_flat[path]))


def test_a_masked_frame_adds_nothing_to_the_loss():
    """Frames at mask 0 carry no weight: changing their labels leaves the loss as it was."""
    _, cfg, _, tree, batch = _setup("float32")
    model, params = build_model(cfg), convert.from_reference(tree, cfg)
    mask = batch["mask"].copy()
    mask[:, ::3] = 0.0
    other = batch["labels"].copy()
    other[:, ::3] = (other[:, ::3] + 1) % cfg.vocab_size
    with torch.no_grad():
        a, _ = model.loss(params, {"embeds": torch.from_numpy(batch["embeds"]), "labels": torch.from_numpy(batch["labels"]),
                                   "mask": torch.from_numpy(mask)})
        b, _ = model.loss(params, {"embeds": torch.from_numpy(batch["embeds"]), "labels": torch.from_numpy(other),
                                   "mask": torch.from_numpy(mask)})
    assert float(a) == float(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_without_a_cache_is_bidirectional_and_matches_reference(dtype, monkeypatch):
    ref_cfg, cfg, ref_params, tree, batch = _setup(dtype)
    ref_logits, _ = ref_build_model(ref_cfg).prefill(ref_params, {"embeds": jnp.asarray(batch["embeds"])}, None)
    model = build_model(cfg)
    params = model.cast_params(convert.from_reference(tree, cfg))
    calls = []
    flash = kops.flash_attention

    def spy(q, k, v, *, causal=True, scale=None):
        calls.append(causal)
        return flash(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(kops, "flash_attention", spy)
    inputs = {"embeds": torch.from_numpy(batch["embeds"])}
    with torch.no_grad():
        logits, cache = model.prefill(params, inputs, None)
        causal, _ = build_model(dataclasses.replace(cfg, causal=True)).prefill(params, inputs, None)
    assert cache is None and calls == [False] * cfg.num_layers + [True] * cfg.num_layers
    np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), **LOGIT_TOL[dtype])
    # the last frame attends to every frame either way, but through the second
    # layer it reads the other frames' first-layer outputs, which differ
    assert (logits - causal).abs().max() > 1e-2


def test_prefill_with_a_cache_is_causal_as_the_reference():
    """The reference forces causal attention when a prefill writes a cache;
    the port mirrors it (logits and cache on the valid slots)."""
    ref_cfg, cfg, ref_params, tree, batch = _setup("float32")
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_logits, ref_cache = ref_model.prefill(ref_params, {"embeds": jnp.asarray(batch["embeds"])},
                                              ref_zeros_cache(ref_model, B, 64))
    params = model.cast_params(convert.from_reference(tree, cfg))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"embeds": torch.from_numpy(batch["embeds"])}, zeros_cache(model, B, 64, "cpu"))
    np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), **LOGIT_TOL["float32"])
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    valid = cache["pos"].numpy() >= 0
    np.testing.assert_allclose(as_f32(cache["k"])[valid], as_f32(ref_cache["k"])[valid], **LOGIT_TOL["float32"])


def test_an_encoder_batch_without_labels_is_refused():
    _, cfg, _, tree, batch = _setup("float32")
    with pytest.raises(KeyError):
        build_model(cfg).loss(convert.from_reference(tree, cfg), {"embeds": torch.from_numpy(batch["embeds"])})
