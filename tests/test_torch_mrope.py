"""Qwen2-VL's M-RoPE and its VLM batch against the reference: ``apply_mrope``
at position rows that differ, as the pipeline's VLM batch makes them (image
patches at temporal position 0 with their own height and width ids); the
VLM batch's prefill and its loss and gradients, under the model's pin to the
masked plain sdpa; and the reference's fault with such a batch prefilled into
a cache, shown in both packages (ROADMAP Queue 3 (f))."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models.transformer import build_model as ref_build_model
from repro.serving.engine import zeros_cache as ref_zeros_cache
from repro_torch import configs, convert
from repro_torch.data.pipeline import input_batch_for
from repro_torch.kernels import ops as kops
from repro_torch.models import attention
from repro_torch.models.transformer import build_model
from repro_torch.serving.engine import zeros_cache
from torch_helpers import as_f32, reference_params, tol, to_jax, to_torch

ARCH = "qwen2_vl_7b"
# as tests/test_torch_model.py and tests/test_torch_loss.py
LOGIT_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, T = 2, 40  # 10 image patches, 30 text tokens


def _vlm_batch(cfg):
    """The pipeline's VLM batch (bit-equal to the reference's: tests/test_torch_data.py)."""
    return input_batch_for(cfg, B, T, seed=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_reference_at_distinct_rows(dtype):
    cfg = configs.get_smoke_config(ARCH)
    pos = _vlm_batch(cfg)["positions"]  # (3, B, T)
    assert not np.array_equal(pos[0], pos[1]) and not np.array_equal(pos[1], pos[2])
    x = np.random.default_rng(1).standard_normal((B, T, 4, cfg.resolved_head_dim)).astype(np.float32)
    got = attention.apply_mrope(to_torch(x, dtype), torch.from_numpy(pos), cfg.mrope_sections, cfg.rope_theta)
    want = ref_attn.apply_mrope(to_jax(x, dtype), jnp.asarray(pos), cfg.mrope_sections, cfg.rope_theta)
    assert got.dtype == to_torch(x, dtype).dtype
    np.testing.assert_allclose(as_f32(got), as_f32(want), **tol(dtype))
    # rows that differ rotate otherwise than plain RoPE over the temporal row
    plain = attention.apply_rope(to_torch(x, dtype), torch.from_numpy(pos[0]), cfg.rope_theta)
    assert np.abs(as_f32(plain) - as_f32(got)).max() > 0.1


def test_apply_mrope_of_equal_rows_is_rope():
    """Text tokens carry (t, t, t): M-RoPE is then RoPE, bit for bit."""
    cfg = configs.get_smoke_config(ARCH)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((B, T, 4, cfg.resolved_head_dim)).astype(np.float32))
    p = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    got = attention.apply_mrope(x, p[None].expand(3, B, T), cfg.mrope_sections, cfg.rope_theta)
    assert torch.equal(got, attention.apply_rope(x, p, cfg.rope_theta))


def test_mrope_configs_the_port_cannot_run_raise():
    cfg = configs.get_smoke_config(ARCH)
    attention.check_supported(cfg)
    with pytest.raises(ValueError, match="sections"):
        build_model(dataclasses.replace(cfg, mrope_sections=(8, 8, 8)))
    mla = configs.get_smoke_config("deepseek_v2_lite_16b")
    with pytest.raises(NotImplementedError, match="MLA"):
        build_model(dataclasses.replace(mla, mrope_sections=(8, 12, 12)))


def _setup(dtype):
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), dtype=tdt)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    return ref_cfg, cfg, ref_params, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_batch_prefill_matches_reference_under_the_pin(dtype, monkeypatch):
    """``embeds`` with their own positions take the masked plain sdpa (the
    reference's default "xla" impl masks by position: the patches attend one
    another both ways), L calls and no flash call, under the "kernel" impl."""
    ref_cfg, cfg, ref_params, tree = _setup(dtype)
    batch = _vlm_batch(cfg)
    inputs = {k: batch[k] for k in ("embeds", "positions")}
    ref_logits, _ = ref_build_model(ref_cfg).prefill(ref_params, {k: jnp.asarray(v) for k, v in inputs.items()}, None)
    model = build_model(cfg)
    params = model.cast_params(convert.from_reference(tree, cfg))

    def no_flash(*a, **k):
        raise AssertionError("the VLM batch reached the flash kernel's route")

    monkeypatch.setattr(kops, "flash_attention", no_flash)
    before = attention.sdpa_masked_calls
    assert attention.get_attention_impl() == "kernel"
    with torch.no_grad():
        logits, cache = model.prefill(params, {k: torch.from_numpy(v) for k, v in inputs.items()}, None)
    assert cache is None and attention.sdpa_masked_calls == before + cfg.num_layers
    assert attention.get_attention_impl() == "kernel"
    np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), **LOGIT_TOL[dtype])


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_batch_loss_and_grads_match_reference(dtype):
    """The pipeline's VLM batch (labels, the patches masked out of the loss)
    through ``Model.loss`` under the pin, and every gradient."""
    ref_cfg, cfg, ref_params, tree = _setup(dtype)
    batch = _vlm_batch(cfg)
    (ref_loss, _), ref_grads = jax.value_and_grad(ref_build_model(ref_cfg).loss, has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.from_reference(tree, cfg)
    flat = convert.flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    before = attention.sdpa_masked_calls
    loss, _ = build_model(cfg).loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert attention.sdpa_masked_calls == before + cfg.num_layers
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    # the embedding table is not read by an embeds batch: no gradient here, zeros in the reference
    grads = {p: torch.zeros_like(flat[p]) if g is None else g for p, g in zip(flat, grads)}
    assert not np.asarray(ref_grads["embed"], np.float32).any()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_TOL[dtype], atol=LOSS_TOL[dtype])
    ref_flat = convert.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), ref_grads))
    assert set(grads) == set(ref_flat)
    for path, g in grads.items():
        assert _rel(g.numpy(), ref_flat[path]) <= GRAD_TOL[dtype], (path, _rel(g.numpy(), ref_flat[path]))


def test_vlm_batch_prefilled_into_a_cache_keeps_one_patch_in_slot_0():
    """The reference's fault, left as it is (ROADMAP Queue 3 (f)): every image
    patch sits at temporal position 0, so all of them write ring slot 0 (the
    reference's comment assumes contiguous positions); the ring keeps one of
    them, which one unspecified in both packages, and slots 1..n_img-1 stay
    empty.  Both packages show it alike; they agree on every slot one token wrote."""
    ref_cfg, cfg, ref_params, tree = _setup("float32")
    batch = _vlm_batch(cfg)
    n_img, max_len = T // 4, 64
    inputs = {k: batch[k] for k in ("embeds", "positions")}
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_logits, ref_cache = ref_model.prefill(ref_params, {k: jnp.asarray(v) for k, v in inputs.items()},
                                              ref_zeros_cache(ref_model, B, max_len))
    params = model.cast_params(convert.from_reference(tree, cfg))
    with torch.no_grad():
        logits, cache = model.prefill(params, {k: torch.from_numpy(v) for k, v in inputs.items()},
                                      zeros_cache(model, B, max_len, "cpu"))
    L = cfg.num_layers
    for pos in (np.asarray(ref_cache["pos"]), cache["pos"].numpy()):
        assert (pos == 0).sum() == L * B  # one slot of each (layer, row) holds position 0
        assert (pos[:, :, 1:n_img] == -1).all()  # the other patches' slots stay empty
        assert (pos >= 0).sum() == L * B * (T - n_img + 1)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    one_writer = cache["pos"].numpy() > 0
    for name in ("k", "v"):
        np.testing.assert_allclose(as_f32(cache[name])[one_writer], as_f32(ref_cache[name])[one_writer],
                                   **LOGIT_TOL["float32"])
    # the logits agree too: a prefill with a cache is causal by position in both (the reference's rule)
    np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), **LOGIT_TOL["float32"])
