"""The port's configs and primitive layers against their JAX counterparts on
the same numpy inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import modules as ref_modules
from repro_torch import configs
from repro_torch.models import attention, modules
from torch_helpers import as_f32, to_jax, to_torch, tol

ARCHS = ["gpt_a", "gpt_b", "minitron_4b", "rwkv6_7b"]
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _same_config(cfg, ref_cfg):
    for f in dataclasses.fields(ref_cfg):
        want, got = getattr(ref_cfg, f.name), getattr(cfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert got == _DTYPES[jnp.dtype(want).name], f.name
        elif dataclasses.is_dataclass(want):  # the sub-configs are the port's own classes
            assert type(got).__name__ == type(want).__name__ and dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name
    assert {f.name for f in dataclasses.fields(cfg)} == {f.name for f in dataclasses.fields(ref_cfg)}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_mirrors_reference(arch, size):
    get, ref_get = ((configs.get_config, ref_configs.get_config) if size == "full"
                    else (configs.get_smoke_config, ref_configs.get_smoke_config))
    cfg, ref_cfg = get(arch), ref_get(arch)
    _same_config(cfg, ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    assert cfg.active_param_count() == ref_cfg.active_param_count()
    assert cfg.resolved_head_dim == ref_cfg.resolved_head_dim


def test_param_count_mirrors_reference_for_every_family():
    """``param_count`` is copied whole, so hold it on the reference's other
    architectures too (moe, mla, hybrid, rwkv), built from the reference's fields."""
    for arch in ref_configs.ARCHS:
        ref_cfg = ref_configs.get_config(arch)
        kw = {f.name: getattr(ref_cfg, f.name) for f in dataclasses.fields(ref_cfg)}
        kw["dtype"], kw["param_dtype"] = (_DTYPES[jnp.dtype(kw[k]).name] for k in ("dtype", "param_dtype"))
        for name, cls in (("mla", modules.MLAConfig), ("moe", modules.MoEConfig),
                          ("ssm", modules.SSMConfig), ("rwkv", modules.RWKVConfig)):
            if kw[name] is not None:
                kw[name] = cls(**dataclasses.asdict(kw[name]))
        cfg = modules.ModelConfig(**kw)
        assert cfg.param_count() == ref_cfg.param_count(), arch
        assert cfg.active_param_count() == ref_cfg.active_param_count(), arch


def test_canon_and_cli_ids():
    assert configs.canon("gpt-a") == "gpt_a" and configs.canon(" minitron-4b ") == "minitron_4b"
    assert configs.get_config("gpt-b").name == "gpt-b"
    assert configs.canon("rwkv6-7b") == "rwkv6_7b" and configs.get_config("rwkv6-7b").name == "rwkv6-7b"
    assert configs.canon("zamba2-2.7b") == configs.canon("zamba2-2p7b") == "zamba2_2p7b"
    assert configs.get_config("zamba2-2.7b").name == "zamba2-2.7b"
    with pytest.raises(KeyError):
        configs.canon("zamba3-2.7b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_casts_weight_to_activation_dtype(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), dtype=np.float32)
    w = rng.standard_normal((64, 48), dtype=np.float32) / 8
    y = modules.dense(torch.from_numpy(w), to_torch(x, dtype))  # f32 weight, as stored
    y_ref = ref_modules.dense(jnp.asarray(w), to_jax(x, dtype))
    assert y.dtype == _DTYPES[dtype]
    # one product of 64 terms: f32 differs by summation order, bf16 by one output rounding
    np.testing.assert_allclose(as_f32(y), as_f32(y_ref), **tol(dtype))
    # casting the weight once beforehand gives the same bits
    assert torch.equal(y, modules.dense(torch.from_numpy(w).to(_DTYPES[dtype]), to_torch(x, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 256), dtype=np.float32) * 3
    sc = rng.standard_normal((256,), dtype=np.float32)
    y = modules.rmsnorm(torch.from_numpy(sc), to_torch(x, dtype))
    y_ref = ref_modules.rmsnorm(jnp.asarray(sc), to_jax(x, dtype))
    np.testing.assert_allclose(as_f32(y), as_f32(y_ref), **tol(dtype))


@pytest.mark.parametrize("activation", ["swiglu", "relu2", "gelu"])
def test_ffn_apply_matches_reference(activation):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    p = {k: rng.standard_normal(s, dtype=np.float32) / np.sqrt(s[0])
         for k, s in (("w_up", (64, 128)), ("w_gate", (64, 128)), ("w_down", (128, 64)))}
    y = modules.ffn_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), activation)
    y_ref = ref_modules.ffn_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), activation)
    # f32 throughout; two products and one activation: 2e-5 covers the order of the sums
    np.testing.assert_allclose(as_f32(y), as_f32(y_ref), atol=2e-5, rtol=2e-5)


def test_ffn_gelu_is_the_tanh_form():
    x = torch.linspace(-3, 3, 64)[None]
    eye = torch.eye(64)
    y = modules.ffn_apply({"w_up": eye, "w_down": eye}, x, "gelu")
    assert torch.allclose(y, torch.nn.functional.gelu(x, approximate="tanh"), atol=1e-6)
    assert not torch.allclose(y, torch.nn.functional.gelu(x), atol=1e-5)


def test_ffn_unknown_activation_raises():
    with pytest.raises(ValueError):
        modules.ffn_apply({"w_up": torch.eye(4), "w_down": torch.eye(4)}, torch.zeros(1, 4), "silu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 4, 64), dtype=np.float32)
    pos = np.stack([np.arange(9), np.arange(9) + 500]).astype(np.int32)
    pos[0, :3] = -1  # pad rows
    y = attention.apply_rope(to_torch(x, dtype), torch.from_numpy(pos), 10_000.0)
    y_ref = ref_attn.apply_rope(to_jax(x, dtype), jnp.asarray(pos), 10_000.0)
    # f32 angles up to 508 rad: cos/sin of the two libraries differ by ~1e-5 there
    np.testing.assert_allclose(as_f32(y), as_f32(y_ref), atol=2e-2 if dtype == "bfloat16" else 1e-4, rtol=2e-2 if dtype == "bfloat16" else 1e-4)


def _sdpa_both(q, k, v, q_pos, kv_pos, **kw):
    with attention.force_impl("torch"):
        y = attention.sdpa(*(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)), **kw)
    y_ref = ref_attn.sdpa(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)), **kw)
    return as_f32(y), as_f32(y_ref)


def test_masked_sdpa_with_pad_rows_matches_reference():
    """Left-padded prefill: pad rows at position -1, GQA group 2."""
    rng = np.random.default_rng(4)
    B, T, Hq, Hkv, D = 2, 12, 4, 2, 32
    q = rng.standard_normal((B, T, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    pos = np.full((B, T), -1, np.int32)
    pos[0, 8:] = np.arange(4)
    pos[1] = np.arange(T)
    y, y_ref = _sdpa_both(q, k, v, pos, pos, causal=True)
    np.testing.assert_allclose(y, y_ref, atol=2e-5, rtol=2e-5)
    # a pad query sees no valid key: the uniform mean of V, not NaN and not zeros
    np.testing.assert_allclose(y[0, 0], np.repeat(v[0].mean(axis=0), Hq // Hkv, axis=0), atol=2e-5, rtol=2e-5)


def test_masked_sdpa_all_empty_cache_and_window_match_reference():
    rng = np.random.default_rng(5)
    B, S, Hq, Hkv, D = 2, 16, 4, 2, 32
    q = rng.standard_normal((B, 1, Hq, D), dtype=np.float32)
    k = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, S, Hkv, D), dtype=np.float32)
    kv_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    kv_pos[0] = -1  # row 0: an all-empty cache
    q_pos = np.array([[3], [9]], np.int32)
    for kw in (dict(causal=True), dict(causal=True, window=4), dict(causal=False)):
        y, y_ref = _sdpa_both(q, k, v, q_pos, kv_pos, **kw)
        np.testing.assert_allclose(y, y_ref, atol=2e-5, rtol=2e-5)


def test_sdpa_dispatch_follows_the_reference():
    """Under "kernel": dense prefill -> flash, one query -> decode; a window or
    unequal position shapes with T > 1 -> the masked path.  On the CPU the
    kernels' plain versions answer, so the routes must agree where both apply."""
    rng = np.random.default_rng(6)
    B, T, H, D = 1, 8, 2, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, D), dtype=np.float32)) for _ in range(3))
    pos = torch.arange(T, dtype=torch.int32)[None]
    assert attention.get_attention_impl() == "kernel"
    before = attention.sdpa_masked_calls
    y_kernel = attention.sdpa(q, k, v, pos, pos, causal=True)
    y_decode = attention.sdpa(q[:, -1:], k, v, pos[:, -1:], pos, causal=True)
    assert attention.sdpa_masked_calls == before
    y_window = attention.sdpa(q, k, v, pos, pos, causal=True, window=T)
    assert attention.sdpa_masked_calls == before + 1
    with attention.force_impl("torch"):
        y_torch = attention.sdpa(q, k, v, pos, pos, causal=True)
    assert attention.get_attention_impl() == "kernel" and attention.sdpa_masked_calls == before + 2
    torch.testing.assert_close(y_kernel, y_torch, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(y_window, y_torch, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(y_decode, y_torch[:, -1:], atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError):
        attention.set_attention_impl("pallas")


def test_unported_attention_flavours_raise():
    """The window and M-RoPE are ported (tests/test_torch_window.py,
    test_torch_mrope.py); M-RoPE sections that do not split the rotary half
    raise, as the reference's assertion does, and M-RoPE on MLA, which has no
    reference path, raises too."""
    cfg = configs.get_smoke_config("gpt_a")
    for change in (dict(window=64), dict(mrope_sections=(8, 12, 12))):
        attention.check_supported(dataclasses.replace(cfg, **change))
    with pytest.raises(ValueError):
        attention.check_supported(dataclasses.replace(cfg, mrope_sections=(8, 12, 16)))
    with pytest.raises(NotImplementedError):
        attention.check_supported(dataclasses.replace(configs.get_smoke_config("deepseek_v2_lite_16b"),
                                                      mrope_sections=(8, 12, 12)))


def test_initialisers_follow_their_generator():
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    a, b = modules.dense_init(g1, (3, 64, 32)), modules.dense_init(g2, (3, 64, 32))
    assert torch.equal(a, b) and a.shape == (3, 64, 32)
    assert abs(a.std().item() - 1 / 8) < 0.01  # std = 1/sqrt(fan_in), fan_in = 64
    e = modules.embed_init(g1, (512, 16), torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(e.float().std().item() - 0.02) < 0.002


def test_a_stacked_leaf_is_drawn_layer_by_layer_into_its_dtype():
    """A layer-stacked leaf is made in its dtype and drawn one layer at a
    time: the layers are the generator's successive draws of one layer, and
    the bf16 leaf is the f32 leaf cast, bit for bit."""
    shape = (3, 64, 32)
    f32 = modules.dense_init(torch.Generator().manual_seed(9), shape)
    bf16 = modules.dense_init(torch.Generator().manual_seed(9), shape, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16 and torch.equal(bf16, f32.to(torch.bfloat16))
    g = torch.Generator().manual_seed(9)
    layers = [torch.randn(shape[1:], generator=g) / 8 for _ in range(shape[0])]  # std 1/sqrt(64)
    assert torch.equal(f32, torch.stack(layers))
