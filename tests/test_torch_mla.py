"""The port's MLA (``repro_torch.models.attention.mla_*``, DeepSeek-V2's
multi-head latent attention) against the reference's on converted weights:
without a cache, a prefill into the latent cache followed by three decode
steps (left-padded rows included), the cache's shapes, and what
``check_supported`` still refuses."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro_torch import configs, convert
from repro_torch.models import attention
from repro_torch.models.transformer import build_model
from torch_helpers import as_f32, reference_params

ARCH = "deepseek_v2_lite_16b"
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: the absorbed scores and the latent products in f32 in both, summed in
# another order.  bf16: the projections' outputs round to bf16 at other places
# in the two frameworks, then one rounding of the output: 2e-2.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
S = 24  # the ring


def _setup(dtype):
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH), dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), dtype=tdt)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    params = build_model(cfg).cast_params(convert.from_reference(tree, cfg))
    ref_p = jax.tree.map(lambda a: a[0], ref_params["layers"]["attn"])
    p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    return ref_cfg, cfg, ref_p, p


def _positions(B, T, pads):
    """(B, T) int32: row b left-padded with pads[b] slots at position -1."""
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    for b, n in enumerate(pads):
        pos[b, :n] = -1
        pos[b, n:] = np.arange(T - n)
    return pos


def _ref_cache(ref_cfg, B):
    return {k: jnp.full(s, -1, d) if d == jnp.int32 else jnp.zeros(s, d)
            for k, (s, d) in ref_attn.mla_cache_shape(ref_cfg, B, S).items()}


def _cache(cfg, B):
    return {k: torch.full(s, -1, dtype=d) if d == torch.int32 else torch.zeros(s, dtype=d)
            for k, (s, d) in attention.mla_cache_shape(cfg, B, S).items()}


def _check_cache(cache, ref_cache, dtype):
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    valid = cache["pos"].numpy() >= 0  # contents of empty slots are not compared
    for name in ("ckv", "k_rope"):
        np.testing.assert_allclose(as_f32(cache[name])[valid], as_f32(ref_cache[name])[valid], **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pads", [(0, 0), (0, 5)], ids=["dense", "left-padded"])
def test_mla_apply_without_cache_matches_reference(pads, dtype):
    ref_cfg, cfg, ref_p, p = _setup(dtype)
    B, T = 2, 12
    x = np.random.default_rng(1).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    pos = _positions(B, T, pads)
    with torch.no_grad():
        y, cache = attention.mla_apply(p, cfg, torch.from_numpy(x).to(_T[dtype][1]), torch.from_numpy(pos))
    ref_y, ref_cache = ref_attn.mla_apply(ref_p, ref_cfg, jnp.asarray(x, _T[dtype][0]), jnp.asarray(pos))
    assert cache is None and ref_cache is None and y.dtype == _T[dtype][1]
    np.testing.assert_allclose(as_f32(y), as_f32(ref_y), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pads", [(0, 0), (3, 0)], ids=["dense", "left-padded"])
def test_prefill_then_three_decode_steps_match_reference(pads, dtype):
    """A prefill of 10 tokens writes the latent ring (pads at position -1 land
    in slot S-1 and keep pos -1), then three single-token steps each write their
    slot first and attend over the ring; outputs and the valid slots agree."""
    ref_cfg, cfg, ref_p, p = _setup(dtype)
    jdt, tdt = _T[dtype]
    B, T = 2, 10
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    pos = _positions(B, T, pads)
    cache, ref_cache = _cache(cfg, B), _ref_cache(ref_cfg, B)
    with torch.no_grad():
        y, cache = attention.mla_apply(p, cfg, torch.from_numpy(x).to(tdt), torch.from_numpy(pos), cache)
    ref_y, ref_cache = ref_attn.mla_apply(ref_p, ref_cfg, jnp.asarray(x, jdt), jnp.asarray(pos), ref_cache)
    np.testing.assert_allclose(as_f32(y), as_f32(ref_y), **TOL[dtype])
    _check_cache(cache, ref_cache, dtype)
    if pads[0]:
        assert (cache["pos"][0, S - 1] == -1).all() and (cache["pos"][0] >= 0).sum() == T - pads[0]
    step_pos = pos[:, -1:] + 1
    for _ in range(3):
        xs = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        with torch.no_grad():
            y, cache = attention.mla_apply(p, cfg, torch.from_numpy(xs).to(tdt), torch.from_numpy(step_pos), cache)
        ref_y, ref_cache = ref_attn.mla_apply(ref_p, ref_cfg, jnp.asarray(xs, jdt), jnp.asarray(step_pos), ref_cache)
        np.testing.assert_allclose(as_f32(y), as_f32(ref_y), **TOL[dtype])
        _check_cache(cache, ref_cache, dtype)
        step_pos = step_pos + 1


def test_cache_is_written_in_place_and_returned():
    _, cfg, _, p = _setup("float32")
    cache = _cache(cfg, 1)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 3, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        _, out = attention.mla_apply(p, cfg, x, torch.arange(3, dtype=torch.int32)[None], cache)
    assert all(out[k] is cache[k] for k in cache)
    assert cache["pos"][0, :3].tolist() == [0, 1, 2] and (cache["pos"][0, 3:] == -1).all()


@pytest.mark.parametrize("B,max_len", [(1, 16), (3, 40)])
def test_cache_shape_mirrors_reference(B, max_len):
    cfg, ref_cfg = configs.get_config(ARCH), ref_configs.get_config(ARCH)
    got, want = attention.mla_cache_shape(cfg, B, max_len), ref_attn.mla_cache_shape(ref_cfg, B, max_len)
    assert set(got) == set(want) == {"ckv", "k_rope", "pos"}
    for k in got:
        assert got[k][0] == want[k][0]
        assert str(got[k][1]).replace("torch.", "") == jnp.dtype(want[k][1]).name
    # the latent ring of the full config: 576 values a token a layer, 31,104 bytes a token in bf16
    m = cfg.mla
    assert cfg.num_layers * (m.kv_lora_rank + m.qk_rope_head_dim) * 2 == 31_104


def test_check_supported_takes_mla_and_refuses_the_rest():
    """MLA takes a window (its ring is min(max_len, window), as the
    reference's); M-RoPE on MLA has no reference path and raises."""
    cfg = configs.get_smoke_config(ARCH)
    attention.check_supported(cfg)
    build_model(cfg)
    attention.check_supported(dataclasses.replace(cfg, window=16))
    with pytest.raises(NotImplementedError):
        attention.check_supported(dataclasses.replace(cfg, mrope_sections=(8, 4, 4)))


def test_repeated_slots_keep_the_last_write_as_the_reference():
    """Pads of a ragged row all write slot S-1, and a prompt longer than the
    ring writes some slots twice: the ring keeps the last write, as the
    reference's scatter does, and every repeated write carries that value, so
    the result cannot depend on the order a device applies them in."""
    ref_cfg, cfg, ref_p, p = _setup("float32")
    B, T = 2, 30  # row 0: 10 pads, then 20 tokens; row 1: 30 tokens into a ring of 24
    x = np.random.default_rng(6).standard_normal((B, T, cfg.d_model)).astype(np.float32)
    pos = _positions(B, T, (10, 0))
    slots = torch.remainder(torch.from_numpy(pos), S).long()
    src = attention._last_writer(slots, S)
    assert (src[0, :10] == 9).all() and (src[0, 10:] == torch.arange(10, T)).all()
    assert (src[1, :T - S] == torch.arange(S, T)).all() and (src[1, T - S:] == torch.arange(T - S, T)).all()
    assert (slots.gather(1, src) == slots).all()
    with torch.no_grad():
        y, cache = attention.mla_apply(p, cfg, torch.from_numpy(x), torch.from_numpy(pos), _cache(cfg, B))
    ref_y, ref_cache = ref_attn.mla_apply(ref_p, ref_cfg, jnp.asarray(x), jnp.asarray(pos), _ref_cache(ref_cfg, B))
    np.testing.assert_allclose(as_f32(y), as_f32(ref_y), **TOL["float32"])
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    assert sorted(cache["pos"][1].tolist()) == list(range(T - S, T)) and cache["pos"][0, S - 1] == -1
    for name in ("ckv", "k_rope"):  # slot S-1 of row 0 too: the pads' queries attend over it
        np.testing.assert_allclose(as_f32(cache[name]), as_f32(ref_cache[name]), **TOL["float32"])
