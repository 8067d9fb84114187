"""The port's dense decoder against the reference on converted weights:
``prefill`` logits and cache, ``decode_step`` logits, for gpt_a and
minitron_4b smoke (GQA, relu2), in f32 and in bf16 as configured."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.transformer import build_model as ref_build_model
from repro.serving.engine import zeros_cache as ref_zeros_cache
from repro_torch import configs, convert
from repro_torch.models import attention
from repro_torch.models.transformer import HybridModel, SSMModel, build_model
from repro_torch.serving.engine import zeros_cache
from torch_helpers import as_f32, reference_params

# f32: two layers of f32 arithmetic in another order of summation.
# bf16: activations round to bf16 at other places in the two frameworks; logits are O(1).
LOGIT_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, T, MAX_LEN = 2, 12, 32


def _setup(arch, dtype):
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    params = model.cast_params(convert.from_reference(tree, cfg))
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    return cfg, ref_model, ref_params, model, params, tokens


@pytest.fixture(scope="module", params=[("gpt_a", "float32"), ("gpt_a", "bfloat16"),
                                        ("minitron_4b", "float32"), ("minitron_4b", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def both(request):
    arch, dtype = request.param
    cfg, ref_model, ref_params, model, params, tokens = _setup(arch, dtype)
    ref_logits, ref_cache = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tokens)}, ref_zeros_cache(ref_model, B, MAX_LEN))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, zeros_cache(model, B, MAX_LEN, "cpu"))
    return dict(dtype=dtype, cfg=cfg, ref_model=ref_model, ref_params=ref_params, model=model, params=params,
                tokens=tokens, ref_logits=ref_logits, ref_cache=ref_cache, logits=logits, cache=cache)


def test_prefill_logits_match_reference(both):
    assert both["logits"].dtype == torch.float32 and both["logits"].shape == (B, both["cfg"].vocab_size)
    np.testing.assert_allclose(as_f32(both["logits"]), as_f32(both["ref_logits"]), **LOGIT_TOL[both["dtype"]])


def test_prefill_cache_matches_reference_on_valid_slots(both):
    cache, ref_cache, cfg = both["cache"], both["ref_cache"], both["cfg"]
    assert cache["k"].shape == (cfg.num_layers, B, MAX_LEN, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert cache["k"].dtype == cfg.dtype and cache["pos"].dtype == torch.int32
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    valid = cache["pos"].numpy() >= 0
    assert valid.sum() == cfg.num_layers * B * T
    for name in ("k", "v"):  # contents of empty slots are not compared
        np.testing.assert_allclose(as_f32(cache[name])[valid], as_f32(ref_cache[name])[valid], **LOGIT_TOL[both["dtype"]])


def test_decode_step_logits_match_reference(both):
    nxt = np.asarray(both["ref_logits"]).argmax(-1).astype(np.int32)
    pos = np.full((B,), T, np.int32)
    ref_logits, ref_cache = both["ref_model"].decode_step(
        both["ref_params"], both["ref_cache"], jnp.asarray(nxt), jnp.asarray(pos))
    with torch.no_grad():
        cache = {k: v.clone() for k, v in both["cache"].items()}  # decode_step writes in place
        logits, cache = both["model"].decode_step(both["params"], cache, torch.from_numpy(nxt), torch.from_numpy(pos))
    np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), **LOGIT_TOL[both["dtype"]])
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    assert (cache["pos"][:, :, T] == T).all() and (both["cache"]["pos"][:, :, T] == -1).all()


@pytest.mark.parametrize("arch", ["gpt_a", "minitron_4b"])
def test_decode_after_shorter_prefill_matches_full_prefill(arch):
    """decode_step after prefill(T-1) sees what prefill(T) sees at its last token."""
    cfg, _, _, model, params, tokens = _setup(arch, "float32")
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        full, _ = model.prefill(params, {"tokens": toks}, zeros_cache(model, B, MAX_LEN, "cpu"))
        _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, zeros_cache(model, B, MAX_LEN, "cpu"))
        step, _ = model.decode_step(params, cache, toks[:, -1], torch.full((B,), T - 1, dtype=torch.int32))
    torch.testing.assert_close(step, full, atol=1e-4, rtol=1e-4)


def test_kernel_and_torch_impl_agree_on_the_cpu():
    """The impl switch changes the route, not the answer (f32, plain versions)."""
    cfg, _, _, model, params, tokens = _setup("minitron_4b", "float32")
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        a, _ = model.prefill(params, {"tokens": toks}, zeros_cache(model, B, MAX_LEN, "cpu"))
        with attention.force_impl("torch"):
            b, _ = model.prefill(params, {"tokens": toks}, zeros_cache(model, B, MAX_LEN, "cpu"))
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_prefill_longer_than_the_ring_keeps_the_last_slots():
    """A prompt longer than the ring attends over all of itself and leaves the
    last S tokens in the ring, as the reference does."""
    cfg, ref_model, ref_params, model, params, tokens = _setup("gpt_a", "float32")
    S = 8
    ref_logits, ref_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)}, ref_zeros_cache(ref_model, B, S))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, zeros_cache(model, B, S, "cpu"))
    np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    assert sorted(cache["pos"][0, 0].tolist()) == list(range(T - S, T))
    np.testing.assert_allclose(as_f32(cache["k"]), as_f32(ref_cache["k"]), atol=1e-4, rtol=1e-4)


def test_cast_params_shares_leaves_already_cast():
    cfg = configs.get_smoke_config("gpt_a")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cast = model.cast_params(params)
    assert cast["layers"]["attn"]["wq"].dtype == torch.bfloat16 and cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["ln1"] is params["layers"]["ln1"] and cast["final_norm"].dtype == torch.float32
    again = model.cast_params(cast)
    assert again["layers"]["ffn"]["w_up"] is cast["layers"]["ffn"]["w_up"]


def test_unported_families_raise():
    """Every family of the reference is ported: Mamba2 and the hybrid stack
    (Zamba2) build (tests/test_torch_hybrid.py), as do the bidirectional
    encoder and the window (tests/test_torch_encoder.py, test_torch_window.py).
    What still raises is a config no family can run: the MoE family without its
    MoEConfig, and a Mamba2 or hybrid family without its SSMConfig."""
    cfg = configs.get_smoke_config("gpt_a")
    zamba = configs.get_smoke_config("zamba2_2p7b")
    assert type(build_model(zamba)) is HybridModel
    assert type(build_model(dataclasses.replace(zamba, family="ssm"))) is SSMModel
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, family="moe"))
    for change in (dict(family="ssm"), dict(family="hybrid")):
        with pytest.raises(ValueError, match="not a Mamba2 config"):
            build_model(dataclasses.replace(cfg, **change))
    for change in (dict(causal=False), dict(window=16)):
        build_model(dataclasses.replace(cfg, **change))


# -- the MoE family: Qwen1.5-MoE (GQA) and DeepSeek-V2-Lite (MLA) ---------------

MOE_ARCHS = ["qwen2_moe_a2p7b", "deepseek_v2_lite_16b"]


@pytest.fixture(scope="module", params=[(a, d) for a in MOE_ARCHS for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def moe_both(request):
    arch, dtype = request.param
    cfg, ref_model, ref_params, model, params, tokens = _setup(arch, dtype)
    ref_logits, ref_cache = ref_model.prefill(
        ref_params, {"tokens": jnp.asarray(tokens)}, ref_zeros_cache(ref_model, B, MAX_LEN))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, zeros_cache(model, B, MAX_LEN, "cpu"))
    return dict(dtype=dtype, cfg=cfg, ref_model=ref_model, ref_params=ref_params, model=model, params=params,
                tokens=tokens, ref_logits=ref_logits, ref_cache=ref_cache, logits=logits, cache=cache)


def test_moe_prefill_logits_and_cache_match_reference(moe_both):
    """Logits, and every floating-point leaf of the cache (k, v or MLA's ckv,
    k_rope) on the valid slots."""
    b = moe_both
    np.testing.assert_allclose(as_f32(b["logits"]), as_f32(b["ref_logits"]), **LOGIT_TOL[b["dtype"]])
    assert set(b["cache"]) == set(b["ref_cache"])
    np.testing.assert_array_equal(b["cache"]["pos"].numpy(), np.asarray(b["ref_cache"]["pos"]))
    valid = b["cache"]["pos"].numpy() >= 0
    assert valid.sum() == b["cfg"].num_layers * B * T
    for name in set(b["cache"]) - {"pos"}:
        assert tuple(b["cache"][name].shape) == b["ref_cache"][name].shape and b["cache"][name].dtype == b["cfg"].dtype
        np.testing.assert_allclose(as_f32(b["cache"][name])[valid], as_f32(b["ref_cache"][name])[valid],
                                   **LOGIT_TOL[b["dtype"]])


def test_moe_decode_steps_match_reference(moe_both):
    """Three greedy decode steps from the prefill's cache (a decode step's
    capacity is 8 slots an expert)."""
    b = moe_both
    nxt = np.asarray(b["ref_logits"]).argmax(-1).astype(np.int32)
    ref_cache = b["ref_cache"]
    cache = {k: v.clone() for k, v in b["cache"].items()}  # decode_step writes in place
    for step in range(3):
        pos = np.full((B,), T + step, np.int32)
        ref_logits, ref_cache = b["ref_model"].decode_step(b["ref_params"], ref_cache, jnp.asarray(nxt), jnp.asarray(pos))
        with torch.no_grad():
            logits, cache = b["model"].decode_step(b["params"], cache, torch.from_numpy(nxt), torch.from_numpy(pos))
        np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), **LOGIT_TOL[b["dtype"]])
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
        nxt = np.asarray(ref_logits).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_after_shorter_prefill_parts_from_full_prefill_as_the_reference(arch):
    """For the dense decoder, decode_step after prefill(T-1) sees what prefill(T)
    sees at its last token.  For the MoE it does not, in the reference as in the
    port: the reference weights each expert slot with the gate of whichever
    (token, k) pair the sort put there (ROADMAP Queue 3 (e)), so a token's
    output depends on the other tokens it was sorted with.  Both numbers of
    each package agree with the other package's."""
    cfg, ref_model, ref_params, model, params, tokens = _setup(arch, "float32")
    toks = torch.from_numpy(tokens)
    ref_full, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)}, ref_zeros_cache(ref_model, B, MAX_LEN))
    _, ref_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens[:, :-1])}, ref_zeros_cache(ref_model, B, MAX_LEN))
    ref_step, _ = ref_model.decode_step(ref_params, ref_cache, jnp.asarray(tokens[:, -1]), jnp.full((B,), T - 1, jnp.int32))
    with torch.no_grad():
        full, _ = model.prefill(params, {"tokens": toks}, zeros_cache(model, B, MAX_LEN, "cpu"))
        _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, zeros_cache(model, B, MAX_LEN, "cpu"))
        step, _ = model.decode_step(params, cache, toks[:, -1], torch.full((B,), T - 1, dtype=torch.int32))
    np.testing.assert_allclose(as_f32(full), as_f32(ref_full), **LOGIT_TOL["float32"])
    np.testing.assert_allclose(as_f32(step), as_f32(ref_step), **LOGIT_TOL["float32"])
    ref_gap = np.abs(as_f32(ref_step) - as_f32(ref_full)).max()
    assert ref_gap > 1e-2 and np.abs(as_f32(step) - as_f32(full)).max() > 1e-2, ref_gap


@pytest.mark.parametrize("arch", MOE_ARCHS + ["gpt_a", "deepseek_coder_33b", "granite_34b", "nemotron_4_15b",
                                  "qwen2_vl_7b", "hubert_xlarge"])
def test_init_in_the_activation_dtype_is_the_cast_f32_init(arch):
    """``init(gen, dtype=cfg.dtype)`` gives bit for bit ``cast_params(init(gen))``
    from the same seed: each leaf is drawn in f32 and cast as it is made.  The
    norm scales and the MoE router are f32 in both, MLA's up-projections in
    ``cfg.param_dtype``."""
    cfg = configs.get_smoke_config(arch)
    model = build_model(cfg)
    direct = convert.flatten(model.init(torch.Generator().manual_seed(5), dtype=cfg.dtype))
    cast = convert.flatten(model.cast_params(model.init(torch.Generator().manual_seed(5))))
    assert set(direct) == set(cast)
    for path, t in direct.items():
        assert t.dtype == cast[path].dtype and torch.equal(t, cast[path]), path
        leaf = path.split("/")[-1]
        want = torch.float32 if leaf in ("ln1", "ln2", "final_norm", "router", "w_uk", "w_uv") else cfg.dtype
        assert t.dtype == want, path


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cast_params_keeps_the_f32_leaves(arch):
    """The router is contracted in f32 and MLA's up-projections are applied in
    f32 by the reference, so the computing copy shares them uncast."""
    cfg = configs.get_smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cast = model.cast_params(params)
    assert cast["layers"]["moe"]["router"] is params["layers"]["moe"]["router"]
    assert cast["layers"]["moe"]["router"].dtype == torch.float32
    assert cast["layers"]["moe"]["w_gate"].dtype == cfg.dtype
    if cfg.mla is not None:
        assert cast["layers"]["attn"]["w_uk"] is params["layers"]["attn"]["w_uk"]
        assert cast["layers"]["attn"]["w_dkv"].dtype == cfg.dtype


def test_moe_family_needs_its_moe_config():
    cfg = configs.get_smoke_config("qwen2_moe_a2p7b")
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, moe=None))
    with pytest.raises(NotImplementedError):
        build_model(dataclasses.replace(cfg, family="dense"))
