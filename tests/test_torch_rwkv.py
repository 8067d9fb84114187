"""The port's RWKV-6 stack against the JAX package on converted weights: the
block (``rwkv6_apply``) with and without state, ``prefill`` and ``decode_step``
with the three state leaves, ``convert`` and ``cast_params``, and the serving
engines' greedy token ids, ragged batches included."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import rwkv as ref_rwkv
from repro.models.transformer import build_model as ref_build_model
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefServingEngine
from repro.serving.engine import SplitwiseCluster as RefSplitwiseCluster
from repro.serving.engine import zeros_cache as ref_zeros_cache
from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro_torch import configs, convert
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch.models import rwkv
from repro_torch.models.transformer import Model, RWKVModel, build_model
from repro_torch.serving.engine import (
    Request,
    ServingEngine,
    SplitwiseCluster,
    kv_cache_bytes_per_token,
    kv_cache_state_bytes_per_seq,
    zeros_cache,
)
from torch_helpers import as_f32, numpy_tree, reference_params, to_jax, to_torch

# f32: the same arithmetic summed in another order (the recurrence chunked by
# 32 in the reference, by cfg.rwkv.chunk in the port's plain version).
# bf16: activations round to bf16 at other places in the two frameworks.
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the smoke config has H = 2 and d_model = 128; a ring of either length would
# make the engine take a state leaf for a KV ring (ROADMAP queue 3)
B, T, MAX_LEN = 2, 12, 64


def _cfgs(dtype):
    jdt, tdt = _T[dtype]
    return (dataclasses.replace(ref_configs.get_smoke_config("rwkv6_7b"), dtype=jdt),
            dataclasses.replace(configs.get_smoke_config("rwkv6_7b"), dtype=tdt))


# -- the block ---------------------------------------------------------------


def _state_np(rng, cfg, Bn):
    d, hd = cfg.d_model, cfg.rwkv.head_dim
    return {"wkv": rng.standard_normal((Bn, d // hd, hd, hd), dtype=np.float32) * 0.3,
            "shift_t": rng.standard_normal((Bn, d), dtype=np.float32),
            "shift_c": rng.standard_normal((Bn, d), dtype=np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["no-state", "state", "state-T1"])
def test_rwkv6_apply_matches_reference(dtype, mode):
    ref_cfg, cfg = _cfgs(dtype)
    lp = numpy_tree(ref_rwkv.rwkv6_init(jax.random.PRNGKey(3), ref_cfg))
    # a nonzero bonus u and a spread of w0, so that both terms are exercised
    rng = np.random.default_rng(12)
    lp["u"] = rng.standard_normal(lp["u"].shape, dtype=np.float32) * 0.3
    lp["w0"] = (lp["w0"] + rng.standard_normal(lp["w0"].shape, dtype=np.float32) * 0.5).astype(np.float32)
    Tn = 1 if mode == "state-T1" else 20
    x = rng.standard_normal((B, Tn, cfg.d_model), dtype=np.float32)
    st = _state_np(rng, cfg, B) if mode != "no-state" else None

    ref_state = None if st is None else {
        "wkv": jnp.asarray(st["wkv"]), "shift_t": to_jax(st["shift_t"], dtype), "shift_c": to_jax(st["shift_c"], dtype)}
    out_ref, new_ref = ref_rwkv.rwkv6_apply({n: jnp.asarray(a) for n, a in lp.items()}, ref_cfg, to_jax(x, dtype), ref_state)
    state = None if st is None else {
        "wkv": torch.from_numpy(st["wkv"].copy()), "shift_t": to_torch(st["shift_t"], dtype),
        "shift_c": to_torch(st["shift_c"], dtype)}
    with torch.no_grad():
        out, new = rwkv.rwkv6_apply({n: torch.from_numpy(np.array(a)) for n, a in lp.items()}, cfg, to_torch(x, dtype), state)
    assert out.dtype == cfg.dtype and out.shape == (B, Tn, cfg.d_model)
    np.testing.assert_allclose(as_f32(out), as_f32(out_ref), **TOL[dtype])
    for name in ("wkv", "shift_t", "shift_c"):
        np.testing.assert_allclose(as_f32(new[name]), as_f32(new_ref[name]), **TOL[dtype], err_msg=name)
    if state is not None:
        assert new is state  # updated in place


# -- the model on converted weights -------------------------------------------


def _setup(dtype):
    ref_cfg, cfg = _cfgs(dtype)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    params = model.cast_params(convert.from_reference(tree, cfg))
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    return cfg, ref_model, ref_params, model, params, tokens


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def both(request):
    dtype = request.param
    cfg, ref_model, ref_params, model, params, tokens = _setup(dtype)
    ref_logits, ref_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                                              ref_zeros_cache(ref_model, B, MAX_LEN))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, zeros_cache(model, B, MAX_LEN, "cpu"))
    return dict(dtype=dtype, cfg=cfg, ref_model=ref_model, ref_params=ref_params, model=model, params=params,
                tokens=tokens, ref_logits=ref_logits, ref_cache=ref_cache, logits=logits, cache=cache)


def test_prefill_logits_match_reference(both):
    assert both["logits"].dtype == torch.float32 and both["logits"].shape == (B, both["cfg"].vocab_size)
    np.testing.assert_allclose(as_f32(both["logits"]), as_f32(both["ref_logits"]), **TOL[both["dtype"]])


def test_prefill_state_matches_reference(both):
    cache, ref_cache, cfg = both["cache"], both["ref_cache"], both["cfg"]
    assert set(cache) == set(ref_cache) == {"wkv", "shift_t", "shift_c"}
    for name in cache:
        assert tuple(cache[name].shape) == ref_cache[name].shape, name
        np.testing.assert_allclose(as_f32(cache[name]), as_f32(ref_cache[name]), **TOL[both["dtype"]], err_msg=name)
    assert cache["wkv"].dtype == torch.float32 and cache["shift_t"].dtype == cfg.dtype


def test_decode_step_matches_reference(both):
    nxt = np.asarray(both["ref_logits"]).argmax(-1).astype(np.int32)
    pos = np.full((B,), T, np.int32)
    ref_logits, ref_cache = both["ref_model"].decode_step(
        both["ref_params"], both["ref_cache"], jnp.asarray(nxt), jnp.asarray(pos))
    with torch.no_grad():
        cache = {k: v.clone() for k, v in both["cache"].items()}  # decode_step writes in place
        logits, out = both["model"].decode_step(both["params"], cache, torch.from_numpy(nxt), torch.from_numpy(pos))
    assert out is cache
    np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), **TOL[both["dtype"]])
    for name in cache:
        np.testing.assert_allclose(as_f32(cache[name]), as_f32(ref_cache[name]), **TOL[both["dtype"]], err_msg=name)
    assert not torch.equal(cache["wkv"], both["cache"]["wkv"])  # the step moved the state


def test_decode_matches_prefill():
    """Greedy decode at position T equals prefill over T+1 tokens (twin of
    tests/test_smoke_archs.py::test_decode_matches_prefill, f32 here)."""
    cfg, _, _, model, params, tokens = _setup("float32")
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, zeros_cache(model, B, MAX_LEN, "cpu"))
        nxt = logits.argmax(-1).to(torch.int32)
        dec, _ = model.decode_step(params, cache, nxt, torch.full((B,), T, dtype=torch.int32))
        full, _ = model.prefill(params, {"tokens": torch.cat([toks, nxt[:, None]], 1)},
                                zeros_cache(model, B, MAX_LEN, "cpu"))
    torch.testing.assert_close(dec, full, atol=1e-4, rtol=1e-4)


def test_cache_shape_mirrors_reference():
    ref_cfg, cfg = _cfgs("bfloat16")
    want = ref_build_model(ref_cfg).cache_shape(3, MAX_LEN)
    got = build_model(cfg).cache_shape(3, MAX_LEN)
    assert set(got) == set(want)
    for name, (shape, dtype) in got.items():
        assert shape == want[name].shape and str(dtype).replace("torch.", "") == jnp.dtype(want[name].dtype).name


def test_build_model_dispatches_on_rwkv():
    cfg = configs.get_smoke_config("rwkv6-7b")
    assert isinstance(build_model(cfg), RWKVModel)
    assert isinstance(build_model(configs.get_smoke_config("gpt-a")), Model)
    with pytest.raises(NotImplementedError):
        Model(cfg)


def test_cast_params_keeps_the_f32_leaves():
    cfg = configs.get_smoke_config("rwkv6_7b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    cast = model.cast_params(params)
    lay = cast["layers"]
    for name in ("ln_scale", "w0", "u"):
        assert lay[name].dtype == torch.float32 and lay[name] is params["layers"][name], name
    assert cast["final_norm"] is params["final_norm"] and cast["final_norm"].dtype == torch.float32
    for name in ("wr", "ck", "cv", "w_lora_a", "mu_r", "mu_ck"):
        assert lay[name].dtype == torch.bfloat16, name
    assert cast["embed"].dtype == cast["lm_head"].dtype == torch.bfloat16
    assert model.cast_params(cast)["layers"]["ck"] is lay["ck"]  # already cast: shared


# -- convert --------------------------------------------------------------------


def test_convert_keys_and_shapes_match_the_reference_checkpoint_paths():
    ref_cfg, cfg = ref_configs.get_smoke_config("rwkv6_7b"), configs.get_smoke_config("rwkv6_7b")
    ref_params, tree = reference_params(ref_cfg)
    ref_flat = ref_flatten(ref_params)
    flat = convert.flatten(convert.from_reference(tree, cfg))
    assert set(flat) == set(ref_flat) == set(convert.expected_shapes(cfg))
    for path, t in flat.items():
        assert tuple(t.shape) == ref_flat[path].shape == convert.expected_shapes(cfg)[path], path
    own = convert.flatten(build_model(cfg).init(torch.Generator().manual_seed(0)))
    assert {p: tuple(t.shape) for p, t in own.items()} == {p: tuple(t.shape) for p, t in flat.items()}
    assert {p: t.dtype for p, t in own.items()} == {p: t.dtype for p, t in flat.items()}


def test_convert_round_trip_is_exact():
    ref_cfg, cfg = ref_configs.get_smoke_config("rwkv6_7b"), configs.get_smoke_config("rwkv6_7b")
    _, tree = reference_params(ref_cfg, seed=3)
    back = convert.flatten(convert.to_reference(convert.from_reference(tree, cfg)))
    flat = convert.flatten(tree)
    assert set(back) == set(flat)
    for path in flat:
        assert back[path].dtype == flat[path].dtype
        np.testing.assert_array_equal(back[path], flat[path], err_msg=path)


def test_convert_bf16_params_keep_the_reference_f32_leaves():
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("rwkv6_7b"), param_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(configs.get_smoke_config("rwkv6_7b"), param_dtype=torch.bfloat16)
    ref_params, tree = reference_params(ref_cfg, seed=1)
    state = convert.flatten(convert.from_reference(tree, cfg))
    for path, leaf in ref_flatten(ref_params).items():
        want = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert state[path].dtype == want, path
    assert state["layers/u"].dtype == torch.float32 and state["layers/ck"].dtype == torch.bfloat16
    back = convert.flatten(convert.to_reference(convert.unflatten(state)))
    for path, leaf in convert.flatten(numpy_tree(ref_params)).items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)


# -- the serving engines ---------------------------------------------------------


@pytest.fixture(scope="module")
def twins():
    ref_cfg, cfg = _cfgs("float32")
    ref_params, tree = reference_params(ref_cfg, seed=0)
    return ref_cfg, ref_params, cfg, convert.from_reference(tree, cfg)


def _prompts(cfg):
    rng = np.random.default_rng(21)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 9, 5, 12)]


def test_greedy_token_ids_equal_the_reference_engine(twins):
    ref_cfg, ref_params, cfg, params = twins
    ref_engine = RefServingEngine(ref_cfg, ref_params, max_batch=3, max_len=MAX_LEN)
    engine = ServingEngine(cfg, params, max_batch=3, max_len=MAX_LEN, device="cpu")
    p = _prompts(cfg)
    rms0, wkv0 = rms_mod.launches, wkv_mod.launches
    for batch in ([p[0], p[1]], [p[2], p[3], p[0]], [p[3]]):  # equal lengths, ragged, single
        want = ref_engine.generate([RefRequest(i, x.copy(), max_new_tokens=6) for i, x in enumerate(batch)])
        got = engine.generate([Request(i, x.copy(), max_new_tokens=6) for i, x in enumerate(batch)])
        assert [r.generated for r in got] == [r.generated for r in want]
        assert all(r.ttft_ms > 0 and len(r.tbt_ms) == 5 for r in got)
    assert (rms_mod.launches, wkv_mod.launches) == (rms0, wkv0) == (0, 0)  # the CPU launches no kernel


def test_splitwise_equals_monolithic_and_moves_the_reference_state_bytes(twins):
    ref_cfg, ref_params, cfg, params = twins
    ref_cluster = RefSplitwiseCluster(ref_cfg, ref_params, max_batch=3, max_len=MAX_LEN)
    cluster = SplitwiseCluster(cfg, params, max_batch=3, max_len=MAX_LEN, device="cpu")
    engine = ServingEngine(cfg, params, max_batch=3, max_len=MAX_LEN, device="cpu")
    p = _prompts(cfg)
    for batch in ([p[0], p[1]], p[:3]):  # equal lengths, then ragged (one request at a time)
        want = ref_cluster.serve([RefRequest(i, x.copy(), max_new_tokens=5) for i, x in enumerate(batch)])
        got = cluster.serve([Request(i, x.copy(), max_new_tokens=5) for i, x in enumerate(batch)])
        mono = engine.generate([Request(i, x.copy(), max_new_tokens=5) for i, x in enumerate(batch)])
        assert [r.generated for r in got] == [r.generated for r in want] == [r.generated for r in mono]
    assert cluster.kv_bytes_moved == ref_cluster.kv_bytes_moved
    # per sequence: wkv L x H x D x D f32 (f32 config: shifts in f32 too), 5 sequences handed over
    d, hd, L = cfg.d_model, cfg.rwkv.head_dim, cfg.num_layers
    assert cluster.kv_bytes_moved == 5 * L * ((d // hd) * hd * hd * 4 + 2 * d * 4)


def test_state_bytes_of_the_full_config():
    """RWKV-6 7B hands 34,078,720 B a sequence from prefill to decode, whatever
    the prompt length: wkv 32 x 64 x 64 x 64 f32, two shifts 32 x 4096 bf16."""
    cfg = configs.get_config("rwkv6-7b")
    model = build_model(cfg)
    meta = {n: torch.empty(s, dtype=dt, device="meta") for n, (s, dt) in model.cache_shape(4, 1024).items()}
    assert kv_cache_state_bytes_per_seq(meta, 1024) == 34_078_720
    assert kv_cache_bytes_per_token(meta, 1024) == 0
    small = zeros_cache(build_model(configs.get_smoke_config("rwkv6_7b")), 2, MAX_LEN, "cpu")
    assert all((x == 0).all() for x in small.values())
