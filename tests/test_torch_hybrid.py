"""The port's Zamba2 hybrid stack (``HybridModel``) and pure Mamba2 stack
(``SSMModel``) against the JAX package on converted weights of
``zamba2-smoke`` and of an ``ssm`` config made from it: the configs,
``prefill`` (logits and the cache), three decode steps, the serving engines'
token ids, ragged batches served one request at a time, the handed-off bytes,
``loss`` and its gradients, the gate, and ``convert``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro.models.transformer import build_model as ref_build_model
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefServingEngine
from repro.serving.engine import SplitwiseCluster as RefSplitwiseCluster
from repro.serving.engine import kv_cache_bytes_per_token as ref_bytes_per_token
from repro.serving.engine import kv_cache_state_bytes_per_seq as ref_state_bytes_per_seq
from repro.serving.engine import zeros_cache as ref_zeros_cache
from repro_torch import configs, convert
from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.models.modules import dense, rmsnorm
from repro_torch.models.transformer import HybridModel, Model, SSMModel, build_model
from repro_torch.serving.engine import (
    Request,
    ServingEngine,
    SplitwiseCluster,
    _is_ring_leaf,
    kv_cache_bytes_per_token,
    kv_cache_state_bytes_per_seq,
    zeros_cache,
)
from test_torch_modules import _same_config
from torch_helpers import as_f32, reference_params

# f32: the same arithmetic summed in another order, through the stack.
# bf16: activations round to bf16 at other places in the two frameworks.
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# an f32 recurrent state is held relative to its largest entry
STATE_REL = 1e-4
# bf16 cache leaves are held against a control: the reference's own bf16 cache
# against its f32 cache on the same weights and tokens.  Each Mamba2 layer's
# bf16 roundings (XLA's fused scan body rounds at other places than torch's
# operations) reach the next layers' inputs, and the states and convolution
# inputs of the deeper layers part by up to 0.14 at values of 1 (18 bf16 ulps)
# though the logits stay within 5e-2; the port may part from the reference by
# at most twice what the reference's bf16 parts from its f32, plus 5e-2.
CONTROL_SLACK = 5e-2
# The pure Mamba2 stack's bf16 logits are held so too: with no attention block
# between its four layers the roundings reach the logits, and on the second
# decode step the port parts from the reference by 0.088 where the reference's
# bf16 parts from its f32 by 0.056.  Zamba2-smoke's bf16 logits keep 5e-2.
CONTROLLED_LOGITS = ("ssm",)
# the loss is a mean over many tokens; a gradient leaf in norm (f32 only)
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = 1e-4
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the smoke cache has M = 1 Mamba layer a group and 8 SSD heads: a ring of 64 is
# neither a batch nor a head count, so no state leaf is taken for a ring (ROADMAP
# Queue 3 (b))
B, T, MAX_LEN = 2, 40, 64
FAMILIES = ["hybrid", "ssm"]


def _cfgs(dtype, family="hybrid"):
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("zamba2_2p7b"), dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config("zamba2_2p7b"), dtype=tdt)
    if family == "ssm":
        ref_cfg, cfg = dataclasses.replace(ref_cfg, family="ssm"), dataclasses.replace(cfg, family="ssm")
    return ref_cfg, cfg


def _setup(dtype, family="hybrid", seed=0):
    ref_cfg, cfg = _cfgs(dtype, family)
    ref_params, tree = reference_params(ref_cfg, seed=seed)
    model = build_model(cfg)
    params = model.cast_params(convert.from_reference(tree, cfg))
    return ref_cfg, cfg, ref_build_model(ref_cfg), ref_params, model, params


def _ref_cache_flat(ref_cache):
    """The reference's nested cache as the port's flat names."""
    return {k: np.asarray(v, np.float32) if v.dtype != jnp.int32 else np.asarray(v)
            for k, v in convert.flatten(ref_cache).items()}


def _check_logits(logits, ref_logits, ctl_logits, dtype, family, what=""):
    got, want = as_f32(logits), as_f32(ref_logits)
    if dtype == "bfloat16" and family in CONTROLLED_LOGITS:
        gap, ctl_gap = np.abs(got - want).max(), np.abs(want - as_f32(ctl_logits)).max()
        assert gap <= 2 * ctl_gap + CONTROL_SLACK, (what, gap, ctl_gap)
    else:
        np.testing.assert_allclose(got, want, **TOL[dtype], err_msg=what)


def _check_cache(cache, ref_cache, dtype, control=None):
    """Every Mamba state leaf; the attention ring only where a token wrote it.
    In bf16 against ``control``, the reference's f32 cache (CONTROL_SLACK)."""
    ref = _ref_cache_flat(ref_cache)
    assert set(cache) == set(ref)
    for name, x in cache.items():
        assert tuple(x.shape) == ref[name].shape, name
    valid = np.ones(ref[next(iter(ref))].shape, bool)
    if "attn/pos" in cache:
        np.testing.assert_array_equal(cache["attn/pos"].numpy(), ref["attn/pos"])
        valid = cache["attn/pos"].numpy() >= 0
    for name in [n for n in cache if not n.endswith("pos")]:
        got, want = as_f32(cache[name]), ref[name]
        if name.startswith("attn/"):
            got, want = got[valid], want[valid]
        if dtype == "bfloat16":
            ctl = _ref_cache_flat(control)[name]
            ctl = ctl[valid] if name.startswith("attn/") else ctl
            gap, ctl_gap = np.abs(got - want).max(), np.abs(want - ctl).max()
            assert gap <= 2 * ctl_gap + CONTROL_SLACK, (name, gap, ctl_gap)
        elif name.endswith("ssm"):
            np.testing.assert_allclose(got, want, rtol=STATE_REL, atol=STATE_REL * np.abs(want).max(), err_msg=name)
        else:
            np.testing.assert_allclose(got, want, **TOL[dtype], err_msg=name)


# -- configs and model objects -------------------------------------------------


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_config_mirrors_reference(size):
    get, ref_get = ((configs.get_config, ref_configs.get_config) if size == "full"
                    else (configs.get_smoke_config, ref_configs.get_smoke_config))
    cfg, ref_cfg = get("zamba2-2.7b"), ref_get("zamba2-2.7b")
    _same_config(cfg, ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()
    if size == "full":
        assert cfg.param_count() == 2_052_915_200 and cfg.resolved_head_dim == 80


def test_build_model_dispatches_ssm_and_hybrid():
    _, hybrid = _cfgs("float32", "hybrid")
    _, pure = _cfgs("float32", "ssm")
    assert type(build_model(hybrid)) is HybridModel and type(build_model(pure)) is SSMModel
    with pytest.raises(NotImplementedError):
        Model(hybrid)
    with pytest.raises(ValueError):  # a Mamba2 stack needs its SSMConfig
        SSMModel(dataclasses.replace(pure, ssm=None))
    with pytest.raises(ValueError):  # the hybrid's layers come in whole groups
        HybridModel(dataclasses.replace(hybrid, num_layers=5))


@pytest.mark.parametrize("family", FAMILIES)
def test_cache_shape_mirrors_reference(family):
    ref_cfg, cfg = _cfgs("bfloat16", family)
    want = convert.flatten(ref_build_model(ref_cfg).cache_shape(3, MAX_LEN))
    got = build_model(cfg).cache_shape(3, MAX_LEN)
    assert set(got) == set(want)
    for name, (shape, dtype) in got.items():
        assert shape == want[name].shape and str(dtype).replace("torch.", "") == jnp.dtype(want[name].dtype).name


@pytest.mark.parametrize("family", FAMILIES)
def test_cast_params_keeps_the_f32_leaves(family):
    _, cfg = _cfgs("bfloat16", family)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    flat, cast = convert.flatten(params), convert.flatten(model.cast_params(params))
    for path, t in cast.items():
        keep = path.split("/")[-1] in ("ln", "ln1", "ln2", "final_norm", "norm_scale", "A_log", "D", "dt_bias", "gate")
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), path
        assert (t is flat[path]) == keep, path
    made = convert.flatten(model.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16))
    assert all(torch.equal(made[p], cast[p]) and made[p].dtype == cast[p].dtype for p in cast)


# -- the model on converted weights --------------------------------------------------


@pytest.fixture(scope="module", params=[(f, d) for f in FAMILIES for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def both(request):
    family, dtype = request.param
    ref_cfg, cfg, ref_model, ref_params, model, params = _setup(dtype, family)
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    ref_logits, ref_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                                              ref_zeros_cache(ref_model, B, MAX_LEN))
    # the control of a bf16 run: the reference in f32 on the same weights
    ref32 = ref_build_model(_cfgs("float32", family)[0])
    ctl_logits, ctl_cache = ref32.prefill(ref_params, {"tokens": jnp.asarray(tokens)}, ref_zeros_cache(ref32, B, MAX_LEN))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, zeros_cache(model, B, MAX_LEN, "cpu"))
    return dict(dtype=dtype, family=family, cfg=cfg, ref_model=ref_model, ref_params=ref_params, model=model, params=params,
                tokens=tokens, ref_logits=ref_logits, ref_cache=ref_cache, logits=logits, cache=cache,
                ref32=ref32, ctl_logits=ctl_logits, ctl_cache=ctl_cache)


def test_prefill_logits_match_reference(both):
    assert both["logits"].dtype == torch.float32 and both["logits"].shape == (B, both["cfg"].vocab_size)
    _check_logits(both["logits"], both["ref_logits"], both["ctl_logits"], both["dtype"], both["family"])


def test_prefill_cache_matches_reference(both):
    _check_cache(both["cache"], both["ref_cache"], both["dtype"], both["ctl_cache"])
    for name, x in both["cache"].items():
        if name.endswith("ssm"):
            assert x.dtype == torch.float32
        elif not name.endswith("pos"):
            assert x.dtype == both["cfg"].dtype, name


def test_three_decode_steps_match_reference(both):
    cache = {k: v.clone() for k, v in both["cache"].items()}  # decode_step writes in place
    ref_cache, ref_logits, ctl_cache = both["ref_cache"], both["ref_logits"], both["ctl_cache"]
    for step in range(3):
        nxt = np.asarray(ref_logits).argmax(-1).astype(np.int32)
        pos = np.full((B,), T + step, np.int32)
        ref_logits, ref_cache = both["ref_model"].decode_step(both["ref_params"], ref_cache, jnp.asarray(nxt),
                                                              jnp.asarray(pos))
        ctl_logits, ctl_cache = both["ref32"].decode_step(both["ref_params"], ctl_cache, jnp.asarray(nxt),
                                                          jnp.asarray(pos))
        with torch.no_grad():
            logits, out = both["model"].decode_step(both["params"], cache, torch.from_numpy(nxt), torch.from_numpy(pos))
        assert out is cache
        _check_logits(logits, ref_logits, ctl_logits, both["dtype"], both["family"], f"step {step}")
        _check_cache(cache, ref_cache, both["dtype"], ctl_cache)


def test_decode_matches_prefill():
    """Greedy decode at position T equals prefill over T+1 tokens (f32)."""
    _, cfg, _, _, model, params = _setup("float32")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, zeros_cache(model, B, MAX_LEN, "cpu"))
        nxt = logits.argmax(-1).to(torch.int32)
        dec, _ = model.decode_step(params, cache, nxt, torch.full((B,), T, dtype=torch.int32))
        full, _ = model.prefill(params, {"tokens": torch.cat([toks, nxt[:, None]], 1)},
                                zeros_cache(model, B, MAX_LEN, "cpu"))
    torch.testing.assert_close(dec, full, atol=1e-4, rtol=1e-4)


def test_prefill_ignores_the_batch_positions():
    """As the reference (``_build_hybrid``'s prefill): positions 0..T-1 whatever
    the batch holds."""
    _, cfg, _, _, model, params = _setup("float32")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, size=(B, 12)).astype(np.int32))
    with torch.no_grad():
        a, ca = model.prefill(params, {"tokens": toks}, zeros_cache(model, B, MAX_LEN, "cpu"))
        b, cb = model.prefill(params, {"tokens": toks, "positions": torch.full((B, 12), -1, dtype=torch.int32)},
                              zeros_cache(model, B, MAX_LEN, "cpu"))
    assert torch.equal(a, b) and all(torch.equal(ca[n], cb[n]) for n in ca)


def test_a_gate_of_zero_makes_the_shared_block_the_identity():
    """With every gate 0 the shared block adds exactly nothing: the hybrid's
    logits are those of its Mamba layers alone, bit for bit; a gate of 0 in one
    group changes the output."""
    _, cfg, _, _, model, params = _setup("float32")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, size=(B, 12)).astype(np.int32))
    G, M = model.groups, model.m_per
    off = {**params, "groups": {**params["groups"], "gate": torch.zeros(G)}}
    one_off = {**params, "groups": {**params["groups"], "gate": torch.tensor([1.0] * (G - 1) + [0.0])}}
    with torch.no_grad():
        gated, _ = model.prefill(off, {"tokens": toks}, None)
        full, _ = model.prefill(params, {"tokens": toks}, None)
        partial, _ = model.prefill(one_off, {"tokens": toks}, None)
        x = params["embed"][toks.long()]
        for g in range(G):
            for m in range(M):
                lp = {"ln": params["groups"]["mamba"]["ln"][g, m],
                      "mamba": {k: v[g, m] for k, v in params["groups"]["mamba"]["mamba"].items()}}
                x = model._mamba(lp, x, None)
        mamba_only = dense(params["lm_head"], rmsnorm(params["final_norm"], x)[:, -1]).float()
    assert torch.equal(gated, mamba_only)
    assert not torch.equal(full, gated) and not torch.equal(partial, full)


# -- loss and gradients ------------------------------------------------------------


def _port_value_and_grad(cfg, tree, tokens):
    params = convert.from_reference(tree, cfg)
    flat = convert.flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, metrics = build_model(cfg).loss(params, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, metrics, dict(zip(flat, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_grads_match_reference(family, dtype):
    ref_cfg, cfg = _cfgs(dtype, family)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 45)).astype(np.int32)
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(ref_build_model(ref_cfg).loss, has_aux=True)(
        ref_params, {"tokens": jnp.asarray(tokens)})
    loss, metrics, grads = _port_value_and_grad(cfg, tree, tokens)
    assert loss.dtype == torch.float32 and set(metrics) == {"ce"}
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_TOL[dtype], atol=LOSS_TOL[dtype])
    ref_flat = convert.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), ref_grads))
    assert set(grads) == set(ref_flat)
    for path, g in grads.items():
        assert g.dtype == torch.float32, path  # f32 gradients on the f32 master leaves
        if dtype == "float32":
            want = ref_flat[path]
            rel = float(np.linalg.norm(g.numpy() - want) / max(np.linalg.norm(want), 1e-30))
            assert rel <= GRAD_TOL, (path, rel)


# -- the serving engines -----------------------------------------------------------


@pytest.fixture(scope="module", params=FAMILIES)
def twins(request):
    ref_cfg, cfg = _cfgs("float32", request.param)
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
    counts = (rms_mod.launches, fa_mod.launches, dec_mod.launches)
    for batch in ([p[0], p[1]], [p[2], p[3], p[0]], [p[3]]):  # equal lengths, ragged, single
        want = ref_engine.generate([RefRequest(i, x.copy(), max_new_tokens=6) for i, x in enumerate(batch)])
        got = engine.generate([Request(i, x.copy(), max_new_tokens=6) for i, x in enumerate(batch)])
        assert [r.generated for r in got] == [r.generated for r in want]
        assert all(r.ttft_ms > 0 and len(r.tbt_ms) == 5 for r in got)
    assert (rms_mod.launches, fa_mod.launches, dec_mod.launches) == counts == (0, 0, 0)  # the CPU launches no kernel


def test_a_ragged_batch_equals_each_request_alone(twins):
    """The engine serves a recurrent family's ragged batch one request at a
    time: each request's tokens are those it gets alone."""
    _, _, cfg, params = twins
    engine = ServingEngine(cfg, params, max_batch=3, max_len=MAX_LEN, device="cpu")
    p = _prompts(cfg)
    together = engine.generate([Request(i, x.copy(), max_new_tokens=5) for i, x in enumerate(p[1:])])
    alone = [engine.generate([Request(i, x.copy(), max_new_tokens=5)])[0] for i, x in enumerate(p[1:])]
    assert [r.generated for r in together] == [r.generated for r in alone]


def test_splitwise_equals_monolithic_and_moves_the_reference_bytes(twins):
    ref_cfg, ref_params, cfg, params = twins
    ref_cluster = RefSplitwiseCluster(ref_cfg, ref_params, max_batch=3, max_len=MAX_LEN)
    cluster = SplitwiseCluster(cfg, params, max_batch=3, max_len=MAX_LEN, device="cpu")
    engine = ServingEngine(cfg, params, max_batch=3, max_len=MAX_LEN, device="cpu")
    p = _prompts(cfg)
    for batch in ([p[0], p[1]], p[:3], [p[3]]):  # equal lengths, ragged (one request at a time), single
        want = ref_cluster.serve([RefRequest(i, x.copy(), max_new_tokens=5) for i, x in enumerate(batch)])
        got = cluster.serve([Request(i, x.copy(), max_new_tokens=5) for i, x in enumerate(batch)])
        mono = engine.generate([Request(i, x.copy(), max_new_tokens=5) for i, x in enumerate(batch)])
        assert [r.generated for r in got] == [r.generated for r in want] == [r.generated for r in mono]
    assert cluster.kv_bytes_moved == ref_cluster.kv_bytes_moved


@pytest.mark.parametrize("batch", [1, 2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_byte_counts_equal_the_reference_at_every_batch(family, batch):
    """Both byte counts of a cache of ``batch`` rows, the reference's and the
    port's, leaf by leaf (ROADMAP Queue 3 (h): the hybrid's per-sequence state
    is counted over M, not B, in both)."""
    ref_cfg, cfg = _cfgs("bfloat16", family)
    ref_cache = ref_zeros_cache(ref_build_model(ref_cfg), batch, MAX_LEN)
    cache = zeros_cache(build_model(cfg), batch, MAX_LEN, "cpu")
    assert kv_cache_bytes_per_token(cache, MAX_LEN) == ref_bytes_per_token(ref_cache, MAX_LEN)
    assert kv_cache_state_bytes_per_seq(cache, MAX_LEN) == ref_state_bytes_per_seq(ref_cache, MAX_LEN)
    ring = {n for n, x in cache.items() if _is_ring_leaf(x, MAX_LEN)}
    assert ring == ({"attn/k", "attn/v", "attn/pos"} if family == "hybrid" else set())


def test_byte_counts_of_the_full_config():
    """Zamba2-2.7B: a token is 92,160 B (9 x 2 x 32 x 80 x 2); a sequence's
    state is 60,399,360 B (45 x (80 x 64 x 64 x 4 + 3 x 5120 x 2 + 3 x 128 x 2)),
    which the count, as the reference's, gives as B x 60,399,360 / 5."""
    model = build_model(configs.get_config("zamba2-2.7b"))
    for batch in (1, 2, 4):
        meta = {n: torch.empty(s, dtype=dt, device="meta") for n, (s, dt) in model.cache_shape(batch, 1024).items()}
        assert kv_cache_bytes_per_token(meta, 1024) == 92_160
        assert kv_cache_state_bytes_per_seq(meta, 1024) == batch * 60_399_360 / 5
        true = sum(x.numel() * x.element_size() for n, x in meta.items() if n.startswith("mamba/")) / batch
        assert true == 60_399_360


# -- convert ----------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_convert_keys_and_shapes_match_the_reference_checkpoint_paths(family):
    ref_cfg, cfg = _cfgs("float32", family)
    ref_params, tree = reference_params(ref_cfg)
    ref_flat = ref_flatten(ref_params)
    flat = convert.flatten(convert.from_reference(tree, cfg))
    assert set(flat) == set(ref_flat) == set(convert.expected_shapes(cfg))
    for path, t in flat.items():
        assert tuple(t.shape) == ref_flat[path].shape == convert.expected_shapes(cfg)[path], path
    own = convert.flatten(build_model(cfg).init(torch.Generator().manual_seed(0)))
    assert {p: tuple(t.shape) for p, t in own.items()} == {p: tuple(t.shape) for p, t in flat.items()}
    assert {p: t.dtype for p, t in own.items()} == {p: t.dtype for p, t in flat.items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_convert_bf16_round_trip_keeps_the_f32_leaves(family):
    ref_cfg, cfg = _cfgs("float32", family)
    ref_cfg = dataclasses.replace(ref_cfg, param_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    ref_params, tree = reference_params(ref_cfg, seed=1)
    state = convert.flatten(convert.from_reference(tree, cfg))
    for path, leaf in ref_flatten(ref_params).items():
        assert state[path].dtype == (torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16), path
    back = convert.flatten(convert.to_reference(convert.unflatten(state)))
    for path, leaf in convert.flatten(tree).items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)
