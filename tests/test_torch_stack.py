"""The rest of the transformer stack against the reference on converted
weights: the smoke configs of DeepSeek-Coder 33B, Granite-34B-Code (MQA),
Nemotron-4 15B (squared ReLU) and Qwen2-VL 7B (M-RoPE, text through the
default (3, B, T) positions): prefill logits, the cache on its valid slots,
decode steps, greedy token ids through both engines, the loss and its
gradients, and the conversion of each family's tree."""
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
from repro.serving.engine import zeros_cache as ref_zeros_cache
from repro_torch import configs, convert
from repro_torch.models.transformer import build_model
from repro_torch.serving.engine import Request, ServingEngine, SplitwiseCluster, zeros_cache
from torch_helpers import as_f32, numpy_tree, reference_params

DECODERS = ["deepseek_coder_33b", "granite_34b", "nemotron_4_15b", "qwen2_vl_7b"]
# as tests/test_torch_model.py: f32, two layers of f32 arithmetic in another
# order of summation; bf16, activations round at other places in the two
# frameworks, logits O(1)
LOGIT_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
# as tests/test_torch_loss.py: the loss a mean over many tokens; a gradient leaf relative in norm
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, T, MAX_LEN = 2, 12, 32


def _setup(arch, dtype):
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    return ref_cfg, cfg, ref_params, tree


@pytest.fixture(scope="module", params=[(a, d) for a in DECODERS for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def both(request):
    arch, dtype = request.param
    ref_cfg, cfg, ref_params, tree = _setup(arch, dtype)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    params = model.cast_params(convert.from_reference(tree, cfg))
    tokens = np.random.default_rng(11).integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    ref_logits, ref_cache = ref_model.prefill(ref_params, {"tokens": jnp.asarray(tokens)},
                                              ref_zeros_cache(ref_model, B, MAX_LEN))
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, zeros_cache(model, B, MAX_LEN, "cpu"))
    return dict(dtype=dtype, cfg=cfg, ref_model=ref_model, ref_params=ref_params, model=model, params=params,
                ref_logits=ref_logits, ref_cache=ref_cache, logits=logits, cache=cache)


def test_prefill_logits_and_cache_match_reference(both):
    cfg = both["cfg"]
    assert both["logits"].dtype == torch.float32 and both["logits"].shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(as_f32(both["logits"]), as_f32(both["ref_logits"]), **LOGIT_TOL[both["dtype"]])
    cache, ref_cache = both["cache"], both["ref_cache"]
    assert cache["k"].shape == (cfg.num_layers, B, MAX_LEN, cfg.num_kv_heads, cfg.resolved_head_dim)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
    valid = cache["pos"].numpy() >= 0
    assert valid.sum() == cfg.num_layers * B * T
    for name in ("k", "v"):  # contents of empty slots are not compared
        np.testing.assert_allclose(as_f32(cache[name])[valid], as_f32(ref_cache[name])[valid], **LOGIT_TOL[both["dtype"]])


def test_decode_steps_match_reference(both):
    """Three greedy decode steps from the prefill's cache (M-RoPE: pos broadcast to (3, B, 1))."""
    nxt = np.asarray(both["ref_logits"]).argmax(-1).astype(np.int32)
    ref_cache = both["ref_cache"]
    cache = {k: v.clone() for k, v in both["cache"].items()}  # decode_step writes in place
    for step in range(3):
        pos = np.full((B,), T + step, np.int32)
        ref_logits, ref_cache = both["ref_model"].decode_step(both["ref_params"], ref_cache, jnp.asarray(nxt),
                                                              jnp.asarray(pos))
        with torch.no_grad():
            logits, cache = both["model"].decode_step(both["params"], cache, torch.from_numpy(nxt), torch.from_numpy(pos))
        np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), **LOGIT_TOL[both["dtype"]])
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(ref_cache["pos"]))
        nxt = np.asarray(ref_logits).argmax(-1).astype(np.int32)


@pytest.fixture(scope="module", params=DECODERS)
def twins(request):
    ref_cfg, cfg, ref_params, tree = _setup(request.param, "float32")
    return ref_cfg, ref_params, cfg, convert.from_reference(tree, cfg)


def _prompts(cfg):
    rng = np.random.default_rng(21)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 9, 5, 12)]


def test_greedy_token_ids_equal_the_reference_engine(twins):
    """Dense, ragged and single batches, f32; Qwen2-VL's engine broadcasts the
    positions to (3, B, T), as the reference's does."""
    ref_cfg, ref_params, cfg, params = twins
    ref_engine = RefServingEngine(ref_cfg, ref_params, max_batch=3, max_len=64)
    engine = ServingEngine(cfg, params, max_batch=3, max_len=64, device="cpu")
    p = _prompts(cfg)
    for batch in ([p[0], p[1]], [p[2], p[3], p[0]], [p[3]]):
        want = ref_engine.generate([RefRequest(i, x.copy(), max_new_tokens=6) for i, x in enumerate(batch)])
        got = engine.generate([Request(i, x.copy(), max_new_tokens=6) for i, x in enumerate(batch)])
        assert [r.generated for r in got] == [r.generated for r in want]


def test_splitwise_token_ids_and_bytes_equal_the_reference_cluster(twins):
    ref_cfg, ref_params, cfg, params = twins
    ref_cluster = RefSplitwiseCluster(ref_cfg, ref_params, max_batch=3, max_len=64)
    cluster = SplitwiseCluster(cfg, params, max_batch=3, max_len=64, device="cpu")
    p = _prompts(cfg)
    for batch in (p[:2], p[1:4]):  # dense, then ragged
        want = ref_cluster.serve([RefRequest(i, x.copy(), max_new_tokens=5) for i, x in enumerate(batch)])
        got = cluster.serve([Request(i, x.copy(), max_new_tokens=5) for i, x in enumerate(batch)])
        assert [r.generated for r in got] == [r.generated for r in want]
    assert cluster.kv_bytes_moved == ref_cluster.kv_bytes_moved > 0


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODERS)
def test_loss_and_grads_match_reference(arch, dtype):
    """Next-token loss on tokens (the default positions; Qwen2-VL's text-only
    batch) and the gradient of every f32 leaf."""
    ref_cfg, cfg, ref_params, tree = _setup(arch, dtype)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    (ref_loss, _), ref_grads = jax.value_and_grad(ref_build_model(ref_cfg).loss, has_aux=True)(
        ref_params, {"tokens": jnp.asarray(tokens)})
    params = convert.from_reference(tree, cfg)
    flat = convert.flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, metrics = build_model(cfg).loss(params, {"tokens": torch.from_numpy(tokens)})
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_TOL[dtype], atol=LOSS_TOL[dtype])
    ref_flat = convert.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), ref_grads))
    assert set(grads) == set(ref_flat)
    for path, g in grads.items():
        assert g.dtype == torch.float32, path
        assert _rel(g.numpy(), ref_flat[path]) <= GRAD_TOL[dtype], (path, _rel(g.numpy(), ref_flat[path]))


@pytest.mark.parametrize("arch", DECODERS + ["hubert_xlarge"])
def test_conversion_matches_the_reference_checkpoint_paths_and_round_trips(arch):
    """Each family's tree (swiglu, relu2 and gelu FFNs; MQA's one kv head; the
    encoder's untied classifier head) under the reference's paths and shapes,
    the port's own initialiser making the same tree, and the way back exact,
    in f32 and in bf16 parameters."""
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    ref_params, tree = reference_params(ref_cfg, seed=3)
    ref_flat = ref_flatten(ref_params)
    flat = convert.flatten(convert.from_reference(tree, cfg))
    assert set(flat) == set(ref_flat) == set(convert.expected_shapes(cfg))
    assert ("layers/ffn/w_gate" in flat) == (cfg.ffn_activation == "swiglu") and "lm_head" in flat
    for path, t in flat.items():
        assert tuple(t.shape) == ref_flat[path].shape and t.dtype == torch.float32, path
    own = convert.flatten(build_model(cfg).init(torch.Generator().manual_seed(0)))
    assert {p: tuple(t.shape) for p, t in own.items()} == {p: tuple(t.shape) for p, t in flat.items()}
    back = convert.flatten(convert.to_reference(convert.unflatten(flat)))
    for path, leaf in convert.flatten(tree).items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)
    ref16 = dataclasses.replace(ref_cfg, param_dtype=jnp.bfloat16)
    cfg16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    ref_p16, tree16 = reference_params(ref16, seed=2)
    state = convert.flatten(convert.from_reference(tree16, cfg16))
    assert state["layers/attn/wq"].dtype == torch.bfloat16 and state["layers/ln1"].dtype == torch.float32
    back16 = convert.flatten(convert.to_reference(convert.unflatten(state)))
    for path, leaf in convert.flatten(numpy_tree(ref_p16)).items():
        np.testing.assert_array_equal(back16[path], leaf, err_msg=path)


@pytest.mark.parametrize("arch", DECODERS + ["hubert_xlarge"])
def test_full_configs_are_the_reference_configs(arch):
    """Field for field the reference's config (dtypes by name), the same
    parameter count; canon() takes the reference's CLI id."""
    ref_cli = {v: k for k, v in ref_configs.CLI_IDS.items()}[arch]
    assert configs.canon(ref_cli) == arch
    for get, ref_get in ((configs.get_config, ref_configs.get_config),
                         (configs.get_smoke_config, ref_configs.get_smoke_config)):
        cfg, ref = get(arch), ref_get(arch)
        for f in dataclasses.fields(ref):
            a, b = getattr(cfg, f.name), getattr(ref, f.name)
            if f.name in ("dtype", "param_dtype"):
                a, b = str(a).replace("torch.", ""), jnp.dtype(b).name
            assert a == b, (arch, f.name, a, b)
        assert cfg.param_count() == ref.param_count()
