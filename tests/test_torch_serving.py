"""``repro_torch.serving.engine``: a twin of every tier-1 test of
``tests/test_serving_engine.py``, and the greedy token ids held against the
reference engine's on converted weights."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefServingEngine
from repro.serving.engine import SplitwiseCluster as RefSplitwiseCluster
from repro_torch import configs, convert
from repro_torch.kernels import decode_attention as dec_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.models import attention
from repro_torch.models.transformer import build_model
from repro_torch.serving.engine import (
    Request,
    ServingEngine,
    SplitwiseCluster,
    kv_cache_bytes_per_token,
    kv_cache_state_bytes_per_seq,
    zeros_cache,
)
from torch_helpers import reference_params


@pytest.fixture(scope="module")
def setup():
    cfg = configs.get_smoke_config("gpt_a")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    engine = ServingEngine(cfg, params, max_batch=3, max_len=64, device="cpu")
    cluster = SplitwiseCluster(cfg, params, max_batch=3, max_len=64, device="cpu")
    return cfg, model, params, engine, cluster


def test_zeros_cache_marks_empty_slots(setup):
    cfg, model, _, _, _ = setup
    cache = zeros_cache(model, batch=2, max_len=16, device="cpu")
    pos_leaves = [x for x in cache.values() if x.dtype == torch.int32]
    assert pos_leaves and all((x == -1).all() for x in pos_leaves)
    assert all((x == 0).all() for x in cache.values() if x.is_floating_point())
    assert cache["k"].shape == (cfg.num_layers, 2, 16, cfg.num_kv_heads, cfg.resolved_head_dim)


def test_request_lifecycle_metrics(setup):
    cfg, _, _, engine, _ = setup
    reqs = [
        Request(0, np.arange(5, dtype=np.int32), max_new_tokens=6),
        Request(1, np.arange(8, dtype=np.int32), max_new_tokens=3),
    ]
    out = engine.generate(reqs)
    # every request got exactly its token budget
    assert len(out[0].generated) == 6
    assert len(out[1].generated) == 3
    # TTFT recorded once, TBT once per decode step that produced a token
    for r in out:
        assert r.ttft_ms > 0
        assert len(r.tbt_ms) == len(r.generated) - 1
        assert all(t >= 0 for t in r.tbt_ms)
        assert all(isinstance(t, int) and 0 <= t < cfg.vocab_size for t in r.generated)


def test_greedy_deterministic(setup):
    cfg, _, _, engine, _ = setup
    r1 = engine.generate([Request(0, np.arange(8, dtype=np.int32), max_new_tokens=6)])
    r2 = engine.generate([Request(0, np.arange(8, dtype=np.int32), max_new_tokens=6)])
    assert r1[0].generated == r2[0].generated
    assert len(r1[0].generated) == 6
    assert r1[0].ttft_ms > 0 and len(r1[0].tbt_ms) == 5


def test_batch_isolation_equal_batch(setup):
    """A request's output must not depend on its batch neighbours."""
    cfg, _, _, engine, _ = setup
    p0 = (np.arange(8) % cfg.vocab_size).astype(np.int32)
    alone = engine.generate([Request(0, p0.copy(), max_new_tokens=4)])[0].generated
    other = (np.arange(8) * 7 % cfg.vocab_size).astype(np.int32)
    together = engine.generate(
        [Request(1, p0.copy(), max_new_tokens=4), Request(2, other, max_new_tokens=4)]
    )[0].generated
    assert alone == together


def test_prefill_right_alignment_batch_padding(setup):
    """Unequal-length prompts batched together must each behave as if
    right-aligned alone: pad slots carry position -1 and are masked, so
    the SHORT prompt's tokens are also neighbour-independent."""
    cfg, _, _, engine, _ = setup
    short = (np.arange(4) % cfg.vocab_size).astype(np.int32)
    long = (np.arange(12) * 5 % cfg.vocab_size).astype(np.int32)
    alone = engine.generate([Request(0, short.copy(), max_new_tokens=4)])[0].generated
    mixed = engine.generate([
        Request(1, short.copy(), max_new_tokens=4),
        Request(2, long, max_new_tokens=4),
    ])[0].generated
    assert alone == mixed


def test_ragged_prefill_masked_under_kernel_impl(setup):
    """The flash kernel takes no positions; the engine must pin the masking
    sdpa for ragged batches, by the input alone, so pad slots stay invisible
    under the default "kernel" impl.  The dense batch takes the flash route."""
    cfg, _, params, _, _ = setup
    short = (np.arange(4) % cfg.vocab_size).astype(np.int32)
    peer = ((np.arange(4) * 7 + 1) % cfg.vocab_size).astype(np.int32)
    long = (np.arange(12) * 5 % cfg.vocab_size).astype(np.int32)
    engine = ServingEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    assert attention.get_attention_impl() == "kernel"
    before = attention.sdpa_masked_calls
    # equal-length batch: no padding, dense fast path
    dense = engine.generate([
        Request(1, short.copy(), max_new_tokens=3),
        Request(2, peer, max_new_tokens=3),
    ])[0].generated
    assert attention.sdpa_masked_calls == before
    # ragged batch: 8 pad slots in front of `short`
    ragged = engine.generate([
        Request(3, short.copy(), max_new_tokens=3),
        Request(4, long, max_new_tokens=3),
    ])[0].generated
    assert attention.sdpa_masked_calls == before + cfg.num_layers  # the prefill only, never a decode step
    assert attention.get_attention_impl() == "kernel"
    assert dense == ragged
    assert fa_mod.launches == 0 and dec_mod.launches == 0  # on the CPU no kernel was launched


def test_temperature_sampling_stays_in_vocab(setup):
    cfg, _, _, engine, _ = setup
    req = Request(5, np.arange(8, dtype=np.int32), max_new_tokens=6, temperature=1.0)
    out = engine.generate([req])[0]
    assert len(out.generated) == 6
    assert all(0 <= t < cfg.vocab_size for t in out.generated)


def test_splitwise_matches_monolithic_and_counts_kv_bytes(setup):
    """Prefill/decode disaggregation must not change the tokens (§5),
    and the KV handoff must actually move bytes."""
    cfg, _, _, engine, cluster = setup
    prompt = (np.arange(8) * 3 % cfg.vocab_size).astype(np.int32)
    before = cluster.kv_bytes_moved
    split = cluster.serve([Request(0, prompt.copy(), max_new_tokens=5)])[0]
    mono = engine.generate([Request(1, prompt.copy(), max_new_tokens=5)])[0]
    assert cluster.kv_bytes_moved > before
    assert split.generated == mono.generated
    # the two sides share one cast copy of the weights
    assert cluster.decode_engine.params["lm_head"] is cluster.prefill_engine.params["lm_head"]


def test_sampling_decorrelated_across_decode_steps(setup):
    """The step index is folded into the seed: consecutive steps differ, the
    same step is reproducible, and batches whose ids merely share a sum
    diverge."""
    cfg, _, _, engine, _ = setup
    flat = torch.zeros((3, cfg.vocab_size))
    reqs = [Request(i, np.zeros(1, np.int32), temperature=1.0) for i in range(3)]
    s1 = engine._sample(flat, reqs, step=1)
    s2 = engine._sample(flat, reqs, step=2)
    assert s1.dtype == torch.int32 and s1.shape == (3,)
    assert s1.tolist() != s2.tolist()
    assert s1.tolist() == engine._sample(flat, reqs, step=1).tolist()
    a = [Request(0, np.zeros(1, np.int32), temperature=1.0),
         Request(3, np.zeros(1, np.int32), temperature=1.0)]
    b = [Request(1, np.zeros(1, np.int32), temperature=1.0),
         Request(2, np.zeros(1, np.int32), temperature=1.0)]
    flat2 = torch.zeros((2, cfg.vocab_size))
    draws_a = [t for s in range(4) for t in engine._sample(flat2, a, step=s).tolist()]
    draws_b = [t for s in range(4) for t in engine._sample(flat2, b, step=s).tolist()]
    assert draws_a != draws_b


def test_kv_bytes_moved_counts_only_valid_positions(setup):
    """The handoff counter must agree with the latency model's
    kv_bytes_per_token × prompt_tokens accounting, not with the whole ring."""
    cfg, model, _, _, cluster = setup
    # gpt_a smoke: k+v leaves (L=2, B, S, H=4, hd=64) bf16
    #   per token = 2 leaves × 2 × 4 × 64 × 2 B = 2048 B
    ring = cluster.prefill_engine.max_len
    cache = zeros_cache(model, 2, ring, "cpu")
    per_token = kv_cache_bytes_per_token(cache, ring)
    per_seq = kv_cache_state_bytes_per_seq(cache, ring)
    assert per_token == 2 * cfg.num_layers * 4 * 64 * 2
    assert per_seq == 0.0
    lens = (5, 8)
    before = cluster.kv_bytes_moved
    cluster.serve([
        Request(10 + i, (np.arange(n) % cfg.vocab_size).astype(np.int32), max_new_tokens=2)
        for i, n in enumerate(lens)
    ])
    moved = cluster.kv_bytes_moved - before
    assert moved == per_token * sum(lens)
    full_ring = sum(x.numel() * x.element_size() for x in cache.values() if x.is_floating_point())
    assert moved < full_ring


def test_handoff_is_a_copy(setup):
    """The decode side writes into its own copy of the cache."""
    cfg, _, _, _, cluster = setup
    reqs = [Request(0, np.arange(6, dtype=np.int32), max_new_tokens=1)]
    cache, _, _ = cluster.prefill_engine.prefill_batch(reqs)
    moved = {name: x.clone() for name, x in cache.items()}
    assert all(m.data_ptr() != x.data_ptr() and torch.equal(m, x) for m, x in zip(moved.values(), cache.values()))


def test_too_large_a_batch_is_refused(setup):
    _, _, _, engine, _ = setup
    with pytest.raises(ValueError):
        engine.prefill_batch([Request(i, np.arange(4, dtype=np.int32)) for i in range(4)])


# -- against the reference engine, on converted weights, greedy, f32 ---------


@pytest.fixture(scope="module")
def twins():
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("gpt_a"), dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_smoke_config("gpt_a"), dtype=torch.float32)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    params = convert.from_reference(tree, cfg)
    return ref_cfg, ref_params, cfg, params


def _prompts(cfg):
    rng = np.random.default_rng(21)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (9, 9, 5, 12)]


def test_greedy_token_ids_equal_the_reference_engine(twins):
    ref_cfg, ref_params, cfg, params = twins
    ref_engine = RefServingEngine(ref_cfg, ref_params, max_batch=3, max_len=64)
    engine = ServingEngine(cfg, params, max_batch=3, max_len=64, device="cpu")
    p = _prompts(cfg)
    for batch in ([p[0], p[1]], [p[2], p[3], p[0]], [p[3]]):  # dense, ragged, single
        want = ref_engine.generate([RefRequest(i, x.copy(), max_new_tokens=6) for i, x in enumerate(batch)])
        got = engine.generate([Request(i, x.copy(), max_new_tokens=6) for i, x in enumerate(batch)])
        assert [r.generated for r in got] == [r.generated for r in want]


def test_splitwise_token_ids_equal_the_reference_cluster(twins):
    ref_cfg, ref_params, cfg, params = twins
    ref_cluster = RefSplitwiseCluster(ref_cfg, ref_params, max_batch=3, max_len=64)
    cluster = SplitwiseCluster(cfg, params, max_batch=3, max_len=64, device="cpu")
    p = _prompts(cfg)
    want = ref_cluster.serve([RefRequest(i, x.copy(), max_new_tokens=5) for i, x in enumerate(p[:3])])
    got = cluster.serve([Request(i, x.copy(), max_new_tokens=5) for i, x in enumerate(p[:3])])
    assert [r.generated for r in got] == [r.generated for r in want]
    assert cluster.kv_bytes_moved == ref_cluster.kv_bytes_moved


# -- the MoE family: Qwen1.5-MoE (GQA, KV ring) and DeepSeek-V2-Lite (MLA, latent ring)

MOE_ARCHS = ["qwen2_moe_a2p7b", "deepseek_v2_lite_16b"]


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_twins(request):
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(request.param), dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_smoke_config(request.param), dtype=torch.float32)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    return ref_cfg, ref_params, cfg, convert.from_reference(tree, cfg)


def test_moe_greedy_token_ids_equal_the_reference_engine(moe_twins):
    """Dense, ragged (pads take capacity slots in their sequence, as in the
    reference) and single batches."""
    ref_cfg, ref_params, cfg, params = moe_twins
    ref_engine = RefServingEngine(ref_cfg, ref_params, max_batch=3, max_len=64)
    engine = ServingEngine(cfg, params, max_batch=3, max_len=64, device="cpu")
    p = _prompts(cfg)
    for batch in ([p[0], p[1]], [p[2], p[3], p[0]], [p[3]]):
        want = ref_engine.generate([RefRequest(i, x.copy(), max_new_tokens=6) for i, x in enumerate(batch)])
        got = engine.generate([Request(i, x.copy(), max_new_tokens=6) for i, x in enumerate(batch)])
        assert [r.generated for r in got] == [r.generated for r in want]


def test_moe_splitwise_token_ids_and_bytes_equal_the_reference_cluster(moe_twins):
    ref_cfg, ref_params, cfg, params = moe_twins
    ref_cluster = RefSplitwiseCluster(ref_cfg, ref_params, max_batch=3, max_len=64)
    cluster = SplitwiseCluster(cfg, params, max_batch=3, max_len=64, device="cpu")
    p = _prompts(cfg)
    for batch in (p[:2], p[1:4]):  # dense, then ragged
        want = ref_cluster.serve([RefRequest(i, x.copy(), max_new_tokens=5) for i, x in enumerate(batch)])
        got = cluster.serve([Request(i, x.copy(), max_new_tokens=5) for i, x in enumerate(batch)])
        assert [r.generated for r in got] == [r.generated for r in want]
    assert cluster.kv_bytes_moved == ref_cluster.kv_bytes_moved > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_cache_leaves_count_as_ring_bytes(arch):
    """zeros_cache marks every slot empty, every floating-point leaf (k and v,
    or MLA's ckv and k_rope) has the ring at dim 2 and counts per token, and
    no leaf counts per sequence; the full configs give 196,608 and 31,104
    bytes a token in bf16."""
    cfg = configs.get_smoke_config(arch)
    model = build_model(cfg)
    cache = zeros_cache(model, 2, 16, "cpu")
    assert (cache["pos"] == -1).all() and all((v == 0).all() for k, v in cache.items() if k != "pos")
    want = {"ckv", "k_rope", "pos"} if cfg.mla is not None else {"k", "v", "pos"}
    assert set(cache) == want
    per_token = sum(v[0, 0, 0].numel() * v.element_size() for k, v in cache.items() if k != "pos") * cfg.num_layers
    assert kv_cache_bytes_per_token(cache, 16) == per_token and kv_cache_state_bytes_per_seq(cache, 16) == 0
    full = build_model(configs.get_config(arch))
    shapes = full.cache_shape(1, 8)
    full_bytes = sum(torch.Size(s[:2] + s[3:]).numel() * torch.tensor([], dtype=d).element_size()
                     for k, (s, d) in shapes.items() if k != "pos")
    assert full_bytes == {"qwen2_moe_a2p7b": 196_608, "deepseek_v2_lite_16b": 31_104}[arch]


def test_moe_handoff_clones_the_latent_ring():
    """The splitwise handoff copies MLA's ckv and k_rope like k and v: the
    decode side writes its own copy, the prefill side's cache is untouched."""
    cfg = configs.get_smoke_config("deepseek_v2_lite_16b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    cluster = SplitwiseCluster(cfg, params, max_batch=2, max_len=32, device="cpu")
    reqs = [Request(i, np.arange(3 + i, dtype=np.int32) % cfg.vocab_size, max_new_tokens=4) for i in range(2)]
    cache, tok, pos = cluster.prefill_engine.prefill_batch(reqs)
    before = {k: v.clone() for k, v in cache.items()}
    handed = {k: v.clone() for k, v in cache.items()}
    cluster.decode_engine.decode_batch(reqs, handed, tok, pos, 3)
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    assert not torch.equal(handed["ckv"], cache["ckv"]) and (handed["pos"] >= 0).sum() > (cache["pos"] >= 0).sum()
