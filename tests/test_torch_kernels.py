"""The port's plain versions of the three kernels against the JAX package's
oracles (``repro.kernels.ref``) and against its Pallas kernels in interpret mode
(``repro.kernels.ops``), on the same numpy inputs.  The CUDA kernels themselves
run only on the card, where ``chip_smoke.py`` holds them against these plain
versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import ops, ref
from torch_helpers import as_f32, to_jax, to_torch, tol


def _qkv(seed, B, T, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, Hq, D), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, D), dtype=np.float32))


@pytest.mark.parametrize("T,Hq,Hkv,D,dtype,causal", [
    (128, 4, 4, 64, "float32", True),
    (128, 4, 4, 64, "float32", False),
    (128, 8, 2, 64, "float32", True),
    (128, 8, 2, 64, "float32", False),
    (128, 6, 1, 32, "float32", True),
    (128, 6, 1, 32, "float32", False),
    (128, 4, 4, 64, "bfloat16", True),
    (128, 8, 2, 64, "bfloat16", False),
])
def test_flash_attention_plain_matches_reference(T, Hq, Hkv, D, dtype, causal):
    q, k, v = _qkv(0, 2, T, T, Hq, Hkv, D)
    o = ops.flash_attention(*(to_torch(a, dtype) for a in (q, k, v)), causal=causal)
    assert o.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    jq, jk, jv = (to_jax(a, dtype) for a in (q, k, v))
    o_ref = ref_ref.flash_attention_ref(jq, jk, jv, causal=causal)
    o_pallas = ref_ops.flash_attention(jq, jk, jv, causal=causal, block_q=64, block_kv=64)
    np.testing.assert_allclose(as_f32(o), as_f32(o_ref), **tol(dtype))
    np.testing.assert_allclose(as_f32(o), as_f32(o_pallas), **tol(dtype))


def _ring(B, S):
    """Ring-buffer-like positions with 37 empty slots, as the reference's sweep."""
    kv_pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    kv_pos[kv_pos >= S - 37] = -1
    return kv_pos, np.full((B, 1), S - 40, np.int32)


@pytest.mark.parametrize("S,Hq,Hkv,D,window,dtype", [
    (256, 4, 4, 64, None, "float32"),
    (256, 8, 2, 64, 128, "float32"),
    (256, 4, 1, 32, 64, "float32"),
    (256, 4, 4, 64, None, "bfloat16"),
])
def test_decode_attention_plain_matches_reference(S, Hq, Hkv, D, window, dtype):
    B = 3
    q, k, v = _qkv(1, B, 1, S, Hq, Hkv, D)
    kv_pos, q_pos = _ring(B, S)
    o = ops.decode_attention(*(to_torch(a, dtype) for a in (q, k, v)),
                             torch.from_numpy(q_pos), torch.from_numpy(kv_pos), window=window)
    jq, jk, jv = (to_jax(a, dtype) for a in (q, k, v))
    o_ref = ref_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), window=window)
    o_pallas = ref_ops.decode_attention(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                        window=window, block_kv=128)
    np.testing.assert_allclose(as_f32(o), as_f32(o_ref), **tol(dtype))
    np.testing.assert_allclose(as_f32(o), as_f32(o_pallas), **tol(dtype))


@pytest.mark.parametrize("shape", [(512, 128), (3, 256, 64), (2, 4, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_reference(shape, dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape, dtype=np.float32)
    sc = rng.standard_normal(shape[-1:], dtype=np.float32)
    o = ops.rmsnorm(to_torch(x, dtype), torch.from_numpy(sc))
    o_ref = ref_ref.rmsnorm_ref(to_jax(x, dtype), jnp.asarray(sc))
    o_pallas = ref_ops.rmsnorm(to_jax(x, dtype), jnp.asarray(sc), block_rows=64)
    np.testing.assert_allclose(as_f32(o), as_f32(o_ref), **tol(dtype))
    np.testing.assert_allclose(as_f32(o), as_f32(o_pallas), **tol(dtype))


def test_decode_row_without_valid_slot_is_mean_of_v():
    """With the finite NEG_INF a query with no valid key gets the uniform mean
    of V over all S slots: the oracle, the Pallas kernel and the port agree."""
    B, S, Hq, Hkv, D = 2, 128, 4, 2, 32
    q, k, v = _qkv(3, B, 1, S, Hq, Hkv, D)
    kv_pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    kv_pos[0] = -1  # row 0: every slot empty
    kv_pos[1] += 1000  # row 1: every slot in the future
    q_pos = np.full((B, 1), 50, np.int32)
    o = ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)))
    jargs = [jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)]
    np.testing.assert_allclose(as_f32(o), as_f32(ref_ref.decode_attention_ref(*jargs)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(as_f32(o), as_f32(ref_ops.decode_attention(*jargs, block_kv=64)), atol=2e-5, rtol=2e-5)
    mean_v = np.repeat(v.mean(axis=1, keepdims=True), Hq // Hkv, axis=2)  # (B,1,Hq,D), head h reads kv head h // G
    np.testing.assert_allclose(as_f32(o), mean_v, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_ragged_sizes(causal):
    """T and S that divide no block: against the oracle alone (the Pallas
    wrapper would itself fall back to it)."""
    q, k, v = _qkv(4, 1, 300, 300, 4, 2, 32)
    o = ref.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    o_ref = ref_ref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(as_f32(o), as_f32(o_ref), atol=2e-5, rtol=2e-5)


def test_decode_attention_plain_ragged_size_shuffled_ring():
    """S = 1000 with positions in shuffled slot order: masking is by value."""
    B, S = 2, 1000
    q, k, v = _qkv(5, B, 1, S, 6, 3, 32)
    rng = np.random.default_rng(5)
    kv_pos = np.stack([rng.permutation(S) for _ in range(B)]).astype(np.int32) + 100
    kv_pos[kv_pos % 7 == 3] = -1
    q_pos = np.full((B, 1), 766, np.int32)
    for window in (None, 300):
        o = ref.decode_attention_ref(*(torch.from_numpy(a) for a in (q, k, v, q_pos, kv_pos)), window=window)
        o_ref = ref_ref.decode_attention_ref(*(jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos)), window=window)
        np.testing.assert_allclose(as_f32(o), as_f32(o_ref), atol=2e-5, rtol=2e-5)


def test_rmsnorm_plain_ragged_rows():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((777, 96), dtype=np.float32)
    sc = rng.standard_normal((96,), dtype=np.float32)
    o = ref.rmsnorm_ref(torch.from_numpy(x), torch.from_numpy(sc))
    np.testing.assert_allclose(as_f32(o), as_f32(ref_ref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(sc))), atol=2e-5, rtol=2e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors or raise; only ``ops`` routes a
    CPU tensor, and it routes it to the plain version."""
    from repro_torch.kernels.decode_attention import decode_attention_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_rows

    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_rows(x, torch.ones(64))
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(q[:, :1], q, q, torch.zeros(1, 1, dtype=torch.int32), torch.zeros(1, 8, dtype=torch.int32))


def test_decode_split_plan_covers_the_ring():
    from repro_torch.kernels.decode_attention import TILE, split_plan

    for B, Hkv, S in [(4, 32, 1024), (1, 1, 1), (1, 8, 1000), (64, 32, 8192), (3, 2, 65)]:
        nsplit, per = split_plan(B, Hkv, S, sm_count=132)
        ntiles = -(-S // TILE)
        assert nsplit * per >= ntiles > (nsplit - 1) * per  # every slice holds at least one tile
