"""The WKV-6 recurrence of the port (``repro_torch.kernels.wkv6``) against the
JAX package: its oracle ``ref.wkv6_ref``, its Pallas kernel in interpret mode
(``repro.kernels.ops.wkv6``, as ``tests/test_kernels.py`` runs it), and the
model's chunked form ``repro.models.rwkv._wkv_chunked`` with an initial state;
ragged T and T = 1 against a sequential recurrence in float64.  Inputs are made
with numpy from a seed and handed to both packages.  The CUDA kernel itself runs
only on the card, where ``chip_smoke.py`` holds it against ``wkv6_plain``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import rwkv as ref_rwkv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wkv6 as wkv_mod
from torch_helpers import as_f32, to_torch

# f32: the chunked form and the sequential recurrence sum in another order and
# rescale by exp(±cumulative log decay); the reference's own test of its kernel
# against the sequential oracle uses 2e-4 (tests/test_kernels.py).
F32 = dict(atol=2e-4, rtol=2e-4)
# bf16 outputs: one rounding of y to bf16 (relative 2**-8) on top of that.
BF16 = dict(atol=2e-2, rtol=2e-2)


def _inputs(seed, B, T, H, D, state=False):
    """The reference test's distributions: r, k, v ~ N(0, 0.25), logw =
    -exp(N(0, 0.25) - 2), u ~ N(0, 0.01); S0 ~ N(0, 0.25) where asked for."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, D), dtype=np.float32) * 0.5 for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, T, H, D), dtype=np.float32) * 0.5 - 2.0).astype(np.float32)
    u = rng.standard_normal((H, D), dtype=np.float32) * 0.1
    S0 = rng.standard_normal((B, H, D, D), dtype=np.float32) * 0.5 if state else None
    return r, k, v, logw, u, S0


def _sequential(r, k, v, logw, u, S0=None):
    """The recurrence one step at a time in float64: (y, final state)."""
    B, T, H, D = r.shape
    f = lambda a: np.asarray(a, np.float64)
    r, k, v, logw, u = f(r), f(k), f(v), f(logw), f(u)
    S = np.zeros((B, H, D, D)) if S0 is None else f(S0).copy()
    y = np.zeros((B, T, H, D))
    for t in range(T):
        kv = np.einsum("bhd,bhe->bhde", k[:, t], v[:, t])
        y[:, t] = np.einsum("bhd,bhde->bhe", r[:, t], S + u[None, :, :, None] * kv)
        S = S * np.exp(logw[:, t])[..., None] + kv
    return y, S


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("T,H,D,chunk", [(128, 2, 64, 32), (96, 4, 32, 32), (128, 1, 64, 64)])
def test_wkv6_plain_matches_reference_and_pallas(T, H, D, chunk):
    """The reference's sweep (tests/test_kernels.py::test_wkv6_vs_sequential)."""
    r, k, v, logw, u, _ = _inputs(4, 2, T, H, D)
    y = ops.wkv6(*_torch(r, k, v, logw, u), chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (2, T, H, D)
    jargs = [jnp.asarray(a) for a in (r, k, v, logw, u)]
    np.testing.assert_allclose(as_f32(y), as_f32(ref_ref.wkv6_ref(*jargs)), **F32)
    np.testing.assert_allclose(as_f32(y), as_f32(ref_ops.wkv6(*jargs, chunk=chunk)), **F32)
    np.testing.assert_allclose(as_f32(ref.wkv6_ref(*_torch(r, k, v, logw, u))), as_f32(ref_ref.wkv6_ref(*jargs)), **F32)


@pytest.mark.parametrize("T,H,D,chunk", [(64, 2, 64, 32), (96, 3, 32, 32), (128, 2, 64, 128)])
def test_wkv6_plain_matches_wkv_chunked_with_a_state(T, H, D, chunk):
    """y and the final state against the model's chunked form from a nonzero S0."""
    r, k, v, logw, u, S0 = _inputs(5, 2, T, H, D, state=True)
    y, S = wkv_mod.wkv6_plain(*_torch(r, k, v, logw, u, S0), chunk=chunk)
    y_ref, S_ref = ref_rwkv._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)), chunk, jnp.asarray(S0))
    np.testing.assert_allclose(as_f32(y), as_f32(y_ref), **F32)
    np.testing.assert_allclose(as_f32(S), as_f32(S_ref), **F32)
    assert S.dtype == torch.float32 and S.shape == (2, H, D, D)


@pytest.mark.parametrize("T", [1, 31, 100, 300])
def test_wkv6_plain_ragged_T_against_the_sequential_recurrence(T):
    """T that no chunk divides, and T = 1 (a decode step), from a nonzero S0."""
    r, k, v, logw, u, S0 = _inputs(6 + T, 2, T, 2, 32, state=True)
    S0_t = torch.from_numpy(S0.copy())
    y, S = wkv_mod.wkv6_plain(*_torch(r, k, v, logw, u), S0_t, chunk=64)
    y_ref, S_ref = _sequential(r, k, v, logw, u, S0)
    np.testing.assert_allclose(as_f32(y), y_ref, **F32)
    np.testing.assert_allclose(as_f32(S), S_ref, **F32)
    np.testing.assert_array_equal(S0_t.numpy(), S0)  # the plain version does not write S0


@pytest.mark.parametrize("T", [1, 100])
def test_wkv6_plain_bf16(T):
    """bf16 r, k, v: y in bf16 within one rounding of the f32 result on the same
    (rounded) inputs; the state stays f32."""
    r, k, v, logw, u, S0 = _inputs(7, 2, T, 2, 64, state=True)
    rb, kb, vb = (to_torch(a, "bfloat16") for a in (r, k, v))
    y, S = wkv_mod.wkv6_plain(rb, kb, vb, *_torch(logw, u, S0), chunk=32)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    y_ref, S_ref = _sequential(as_f32(rb), as_f32(kb), as_f32(vb), logw, u, S0)
    np.testing.assert_allclose(as_f32(y), y_ref, **BF16)
    np.testing.assert_allclose(as_f32(S), S_ref, **F32)


def test_wkv6_chunk_length_changes_nothing():
    r, k, v, logw, u, S0 = _inputs(8, 1, 200, 2, 32, state=True)
    args = _torch(r, k, v, logw, u, S0)
    y16, S16 = wkv_mod.wkv6_plain(*args, chunk=16)
    for chunk in (64, 128, 256):
        y, S = wkv_mod.wkv6_plain(*args, chunk=chunk)
        torch.testing.assert_close(y, y16, **F32)
        torch.testing.assert_close(S, S16, **F32)


def test_wkv6_in_two_segments_equals_one():
    """A prefill of the first segment then the rest from its state is the
    recurrence over the whole: what a prefill followed by decode steps relies on."""
    r, k, v, logw, u, _ = _inputs(9, 2, 70, 2, 64)
    whole = ops.wkv6(*_torch(r, k, v, logw, u))
    state = torch.zeros((2, 2, 64, 64))
    parts = [ops.wkv6(*_torch(*(a[:, sl] for a in (r, k, v, logw)), u), state)
             for sl in (slice(0, 45), slice(45, 69), slice(69, 70))]
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, **F32)
    _, S_ref = _sequential(r, k, v, logw, u)
    np.testing.assert_allclose(state.numpy(), S_ref, **F32)


def test_ops_wkv6_on_the_cpu_takes_the_plain_version_and_writes_the_state():
    r, k, v, logw, u, S0 = _inputs(10, 2, 33, 2, 32, state=True)
    state = torch.from_numpy(S0.copy())
    before = wkv_mod.launches
    y = ops.wkv6(*_torch(r, k, v, logw, u), state, chunk=16)
    y_ref, S_ref = _sequential(r, k, v, logw, u, S0)
    np.testing.assert_allclose(as_f32(y), y_ref, **F32)
    np.testing.assert_allclose(state.numpy(), S_ref, **F32)  # overwritten in place
    assert wkv_mod.launches == before == 0  # nothing was launched on the CPU


def test_wkv6_cuda_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors or raises; only ``ops`` routes a
    CPU tensor, and it routes it to the plain version."""
    r, k, v, logw, u, S0 = _torch(*_inputs(11, 1, 4, 2, 32, state=True))
    with pytest.raises(ValueError, match="CUDA"):
        wkv_mod.wkv6_cuda(r, k, v, logw, u, S0)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_mod.wkv6_cuda(r, k, v, logw, u)
