"""The WKV-6 backward of the port (``repro_torch.kernels.wkv6``): the plain
backward ``wkv6_bwd_plain`` against autograd through ``wkv6_plain`` and
against ``jax.vjp`` of the reference's ``_wkv_chunked`` (padded to its chunk,
as the reference's block pads); the order of the CUDA backward (passes A, B
and C of ``csrc/wkv6.cu`` and the identity that gives dlogw without a state),
repeated here in float64, against autograd through the sequential recurrence,
strong decay included; ``WKV6Fn`` through ``ops.wkv6``; and the refusal of a
differentiated call with a state.  Inputs are made with numpy from a seed.
The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them
against ``wkv6_bwd_plain`` and against autograd through the recurrence."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as ref_rwkv
from repro_torch.kernels import ops
from repro_torch.kernels import wkv6 as wkv_mod

# relative in norm: f32 sums in another order and the chunked form's
# rescalings by exp(+-cumulative log decay); bf16 inputs and outputs add one
# rounding of each gradient to bf16 (relative 2**-8)
REL = {"float32": 1e-4, "bfloat16": 2e-2}
SHAPES = [(2, 1, 2, 32), (2, 31, 3, 64), (2, 64, 2, 32), (2, 100, 2, 64), (2, 300, 3, 32)]
NAMES = ("dr", "dk", "dv", "dlogw", "du")


def _inputs(seed, B, T, H, D, strong=False):
    """The reference test's distributions, and dy ~ N(0, 1); with ``strong``
    a log decay of about -7 a step, where the chunked form's exp(-L) overflows."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, D), dtype=np.float32) * 0.5 for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, T, H, D), dtype=np.float32) * 0.5 + (2.0 if strong else -2.0))
    u = rng.standard_normal((H, D), dtype=np.float32) * 0.1
    dy = rng.standard_normal((B, T, H, D), dtype=np.float32)
    return r, k, v, logw.astype(np.float32), u, dy


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.linalg.norm(got))


def _torch(arrays, dtype=torch.float32):
    """r, k, v (and dy) in ``dtype``; logw and u f32."""
    r, k, v, logw, u, dy = (torch.from_numpy(a) for a in arrays)
    return r.to(dtype), k.to(dtype), v.to(dtype), logw, u, dy.to(dtype)


def _autograd(fn, r, k, v, logw, u, dy):
    leaves = [t.detach().clone().requires_grad_(True) for t in (r, k, v, logw, u)]
    out = fn(*leaves)
    return torch.autograd.grad(out, leaves, dy, allow_unused=True)


def _sequential(r, k, v, logw, u):
    """The recurrence one step at a time, differentiable, in the inputs' type."""
    B, T, H, D = r.shape
    S = torch.zeros((B, H, D, D), dtype=r.dtype)
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhd,bhde->bhe", r[:, t], S + u[None, :, :, None] * kv))
        S = S * torch.exp(logw[:, t])[..., None] + kv
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,D", SHAPES)
def test_plain_backward_matches_autograd_of_the_plain_forward(B, T, H, D, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    r, k, v, logw, u, dy = _torch(_inputs(1, B, T, H, D), tdt)
    got = wkv_mod.wkv6_bwd_plain(r, k, v, logw, u, dy, chunk=32)
    want = _autograd(lambda *a: wkv_mod.wkv6_plain(*a, None, chunk=32)[0], r, k, v, logw, u, dy)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == (tdt if name in ("dr", "dk", "dv") else torch.float32), name
        if w is None:  # T = 1: y does not read logw
            assert name == "dlogw" and not g.any()
            continue
        assert g.shape == w.shape, name
        assert _rel(g.float(), w.float()) <= REL[dtype], (name, _rel(g.float(), w.float()))


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("B,T,H,D", SHAPES)
def test_plain_backward_matches_the_reference_vjp(B, T, H, D, chunk):
    """jax.vjp of ``_wkv_chunked`` on the same numpy inputs, T padded to the
    chunk with zeros and y cut back, as ``repro.models.rwkv.rwkv6_apply`` does."""
    arrays = _inputs(2, B, T, H, D)
    pad = (-T) % chunk

    def ref(r, k, v, logw, u):
        padf = lambda a: jnp.pad(a, [(0, 0), (0, pad), (0, 0), (0, 0)])  # noqa: E731
        y, _ = ref_rwkv._wkv_chunked(padf(r), padf(k), padf(v), padf(logw), u, chunk)
        return y[:, :T]

    _, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in arrays[:5]))
    want = vjp(jnp.asarray(arrays[5]))
    got = wkv_mod.wkv6_bwd_plain(*_torch(arrays), chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= REL["float32"], (name, _rel(g.numpy(), np.asarray(w)))


def kernel_order(r, k, v, logw, u, dy, dtype=torch.float64):
    """The CUDA backward's passes in ``dtype``, step by step as its kernels take
    them: A (forward in time, M = S by rows) gives dr, r drI and du; B (the same
    kernel backward in time with (x, y, kk, z) = (v, dy, r, k), M = dS) gives dk
    and dlogw from the running sums; C (the forward recurrence backward in time
    with k for r, r for k, dy for v) gives dv."""
    r, k, v, logw, u, dy = (a.to(dtype) for a in (r, k, v, logw, u, dy))
    B, T, H, D = r.shape
    w = torch.exp(logw)

    def rows_pass(x, y, kk, z, times):
        M = torch.zeros((B, H, D, D), dtype=dtype)
        out, zpart = torch.zeros_like(r), torch.zeros_like(r)
        for t in times:
            part = torch.einsum("bhij,bhj->bhi", M, x[:, t])  # M before the step's update
            M = M * w[:, t, :, :, None] + kk[:, t, :, :, None] * y[:, t, :, None, :]
            xy = (x[:, t] * y[:, t]).sum(-1, keepdim=True)
            out[:, t] = part + u * kk[:, t] * xy
            zpart[:, t] = z[:, t] * part
        return out, zpart

    dr, r_drI = rows_pass(dy, v, k, r, range(T))  # pass A
    dk, k_dkI = rows_pass(v, dy, r, k, reversed(range(T)))  # pass B
    dlogw = torch.zeros_like(r)
    run = torch.zeros((B, H, D), dtype=dtype)
    for t in reversed(range(T)):  # B's walk: run = sum_{t'>t} r drI - sum_{t'>=t} k dkI, one sum
        run = run - k_dkI[:, t]
        dlogw[:, t] = run
        run = run + r_drI[:, t]
    du = (r * k * (v * dy).sum(-1, keepdim=True)).sum(dim=(0, 1))
    # pass C: the forward recurrence backward in time, (r, k, v) -> (k, r, dy)
    S = torch.zeros((B, H, D, D), dtype=dtype)
    dv = torch.zeros_like(r)
    for t in reversed(range(T)):
        kv = r[:, t, :, :, None] * dy[:, t, :, None, :]
        dv[:, t] = torch.einsum("bhd,bhde->bhe", k[:, t], S + u[None, :, :, None] * kv)
        S = S * w[:, t, :, :, None] + kv
    return dr, dk, dv, dlogw, du


@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong-decay"])
@pytest.mark.parametrize("B,T,H,D", [(2, 1, 2, 8), (2, 37, 2, 8), (1, 129, 3, 16)])
def test_kernel_order_matches_autograd_of_the_recurrence(B, T, H, D, strong):
    arrays = _inputs(3, B, T, H, D, strong=strong)
    r, k, v, logw, u, dy = (t.double() for t in _torch(arrays))
    got = kernel_order(r, k, v, logw, u, dy)
    want = _autograd(_sequential, r, k, v, logw, u, dy)
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        if w is None:
            assert name == "dlogw" and not g.any()
            continue
        assert _rel(g, w) <= 1e-10, (name, _rel(g, w))


def test_strong_decay_overflows_the_chunked_plain_backward_only():
    """Where exp(-L) of the chunked form overflows in f32, the kernel's order
    stays finite: the card holds the kernel against the recurrence there."""
    arrays = _inputs(4, 1, 129, 2, 16, strong=True)
    plain = wkv_mod.wkv6_bwd_plain(*_torch(arrays), chunk=64)
    assert not all(torch.isfinite(g).all() for g in plain)
    assert all(torch.isfinite(g).all() for g in kernel_order(*_torch(arrays), dtype=torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [31, 100])
def test_wkv6fn_through_ops_gives_autograds_gradients(T, dtype):
    """Differentiated inputs take ``WKV6Fn``: its plain forward and plain
    backward on the CPU, against autograd through the plain forward."""
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    r, k, v, logw, u, dy = _torch(_inputs(5, 2, T, 2, 64), tdt)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u)]
    y = ops.wkv6(*leaves, chunk=32)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "WKV6FnBackward"
    got = torch.autograd.grad(y, leaves, dy)
    want = _autograd(lambda *a: wkv_mod.wkv6_plain(*a, None, chunk=32)[0], r, k, v, logw, u, dy)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype, name
        assert _rel(g.float(), w.float()) <= REL[dtype], (name, _rel(g.float(), w.float()))
    with torch.no_grad():  # the forward is the plain version's
        torch.testing.assert_close(y.detach(), wkv_mod.wkv6_plain(r, k, v, logw, u, None, chunk=32)[0], rtol=0, atol=0)


def test_a_differentiated_call_with_a_state_raises():
    r, k, v, logw, u, _ = _torch(_inputs(6, 1, 8, 2, 32))
    state = torch.zeros((1, 2, 32, 32))
    with pytest.raises(ValueError, match="zero state"):
        ops.wkv6(r.requires_grad_(True), k, v, logw, u, state)
    with torch.no_grad():  # serving: the state is read and written, as before
        ops.wkv6(r, k, v, logw, u, state)
    assert state.any()
