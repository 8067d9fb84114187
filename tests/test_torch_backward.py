"""The backward passes of K1 (RMSNorm) and K2 (attention): their plain
versions against ``torch.autograd`` through the plain forwards and against
``jax.vjp`` of the reference's ``repro.models.modules.rmsnorm`` and
``repro.kernels.ref.flash_attention_ref``, on the same numpy inputs; the bf16
attention backward kernels' order of roundings; then the autograd Functions on
the CPU.  The CUDA backward kernels run only on the card,
where ``chip_smoke.py`` holds them against these plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro.models import modules as ref_modules
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rms_mod
from torch_helpers import as_f32, to_jax, to_torch

# f32: the same formulas summed in another order; a dscale entry sums over
# every row and a dk/dv entry over T x G terms, hence 1e-4.  bf16: one rounding
# of each output to bf16 (relative 2**-8) on top of that.
BWD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
EPS = 1e-6


def _grads(fn, inputs, dout):
    """torch.autograd of fn at inputs (leaves copied to require grad) against dout."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


# ---------------------------------------------------------------- K1: RMSNorm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 64), (3, 5, 100), (2, 7, 256), (1, 37)])
def test_rmsnorm_bwd_plain_matches_autograd_and_reference(shape, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, dtype=np.float32) * 2
    scale = rng.standard_normal(shape[-1:], dtype=np.float32)
    dy = rng.standard_normal(shape, dtype=np.float32)
    tx, tdy = to_torch(x, dtype), to_torch(dy, dtype)
    dx, dscale = rms_mod.rmsnorm_bwd_plain(tx, torch.from_numpy(scale), tdy, EPS)
    assert dx.dtype == tx.dtype and dx.shape == tx.shape
    assert dscale.dtype == torch.float32 and dscale.shape == scale.shape

    want_dx, want_dscale = _grads(lambda a, s: rms_mod.rmsnorm_plain(a, s, EPS), (tx, torch.from_numpy(scale)), tdy)
    np.testing.assert_allclose(as_f32(dx), as_f32(want_dx), **BWD_TOL[dtype])
    np.testing.assert_allclose(as_f32(dscale), as_f32(want_dscale), **BWD_TOL[dtype])

    _, vjp = jax.vjp(lambda s, a: ref_modules.rmsnorm(s, a, EPS), jnp.asarray(scale), to_jax(x, dtype))
    ref_dscale, ref_dx = vjp(to_jax(dy, dtype))
    np.testing.assert_allclose(as_f32(dx), as_f32(ref_dx), **BWD_TOL[dtype])
    np.testing.assert_allclose(as_f32(dscale), as_f32(ref_dscale), **BWD_TOL[dtype])


def test_rmsnorm_fn_on_the_cpu_gives_the_plain_backward():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 6, 48), dtype=np.float32)).requires_grad_(True)
    scale = torch.from_numpy(rng.standard_normal(48, dtype=np.float32)).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((2, 6, 48), dtype=np.float32))
    y = ops.rmsnorm(x, scale)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "RMSNormFnBackward"
    np.testing.assert_array_equal(y.detach().numpy(), rms_mod.rmsnorm_plain(x.detach(), scale.detach()).numpy())
    gx, gs = torch.autograd.grad(y, (x, scale), dy)
    want_dx, want_dscale = rms_mod.rmsnorm_bwd_plain(x.detach(), scale.detach(), dy)
    assert torch.equal(gx, want_dx) and torch.equal(gs, want_dscale)
    # a scale that is a row of a layer-stacked leaf, as the model passes it
    stacked = torch.ones((3, 48), requires_grad=True)
    y = ops.rmsnorm(x.detach(), stacked[1])
    (g,) = torch.autograd.grad(y, stacked, dy)
    assert torch.equal(g[1], rms_mod.rmsnorm_bwd_plain(x.detach(), torch.ones(48), dy)[1])
    assert not g[0].any() and not g[2].any()


# ---------------------------------------------------------------- K2: attention


def _qkv(seed, B, T, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, Hq, D), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, T, Hq, D), dtype=np.float32))


# (B, T, S, Hq, Hkv, D): MHA, GQA of 2 and of 3 (Minitron-4B's 24/8), ragged
# T = S, T != S both ways (full), and a causal T != S; then head size 80
# (HuBERT-XLarge's), causal with a group of 2 and full with T != S
ATTN_CASES = [(2, 16, 16, 4, 4, 32, True), (2, 16, 16, 4, 4, 32, False), (2, 33, 33, 4, 2, 32, True),
              (1, 33, 33, 6, 2, 64, False), (2, 24, 24, 6, 2, 32, True), (1, 20, 45, 4, 2, 32, False),
              (1, 45, 20, 4, 1, 32, False), (1, 30, 50, 4, 2, 32, True),
              (1, 33, 33, 4, 2, 80, True), (2, 20, 45, 2, 2, 80, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,S,Hq,Hkv,D,causal", ATTN_CASES)
def test_flash_attention_bwd_plain_matches_autograd_and_reference(B, T, S, Hq, Hkv, D, causal, dtype):
    q, k, v, do = _qkv(2, B, T, S, Hq, Hkv, D)
    tq, tk, tv, tdo = (to_torch(a, dtype) for a in (q, k, v, do))
    o, lse = fa_mod.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    assert lse.shape == (B, Hq, T) and lse.dtype == torch.float32
    dq, dk, dv = fa_mod.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal)
    for got, like in ((dq, tq), (dk, tk), (dv, tv)):
        assert got.shape == like.shape and got.dtype == like.dtype

    want = _grads(lambda a, b, c: fa_mod.flash_attention_plain(a, b, c, causal=causal), (tq, tk, tv), tdo)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(as_f32(got), as_f32(w), **BWD_TOL[dtype])

    _, vjp = jax.vjp(lambda a, b, c: ref_ref.flash_attention_ref(a, b, c, causal=causal),
                     *(to_jax(a, dtype) for a in (q, k, v)))
    for got, w in zip((dq, dk, dv), vjp(to_jax(do, dtype))):
        np.testing.assert_allclose(as_f32(got), as_f32(w), **BWD_TOL[dtype])


def mma_bwd_order(q, k, v, o, lse, do, *, causal: bool):
    """The bf16 backward kernels' roundings (``flash_bwd_wg_*_kernel``):
    scores in f32 from bf16 q and k, scaled after the product; P and dS
    rounded to bf16 before the products into dV, dK and dQ (f32 sums); each
    output rounded once.  Their tiles, steps and exp2 are
    tests/test_torch_flash_bwd_order.py's."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G, scale = Hq // Hkv, D**-0.5
    qf, dof = q.float().reshape(B, T, Hkv, G, D), do.float().reshape(B, T, Hkv, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qf, k.float()) * scale
    if causal:
        s = s.masked_fill(torch.arange(T)[:, None] < torch.arange(S)[None, :], fa_mod.NEG_INF)
    p = torch.exp(s - lse.reshape(B, Hkv, G, T, 1))
    rowsum = (dof * o.float().reshape(B, T, Hkv, G, D)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("btkgd,bskd->bkgts", dof, v.float()) - rowsum[..., None])
    p16, ds16 = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()  # the roundings the plain backward does not make
    dq = torch.einsum("bkgts,bskd->btkgd", ds16, k.float()) * scale
    dk = torch.einsum("bkgts,btkgd->bskd", ds16, qf) * scale
    dv = torch.einsum("bkgts,btkgd->bskd", p16, dof)
    return dq.reshape(B, T, Hq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D,Hq,Hkv", [(32, 4, 4), (64, 6, 2), (128, 4, 4), (128, 6, 2)])
def test_mma_backward_rounding_within_half_the_bf16_allowance(D, Hq, Hkv, causal):
    """On bf16 inputs of 512 tokens the kernels' extra roundings stay within
    half of chip_smoke.py's bf16 allowance (atol = rtol = 2e-2) of the plain
    backward, which the card holds the kernels to, so that a case that fails
    the allowance there points to a fault, not to the design.  Against jax.vjp
    of the reference they stay within the whole allowance: the vjp takes
    D = rowsum(dO o) from the unrounded f32 output where the backward (plain
    and kernel alike, as FlashAttention-2) takes the stored bf16 o, which alone
    uses nearly half of it at D 128 with a group of 3, causal."""
    q, k, v, do = (a[:, :512] for a in _qkv(D + Hkv, 1, 512, 512, Hq, Hkv, D))
    tq, tk, tv, tdo = (to_torch(a, "bfloat16") for a in (q, k, v, do))
    o, lse = fa_mod.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    got = mma_bwd_order(tq, tk, tv, o, lse, tdo, causal=causal)
    plain = fa_mod.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: ref_ref.flash_attention_ref(a, b, c, causal=causal),
                     *(to_jax(a, "bfloat16") for a in (q, k, v)))
    allow = BWD_TOL["bfloat16"]

    def used(g, w):
        g, w = as_f32(g), as_f32(w)
        return float((np.abs(g - w) / (allow["atol"] + allow["rtol"] * np.abs(w))).max())

    for got_i, plain_i, ref_i in zip(got, plain, vjp(to_jax(do, "bfloat16"))):
        assert used(got_i, plain_i) <= 0.5
        assert used(got_i, ref_i) <= 1.0


def test_flash_attention_lse_is_the_rows_logsumexp():
    q, k, v, _ = _qkv(3, 2, 20, 20, 4, 2, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = fa_mod.flash_attention_plain(tq, tk, tv, causal=True, return_lse=True)
    assert torch.equal(o, fa_mod.flash_attention_plain(tq, tk, tv, causal=True))
    s = np.einsum("bthd,bshd->bhts", q[:, :, [0]], k[:, :, [0]])[:, 0] * 32**-0.5  # head 0, kv head 0
    s = np.where(np.tril(np.ones((20, 20), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse[:, 0].numpy(), want, atol=1e-5, rtol=1e-5)


def test_flash_attention_fn_on_the_cpu_sums_the_group_and_takes_views():
    """Through ops.flash_attention with inputs that require grad: the Function
    with the plain forward and backward; k and v of a group of 3 get the sum of
    their three query heads' gradients; heads-first storage and a slice in time
    are taken as views, and their gradients land in the right places."""
    B, T, Hq, Hkv, D = 2, 21, 6, 2, 32
    rng = np.random.default_rng(4)
    q_store = torch.from_numpy(rng.standard_normal((B, Hq, T, D), dtype=np.float32)).requires_grad_(True)
    k_store = torch.from_numpy(rng.standard_normal((B, Hkv, T, D), dtype=np.float32)).requires_grad_(True)
    v_store = torch.from_numpy(rng.standard_normal((B, T + 5, Hkv, D), dtype=np.float32)).requires_grad_(True)
    do = torch.from_numpy(rng.standard_normal((B, T, Hq, D), dtype=np.float32))
    q, k, v = q_store.transpose(1, 2), k_store.transpose(1, 2), v_store[:, 5:]
    o = ops.flash_attention(q, k, v, causal=True)
    assert type(o.grad_fn).__name__ == "FlashAttentionFnBackward"
    gq, gk, gv = torch.autograd.grad(o, (q_store, k_store, v_store), do)
    assert gq.shape == q_store.shape and gk.shape == k_store.shape and gv.shape == v_store.shape
    assert not gv[:, :5].any()

    # each query head on its own (MHA with its kv head repeated), summed over the group by hand
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    krep, vrep = kd.repeat_interleave(Hq // Hkv, dim=2), vd.repeat_interleave(Hq // Hkv, dim=2)
    wq, wk, wv = _grads(lambda a, b, c: fa_mod.flash_attention_plain(a, b, c, causal=True), (qd, krep, vrep), do)
    wk = wk.reshape(B, T, Hkv, Hq // Hkv, D).sum(3)
    wv = wv.reshape(B, T, Hkv, Hq // Hkv, D).sum(3)
    tol = BWD_TOL["float32"]
    np.testing.assert_allclose(gq.transpose(1, 2).numpy(), wq.numpy(), **tol)
    np.testing.assert_allclose(gk.transpose(1, 2).numpy(), wk.numpy(), **tol)
    np.testing.assert_allclose(gv[:, 5:].numpy(), wv.numpy(), **tol)


def test_without_gradients_ops_keep_the_plain_forward():
    """Serving's path is unchanged: under no_grad, or with inputs that need
    no grad, no Function is recorded."""
    q, k, v, _ = _qkv(5, 1, 8, 8, 2, 2, 32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    assert ops.flash_attention(tq, tk, tv).grad_fn is None
    with torch.no_grad():
        assert ops.flash_attention(tq, tk, tv.requires_grad_(True)).grad_fn is None
        assert ops.rmsnorm(tq, torch.ones(32, requires_grad=True)).grad_fn is None


@pytest.mark.parametrize("name", ["rmsnorm_bwd", "flash_attention_bwd"])
def test_backward_wrappers_refuse_cpu_tensors_and_gradients(name):
    """The CUDA backward wrappers take card tensors only, and, like the
    forward wrappers, refuse inputs that would be differentiated."""
    if name == "rmsnorm_bwd":
        x = torch.zeros(4, 64)
        fn, args, kw = rms_mod.rmsnorm_bwd_rows, (x, torch.ones(64), x), {}
    else:
        q = torch.zeros(1, 8, 2, 32)
        fn, args, kw = fa_mod.flash_attention_bwd_cuda, (q, q, q, q, torch.zeros(1, 2, 8), q), {"causal": True}
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fn(*args, **kw)
    args = (args[0].clone().requires_grad_(True),) + args[1:]
    with pytest.raises(ValueError, match="gradients"):
        fn(*args, **kw)
