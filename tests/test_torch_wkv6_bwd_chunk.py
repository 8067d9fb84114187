"""The order of operations of the chunked bf16 WKV-6 backward on the tensor cores, held on the CPU.

``csrc/wkv6.cu``'s chunked backward (bf16 r, k, v, dy at head size 64, T of
at least ``CHUNKED_BWD_T_MIN``) is two launches and the du sum:

* ``wkv6_bwd_state_kernel`` walks the chunks forward with the forward's state
  update alone and writes the state before each chunk, split into a bf16 high
  and low part, to a workspace;
* ``wkv6_bwd_chunk_kernel`` walks the chunks backward with dS (the gradient
  of the state after the chunk) in f32 and computes every gradient of a chunk
  in one pass.

``chunk_bwd_order`` below repeats their arithmetic in plain torch.  Per chunk
of 64 steps, with L the inclusive cumulative log2 decay, Lx the exclusive one
(Lx_i = L_{i-1}) and Lt the chunk's total, and warp w owning the rows of the
16-row sub-chunk [b, B) = [16 w, 16 w + 16):

* drI (rows i of the sub-chunk) = 2^(Lx_i - Lx_b) (2^(Lx_b) (dy S_prev^T)
  + dA k'), with dA_ij = dy_i . v_j for j < b and k'_j = k_j 2^(Lx_b - L_j);
* dkI (rows j) = 2^(Lx_B - L_j) (2^(Lt - Lx_B) (v dS^T) + dA^T r'), with
  r'_i = r_i 2^(Lx_i - Lx_B) for i >= B;
* A^T (rows j, columns i >= B) = (k_j 2^(Lx_B - L_j)) . r'_i;
* the sub-chunk's 16 x 16 diagonal block as the forward's (2a) and (2b): its
  rows 8.. against its columns ..7 on the tensor cores through the boundary
  m = b + 8, and its two 8 x 8 blocks on the diagonal in f32 on the CUDA
  cores, exp2(Lx_i - L_j) straight from the difference, for the terms of drI
  and dkI with both steps in the block, A_ij beside them and the bonus
  r_j u k_j at i = j;
* dv = A^T dy + (k 2^(Lt - L)) dS;
* dS_prev = 2^(Lt) dS + (r 2^(Lx))^T dy;
* dlogw_s = sum_{t>s} r_t drI_t - sum_{t>=s} k_t dkI_t: within a chunk the
  suffix sums of the differences r_{t+1} drI_{t+1} - k_t dkI_t over each
  warp's 16 rows and the later warps' sums, across chunks one running sum.

No exponent anywhere is positive.  Every product of ``mma.sync`` has bf16
operands and f32 sums; an operand that is not a bf16 input is split into bf16
parts, each the rounding of what the parts before it leave.  dlogw is f32 and
held at f32's allowance, and it sums r drI - k dkI over the sequence, so every
operand on its path is split into three parts (about 24 bits): the decayed k
of the state walk, S_prev, dS, dA and the decayed r and k against it, and
r 2^(Lx) of the dS update; three products against a bf16 input, six where
both operands are split (the parts whose orders sum to less than three).  dv's
operands (A^T, k 2^(Lt - L) against dS) take two parts, as the forward's y
does: three products, two against a bf16 input.  Two parts everywhere leave
dlogw at 1.8 times f32's allowance at T = 512.
With ``exact`` every split is the identity and the arithmetic is float64,
which holds the algebra against autograd through the recurrence at 1e-10; with
the roundings the order must stay within half of ``chip_smoke.py``'s
allowances of the port's plain backward and of ``jax.vjp`` of the reference,
so that a failure on the card points to a fault and not to the design's
roundings.  Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as ref_rwkv
from repro_torch.kernels import wkv6 as wkv_mod

C = 64  # steps a chunk
SUB = 16  # rows a sub-chunk: one warp's rows of an m16n8k16 product
LOG2E = 1.4426950408889634
NAMES = ("dr", "dk", "dv", "dlogw", "du")
# half of chip_smoke.py's WKV_TOL, atol = rtol: bf16 2e-2 for dr, dk, dv; the
# f32 2e-4 for dlogw and du, which are f32 whatever the inputs
HALF_ALLOWANCE = {"dr": 1e-2, "dk": 1e-2, "dv": 1e-2, "dlogw": 1e-4, "du": 1e-4}
TS = [1, 31, 63, 64, 65, 129, 300]


def chunk_bwd_order(r, k, v, logw, u, dy, *, exact: bool = False):
    """r, k, v, dy (B, T, H, 64), logw (B, T, H, 64), u (H, 64) ->
    (dr, dk, dv, dlogw, du) as the two kernels compute them: dr, dk, dv in r's
    dtype (float64 with ``exact``), dlogw (B, T, H, 64) and du (H, 64) f32."""
    dt = torch.float64 if exact else torch.float32
    B, T, H, D = r.shape
    nc = -(-T // C)
    pad = nc * C - T

    def split(x, parts):
        """x as ``parts`` bf16 terms, each the rounding of what the others leave."""
        if exact:
            return [x]
        out = []
        for _ in range(parts - 1):
            out.append(x.to(torch.bfloat16).to(dt))
            x = x - out[-1]
        return out + [x.to(torch.bfloat16).to(dt)]

    def mm(eq, a, b, pa=2, pb=2):
        """a and b through mma.sync, each split into ``pa``, ``pb`` bf16 parts
        (1: a bf16 input, exact): the products of the parts whose orders sum
        to less than the larger count, hi hi + hi lo + lo hi for two parts."""
        aa, bb = split(a, pa), split(b, pb)
        top = max(len(aa), len(bb))
        out = 0
        for i, x in enumerate(aa):
            for j, y in enumerate(bb):
                if i + j < top:
                    out = out + torch.einsum(eq, x, y)
        return out

    def e2(x):
        return torch.exp2(x)

    def chunks(a):  # (B, H, nc, C, D); pad rows read as zeros
        return torch.nn.functional.pad(a.to(dt), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3).reshape(B, H, nc, C, D)

    rc, kc, vc, gc, lw = chunks(r), chunks(k), chunks(v), chunks(dy), chunks(logw)
    L = (lw * LOG2E).cumsum(3)
    Lx = torch.cat([torch.zeros_like(L[..., :1, :]), L[..., :-1, :]], dim=3)
    uf = u.to(dt)[None, :, None, :]  # (1, H, 1, D)

    # the state walk: S before each chunk, kept as its high and low parts
    S = torch.zeros((B, H, D, D), dtype=dt)
    S_prev = []
    for c in range(nc):
        S_prev.append(S)
        Lt = L[:, :, c, -1:]  # (B, H, 1, D)
        kw = kc[:, :, c] * e2(Lt - L[:, :, c])
        S = S * e2(Lt).transpose(2, 3) + mm("bhjd,bhje->bhde", kw, vc[:, :, c], 3, 1)

    # the gradient walk, last chunk first
    dS = torch.zeros((B, H, D, D), dtype=dt)
    carry = torch.zeros((B, H, D), dtype=dt)
    du = torch.zeros((B, H, D), dtype=dt)
    outs = {n: torch.zeros((B, H, nc, C, D), dtype=dt) for n in NAMES[:4]}
    strict = torch.tril(torch.ones(SUB // 2, SUB // 2, dtype=torch.bool), diagonal=-1)
    for c in reversed(range(nc)):
        rr, kk, vv, gg = rc[:, :, c], kc[:, :, c], vc[:, :, c], gc[:, :, c]
        Lc, Lxc = L[:, :, c], Lx[:, :, c]
        Lt = Lc[:, :, -1:]
        dA = torch.einsum("bhie,bhje->bhij", gg, vv)  # bf16 inputs: one exact product each
        drI, dkI, dv = (torch.zeros((B, H, C, D), dtype=dt) for _ in range(3))
        AT = torch.zeros((B, H, C, C), dtype=dt)  # A^T[j][i]
        for w in range(C // SUB):
            b, Bn = w * SUB, w * SUB + SUB
            rows = slice(b, Bn)
            Lxb = Lxc[:, :, b:b + 1]
            LxB = Lc[:, :, Bn - 1:Bn]  # Lx of row B is L of row B - 1 (Lt for the last sub-chunk)
            # drI: the state's part, then the earlier sub-chunks', scaled twice
            acc = mm("bhie,bhde->bhid", gg[:, :, rows], S_prev[c], 1, 3) * e2(Lxb)
            if w:
                kp = kk[:, :, :b] * e2(Lxb - Lc[:, :, :b])
                acc = acc + mm("bhij,bhjd->bhid", dA[:, :, rows, :b], kp, 3, 3)
            drI[:, :, rows] = acc * e2(Lxc[:, :, rows] - Lxb)
            # dkI: the state's part, then the later sub-chunks', scaled twice
            acc = mm("bhje,bhde->bhjd", vv[:, :, rows], dS, 1, 3) * e2(Lt - LxB)
            if w < C // SUB - 1:
                rp = rr[:, :, Bn:] * e2(Lxc[:, :, Bn:] - LxB)
                acc = acc + mm("bhij,bhid->bhjd", dA[:, :, Bn:, rows], rp, 3, 3)
                kq = kk[:, :, rows] * e2(LxB - Lc[:, :, rows])
                AT[:, :, rows, Bn:] = mm("bhjd,bhid->bhji", kq, rp)
            dkI[:, :, rows] = acc * e2(LxB - Lc[:, :, rows])
            # dv's part through the state
            dv[:, :, rows] = mm("bhjd,bhde->bhje", kk[:, :, rows] * e2(Lt - Lc[:, :, rows]), dS)
            # the diagonal block: (3a) its rows 8.. against its columns ..7 through
            # the boundary m = b + 8; (3b) its two 8 x 8 blocks in f32, exp2(Lx_i - L_j)
            m = b + SUB // 2
            lo, hi = slice(b, m), slice(m, Bn)
            Lxm = Lc[:, :, m - 1:m]
            km = kk[:, :, lo] * e2(Lxm - Lc[:, :, lo])
            rm = rr[:, :, hi] * e2(Lxc[:, :, hi] - Lxm)
            drI[:, :, hi] += e2(Lxc[:, :, hi] - Lxm) * mm("bhij,bhjd->bhid", dA[:, :, hi, lo], km, 3, 3)
            dkI[:, :, lo] += e2(Lxm - Lc[:, :, lo]) * mm("bhij,bhid->bhjd", dA[:, :, hi, lo], rm, 3, 3)
            AT[:, :, lo, hi] = mm("bhjd,bhid->bhji", km, rm)
            for blk in (lo, hi):
                diff = Lxc[:, :, blk, None, :] - Lc[:, :, None, blk, :]  # (B, H, i, j, D)
                E = e2(torch.where(strict[..., None], diff, torch.zeros_like(diff)).clamp(max=0)) * strict[..., None]
                r_s, k_s, dA_s = rr[:, :, blk], kk[:, :, blk], dA[:, :, blk, blk]
                drI[:, :, blk] += torch.einsum("bhij,bhjd,bhijd->bhid", dA_s, k_s, E)
                dkI[:, :, blk] += torch.einsum("bhij,bhid,bhijd->bhjd", dA_s, r_s, E)
                A_s = torch.einsum("bhid,bhjd,bhijd->bhij", r_s, k_s, E)
                AT[:, :, blk, blk] = A_s.transpose(2, 3) + torch.diag_embed((r_s * uf * k_s).sum(-1))
        vdy = (vv * gg).sum(-1, keepdim=True)
        outs["dr"][:, :, c] = drI + uf * kk * vdy
        outs["dk"][:, :, c] = dkI + uf * rr * vdy
        du = du + (rr * kk * vdy).sum(2)
        for w in range(C // SUB):
            b = w * SUB
            dv[:, :, b:b + SUB] += mm("bhji,bhie->bhje", AT[:, :, b:b + SUB, b:], gg[:, :, b:], 2, 1)
        outs["dv"][:, :, c] = dv
        dS = dS * e2(Lt).transpose(2, 3) + mm("bhid,bhie->bhde", rr * e2(Lxc), gg, 3, 1)
        # dlogw: z_t = r_{t+1} drI_{t+1} - k_t dkI_t within the chunk, its suffix
        # sums within each warp's 16 rows, the later warps' sums and the carry of
        # the later chunks beside
        p, q = rr * drI, kk * dkI
        z = torch.cat([p[:, :, 1:], torch.zeros_like(p[:, :, :1])], dim=2) - q
        suf = z.reshape(B, H, C // SUB, SUB, D).flip(3).cumsum(3).flip(3)  # (B, H, warp, row, D)
        tot = suf[:, :, :, 0]  # each warp's sum
        later = tot.flip(2).cumsum(2).flip(2) - tot  # the sums of the warps after each
        outs["dlogw"][:, :, c] = (suf + (later + carry[:, :, None])[:, :, :, None]).reshape(B, H, C, D)
        carry = carry + tot.sum(2) + p[:, :, 0]

    def whole(a):  # (B, H, nc, C, D) -> (B, T, H, D)
        return a.reshape(B, H, nc * C, D)[:, :, :T].permute(0, 2, 1, 3)

    out_dt = torch.float64 if exact else r.dtype
    stat_dt = torch.float64 if exact else torch.float32
    return (whole(outs["dr"]).to(out_dt), whole(outs["dk"]).to(out_dt), whole(outs["dv"]).to(out_dt),
            whole(outs["dlogw"]).to(stat_dt), du.sum(0).to(stat_dt))


def _inputs(seed, B, T, H, strong=False):
    """chip_smoke.py's distributions: r, k, v ~ N(0, 0.25) and dy ~ N(0, 1) in
    bf16, logw = -exp(N(0, 0.25) - 2) (strong: + 2, about -7 a step), u ~ N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, 64), dtype=np.float32) * 0.5 for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, T, H, 64), dtype=np.float32) * 0.5 + (2.0 if strong else -2.0))
    u = rng.standard_normal((H, 64), dtype=np.float32) * 0.1
    dy = rng.standard_normal((B, T, H, 64), dtype=np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    return bf(r), bf(k), bf(v), torch.from_numpy(logw.astype(np.float32)), torch.from_numpy(u), bf(dy)


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


def _autograd64(r, k, v, logw, u, dy):
    leaves = [t.double().requires_grad_(True) for t in (r, k, v, logw, u)]
    return torch.autograd.grad(_sequential(*leaves), leaves, dy.double(), allow_unused=True)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else float(np.linalg.norm(got))


def allowance_used(name, got, want) -> float:
    """The largest |got - want| over atol + rtol |want|, at half chip_smoke's allowance for ``name``."""
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want.float() if isinstance(want, torch.Tensor) else want, np.float64)
    tol = HALF_ALLOWANCE[name]
    return float((np.abs(g - w) / (tol + tol * np.abs(w))).max())


@pytest.mark.parametrize("T", TS)
def test_exact_order_matches_autograd_of_the_recurrence(T):
    """With no rounding the order's algebra is the recurrence's gradient."""
    r, k, v, logw, u, dy = _inputs(T, 2, T, 2)
    got = chunk_bwd_order(r, k, v, logw, u, dy, exact=True)
    want = _autograd64(r, k, v, logw, u, dy)
    for name, g, w in zip(NAMES, got, want):
        assert torch.isfinite(g).all(), name
        if w is None:  # T = 1: y does not read logw
            assert name == "dlogw" and not g.any()
            continue
        assert _rel(g, w) <= 1e-10, (name, _rel(g, w))


@pytest.mark.parametrize("T", TS)
def test_rounded_order_within_half_the_allowance_of_the_plain_backward(T):
    r, k, v, logw, u, dy = _inputs(100 + T, 2, T, 2)
    got = chunk_bwd_order(r, k, v, logw, u, dy)
    want = wkv_mod.wkv6_bwd_plain(r, k, v, logw, u, dy, chunk=64)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert allowance_used(name, g, w) <= 1.0, (name, allowance_used(name, g, w))


@pytest.mark.parametrize("T", TS)
def test_rounded_order_within_half_the_allowance_of_the_reference_vjp(T):
    """jax.vjp of the reference's _wkv_chunked on the same numbers, T padded
    to its chunk of 64 with zeros and y cut back, as rwkv6_apply does."""
    r, k, v, logw, u, dy = _inputs(200 + T, 2, T, 2)
    got = chunk_bwd_order(r, k, v, logw, u, dy)
    pad = (-T) % C

    def ref(r_, k_, v_, w_, u_):
        padf = lambda a: jnp.pad(a, [(0, 0), (0, pad), (0, 0), (0, 0)])  # noqa: E731
        return ref_rwkv._wkv_chunked(padf(r_), padf(k_), padf(v_), padf(w_), u_, C)[0][:, :T]

    f32 = [jnp.asarray(t.float().numpy()) for t in (r, k, v, logw, u)]
    _, vjp = jax.vjp(ref, *f32)
    want = vjp(jnp.asarray(dy.float().numpy()))
    for name, g, w in zip(NAMES, got, want):
        assert allowance_used(name, g, np.asarray(w)) <= 1.0, (name, allowance_used(name, g, np.asarray(w)))


@pytest.mark.parametrize("T", [129, 300])
def test_strong_decay_stays_finite_where_the_chunked_plain_backward_overflows(T):
    """logw about -7 a step: the plain chunked form's exp(-L) overflows f32;
    the order forms no positive exponent and stays with the recurrence."""
    r, k, v, logw, u, dy = _inputs(300 + T, 1, T, 2, strong=True)
    assert float(logw[:, :C].sum(1).min()) < -88 * 2
    plain = wkv_mod.wkv6_bwd_plain(r, k, v, logw, u, dy, chunk=64)
    assert not all(torch.isfinite(g).all() for g in plain)
    got = chunk_bwd_order(r, k, v, logw, u, dy)
    assert all(torch.isfinite(g).all() for g in got)
    want = _autograd64(r, k, v, logw, u, dy)
    for name, g, w in zip(NAMES, got, want):
        assert allowance_used(name, g, w) <= 1.0, (name, allowance_used(name, g, w))


@pytest.mark.parametrize("T", [512])
def test_rounded_order_within_half_the_allowance_at_the_training_length(T):
    """RWKV-6 7B trains on 512 steps: eight chunks of dlogw's running sum."""
    r, k, v, logw, u, dy = _inputs(400 + T, 1, T, 2)
    got = chunk_bwd_order(r, k, v, logw, u, dy)
    want = wkv_mod.wkv6_bwd_plain(r, k, v, logw, u, dy, chunk=64)
    for name, g, w in zip(NAMES, got, want):
        assert allowance_used(name, g, w) <= 1.0, (name, allowance_used(name, g, w))


def test_the_chunked_route_is_chosen_by_dtype_and_shape_alone():
    """bf16 at head size 64, T from CHUNKED_BWD_T_MIN on, rows aligned: the
    rule the C entry point applies, exported beside the forward's threshold."""
    t_min = wkv_mod.CHUNKED_BWD_T_MIN
    assert isinstance(t_min, int) and 2 <= t_min <= 512
    assert wkv_mod.bwd_chunked(torch.bfloat16, t_min, 64, True)
    assert wkv_mod.bwd_chunked(torch.bfloat16, 512, 64, True)
    assert not wkv_mod.bwd_chunked(torch.bfloat16, t_min - 1, 64, True)
    assert not wkv_mod.bwd_chunked(torch.float32, 512, 64, True)
    assert not wkv_mod.bwd_chunked(torch.bfloat16, 512, 32, True)
    assert not wkv_mod.bwd_chunked(torch.bfloat16, 512, 64, False)
