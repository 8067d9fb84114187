"""The order of K2's bf16 backward kernels, held on the CPU.

``csrc/flash_attention_bwd.cu`` computes attention's backward in three
kernels.  ``flash_bwd_rowsum_kernel`` takes D = rowsum(dO o) a row at a time:
each lane sums the products of one 16-byte piece in order, and the lanes of a
row (its pieces, rounded up to a power of two) meet by butterfly shuffles.  In
bf16 the other two run on ``wgmma``:

- ``flash_bwd_wg_dkdv_kernel`` gives a block 128 keys of one (batch, kv head),
  64 to each of its two warpgroups.  For every head of the group and every
  query step of 64 rows, from the first step that sees the block's keys when
  causal: S^T = K Q^T and dP^T = V dO^T in f32, P^T =
  exp2(S^T scale log2(e) - lse log2(e)), dS^T = P^T (dP^T - D), then dV += P^T
  dO and dK += dS^T Q with P^T and dS^T rounded to bf16; a warpgroup whose keys
  all follow the step's queries skips it.  dK is scaled once at the end.
- ``flash_bwd_wg_dq_kernel`` gives a block 128 query rows of one (batch,
  head), 64 to each warpgroup, and walks key tiles of 64 up to the tile of the
  block's last row when causal: S = Q K^T, dP = dO V^T, dS = P (dP - D), dQ +=
  dS K with dS rounded to bf16, skipping tiles whose keys all follow the
  warpgroup's rows; dQ is scaled once at the end.

Rows past T and keys past S weigh exactly 0; a causally hidden key's
exponent is the finite -2^30 less the row's lse.  ``kernel_order`` repeats
that in plain torch.  On inputs made with numpy from a seed it must agree with
the port's plain backward within half of the bf16 allowance that
``chip_smoke.py`` holds the kernels to (so that a case that fails there points
to a fault, not to the design), and with ``jax.vjp`` of the reference's
``repro.kernels.ref.flash_attention_ref`` within the whole of it, at every
head size the kernels take, causal and full, groups of 1 to 3, ragged T and T
!= S.  ``visits`` repeats the two kernels' plans and shows that each kernel
meets every (query, key) pair that is not masked exactly once.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro_torch.kernels import flash_attention as fa_mod
from torch_helpers import as_f32, to_jax, to_torch

LOG2E = 1.4426950408889634
# a block's rows, a warpgroup's, a dK/dV query step, a dQ key tile
BLK, WG_ROWS, QN, KEY_TILE = 128, 64, 64, 64
ALLOW = dict(atol=2e-2, rtol=2e-2)  # chip_smoke.py's BWD_TOL for bf16


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def rowsum_order(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) bf16 -> (B, H, T) f32 as flash_bwd_rowsum_kernel sums: 8
    products a 16-byte piece in order, then a butterfly over the row's lanes."""
    B, T, H, D = o.shape
    pieces = D // 8
    lanes = 1 << max(2, (pieces - 1).bit_length())
    prod = (o.float() * do.float()).reshape(B, T, H, pieces, 8)
    part = torch.zeros(B, T, H, lanes)
    for i in range(8):
        part[..., :pieces] = part[..., :pieces] + prod[..., i]
    idx = torch.arange(lanes)
    off = lanes // 2
    while off:
        part = part + part[..., idx ^ off]
        off //= 2
    return part[..., 0].permute(0, 2, 1)


def probabilities(s, lq, rows, cols, T, S, causal, scale):
    """exp2 of the scores with the scale and log2(e) folded, masked as the kernels mask."""
    x = s * (scale * LOG2E) - lq
    if causal:
        x = torch.where(cols > rows, fa_mod.NEG_INF - lq, x)
    return torch.where((rows < T) & (cols < S), torch.exp2(x), torch.zeros_like(x))


def kernel_order(q, k, v, o, lse, do, *, causal: bool):
    """(dq, dk, dv) in bf16 as the two wgmma kernels compute them."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G, scale = Hq // Hkv, D**-0.5
    pad_t, pad_s = -T % BLK + BLK, -S % BLK + BLK  # zero rows past T and S, as the copies fill them
    qp, dop = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad_t)) for x in (q, do))
    kp, vp = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad_s)) for x in (k, v))
    lq = torch.nn.functional.pad(lse * LOG2E, (0, pad_t))  # (B, Hq, T + pad)
    dr = torch.nn.functional.pad(rowsum_order(o, do), (0, pad_t))

    dk = torch.zeros(B, S, Hkv, D)
    dv = torch.zeros(B, S, Hkv, D)
    for k0 in range(0, S, BLK):
        first = k0 // QN if causal else 0
        for kw0 in (k0, k0 + WG_ROWS):
            if kw0 >= S:
                continue
            kw, vw = kp[:, kw0:kw0 + WG_ROWS], vp[:, kw0:kw0 + WG_ROWS]  # (B, 64, Hkv, D)
            keys = kw0 + torch.arange(WG_ROWS)[:, None]
            acc_k, acc_v = torch.zeros(B, Hkv, WG_ROWS, D), torch.zeros(B, Hkv, WG_ROWS, D)
            for g in range(G):
                heads = torch.arange(Hkv) * G + g
                for q0 in range(first * QN, T, QN):
                    if causal and q0 + QN <= kw0:
                        continue
                    qs, dos = qp[:, q0:q0 + QN, heads], dop[:, q0:q0 + QN, heads]  # (B, QN, Hkv, D)
                    lqs = lq[:, heads, q0:q0 + QN][:, :, None, :]
                    drs = dr[:, heads, q0:q0 + QN][:, :, None, :]
                    st = torch.einsum("bkhd,bqhd->bhkq", kw, qs)
                    p = probabilities(st, lqs, q0 + torch.arange(QN)[None, :], keys, T, S, causal, scale)
                    acc_v = acc_v + torch.einsum("bhkq,bqhd->bhkd", bf16(p), dos)
                    ds = p * (torch.einsum("bkhd,bqhd->bhkq", vw, dos) - drs)
                    acc_k = acc_k + torch.einsum("bhkq,bqhd->bhkd", bf16(ds), qs)
            n = min(WG_ROWS, S - kw0)
            dk[:, kw0:kw0 + n] = (acc_k * scale).permute(0, 2, 1, 3)[:, :n]
            dv[:, kw0:kw0 + n] = acc_v.permute(0, 2, 1, 3)[:, :n]

    dq = torch.zeros(B, T, Hq, D)
    krep, vrep = kp.repeat_interleave(G, dim=2), vp.repeat_interleave(G, dim=2)
    for q0 in range(0, T, BLK):
        nk = -(-S // KEY_TILE)
        if causal:
            nk = min(nk, (q0 + BLK - 1) // KEY_TILE + 1)
        for qw0 in (q0, q0 + WG_ROWS):
            if qw0 >= T:
                continue
            qw, dow = qp[:, qw0:qw0 + WG_ROWS], dop[:, qw0:qw0 + WG_ROWS]  # (B, 64, Hq, D)
            lqw, drw = lq[:, :, qw0:qw0 + WG_ROWS, None], dr[:, :, qw0:qw0 + WG_ROWS, None]
            rows = qw0 + torch.arange(WG_ROWS)[:, None]
            acc = torch.zeros(B, Hq, WG_ROWS, D)
            for kt in range(nk):
                k0 = kt * KEY_TILE
                if causal and k0 > qw0 + WG_ROWS - 1:
                    continue
                kt_, vt = krep[:, k0:k0 + KEY_TILE], vrep[:, k0:k0 + KEY_TILE]
                s = torch.einsum("bqhd,bkhd->bhqk", qw, kt_)
                p = probabilities(s, lqw, rows, k0 + torch.arange(KEY_TILE)[None, :], T, S, causal, scale)
                ds = p * (torch.einsum("bqhd,bkhd->bhqk", dow, vt) - drw)
                acc = acc + torch.einsum("bhqk,bkhd->bhqd", bf16(ds), kt_)
            n = min(WG_ROWS, T - qw0)
            dq[:, qw0:qw0 + n] = (acc * scale).permute(0, 2, 1, 3)[:, :n]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def visits(T: int, S: int, causal: bool):
    """How often each kernel's plan meets each (query, key) pair: two (T, S) counts."""
    dkdv, dq = torch.zeros(T, S, dtype=torch.int64), torch.zeros(T, S, dtype=torch.int64)
    for k0 in range(0, S, BLK):
        for kw0 in (k0, k0 + WG_ROWS):
            for q0 in range((k0 // QN) * QN if causal else 0, T, QN):
                if kw0 < S and not (causal and q0 + QN <= kw0):
                    dkdv[q0:q0 + QN, kw0:kw0 + WG_ROWS] += 1
    for q0 in range(0, T, BLK):
        nk = -(-S // KEY_TILE)
        if causal:
            nk = min(nk, (q0 + BLK - 1) // KEY_TILE + 1)
        for qw0 in (q0, q0 + WG_ROWS):
            for k0 in range(0, nk * KEY_TILE, KEY_TILE):
                if qw0 < T and not (causal and k0 > qw0 + WG_ROWS - 1):
                    dq[qw0:qw0 + WG_ROWS, k0:k0 + KEY_TILE] += 1
    return dkdv, dq


def _inputs(seed, B, T, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, Hq, D), dtype=np.float32), rng.standard_normal((B, S, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, S, Hkv, D), dtype=np.float32), rng.standard_normal((B, T, Hq, D), dtype=np.float32))


# (B, T, S, Hq, Hkv): a group of 1 with ragged T = S below a block, of 2 over
# two blocks, of 3 with T < S and with T > S
SHAPES = [(1, 77, 77, 2, 2), (1, 150, 150, 4, 2), (1, 70, 200, 3, 1), (2, 200, 70, 3, 1)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
@pytest.mark.parametrize("B,T,S,Hq,Hkv", SHAPES)
def test_kernel_order_within_half_the_bf16_allowance(B, T, S, Hq, Hkv, D, causal):
    q, k, v, do = _inputs(D + T + S, B, T, S, Hq, Hkv, D)
    tq, tk, tv, tdo = (to_torch(a, "bfloat16") for a in (q, k, v, do))
    o, lse = fa_mod.flash_attention_plain(tq, tk, tv, causal=causal, return_lse=True)
    got = kernel_order(tq, tk, tv, o, lse, tdo, causal=causal)
    plain = fa_mod.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: ref_ref.flash_attention_ref(a, b, c, causal=causal),
                     *(to_jax(a, "bfloat16") for a in (q, k, v)))

    def used(g, w):
        g, w = as_f32(g), as_f32(w)
        return float((np.abs(g - w) / (ALLOW["atol"] + ALLOW["rtol"] * np.abs(w))).max())

    for got_i, plain_i, ref_i in zip(got, plain, vjp(to_jax(do, "bfloat16"))):
        assert got_i.shape == plain_i.shape and got_i.dtype == plain_i.dtype
        assert used(got_i, plain_i) <= 0.5
        assert used(got_i, ref_i) <= 1.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T,S", [(77, 77), (300, 300), (70, 200), (200, 70), (128, 256), (64, 64), (65, 129)])
def test_each_kernel_meets_every_unmasked_pair_once(T, S, causal):
    dkdv, dq = visits(T, S, causal)
    seen = torch.ones(T, S, dtype=torch.int64)
    if causal:
        seen = torch.tril(seen)
    assert torch.equal(dkdv * seen, seen) and torch.equal(dq * seen, seen)
    # a pair the plan meets is never met twice, masked or not
    assert int(dkdv.max()) <= 1 and int(dq.max()) <= 1


def test_rowsum_order_is_the_rows_dot_product():
    q, _, _, do = _inputs(7, 2, 9, 9, 3, 3, 80)
    o, g = to_torch(q, "bfloat16"), to_torch(do, "bfloat16")
    want = (o.float() * g.float()).sum(-1).permute(0, 2, 1)
    torch.testing.assert_close(rowsum_order(o, g), want, atol=1e-5, rtol=1e-5)
