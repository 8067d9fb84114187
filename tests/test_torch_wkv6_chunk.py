"""The order of operations of the bf16 WKV-6 kernel on the tensor cores, held on the CPU.

``csrc/wkv6.cu``'s ``wkv6_chunk_kernel`` (bf16 r, k, v, head size 64, T of at
least ``CHUNKED_T_MIN``) runs the recurrence in chunks of 64 steps with the
64 x 64 state carried in f32.  ``chunk_order`` below repeats its arithmetic in
plain torch: every product of ``mma.sync`` has bf16 operands and f32 sums,
and an operand that is not a bf16 input is split into a bf16 high part and a
bf16 low part (``mma3``: hi hi + hi lo + lo hi; ``mma2`` against V, which is
exact in bf16).  Per chunk and key channel d, with L the inclusive cumulative
log decay, Lx the exclusive one and Lt the chunk's total:

* rows i of sub-chunk I (16 rows from b = 16 I) against earlier sub-chunks:
  ``A[i, j] = sum_d r'[i, d] k'[j, d]`` with ``r' = r exp(Lx_i - Lx_b)`` and
  ``k' = k exp(Lx_b - L_j)``: both exponents are <= 0;
* within sub-chunk I: its rows 8.. against its columns ..7 as above with the
  boundary b + 8; its two 8 x 8 diagonal blocks on the CUDA cores in f32,
  ``A[i, j] = sum_d r k exp(Lx_i - L_j)`` for j < i, and the bonus
  ``sum_d r u k`` at j = i;
* ``y = A V + (r exp(Lx)) S_prev``;
* ``S <- exp(Lt) S + (k exp(Lt - L))^T V``.

Rounded once to bf16, the operands take y from the recurrence by nearly all
of the allowance below; split, y keeps little more than its own rounding.
``test_state_split_decides_the_rounding_of_the_state_operand`` shows the
split of S_prev on its own.  No exp anywhere has a positive argument, so the
order stays finite where the chunked plain form (``wkv6_plain``, ``exp(-L)``)
overflows.  On inputs made
with numpy from a seed it must stay within half of ``chip_smoke.py``'s bf16
allowance of the port's plain version and of the JAX reference, so that a
failure on the card points to a fault and not to the design's roundings.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import rwkv as ref_rwkv
from repro_torch.kernels.wkv6 import wkv6_plain
from torch_helpers import BF16_TOL, as_f32

C = 64  # steps a chunk
SUB = 16  # rows a sub-chunk: one warp's rows of an m16n8k16 product
# S_prev as the B operand of y's inter-chunk product: split into a bf16 high
# and low part (True) or rounded once (False); the kernel splits it
STATE_SPLIT = True
F32_STATE = dict(atol=2e-4, rtol=2e-4)  # chip_smoke.py holds the f32 state so
STRONG_TOL = 2e-2


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def split(x: torch.Tensor):
    """A bf16 high part and a bf16 low part: x = hi + lo to about 2**-16."""
    hi = bf16(x)
    return hi, bf16(x - hi)


def mma3(eq: str, a: torch.Tensor, b: torch.Tensor, b_split: bool = True) -> torch.Tensor:
    """a @ b as three bf16 products with f32 sums: hi hi + hi lo + lo hi (b_split
    False: b rounded once, a hi + lo against it)."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    out = torch.einsum(eq, a_hi, b_hi) + torch.einsum(eq, a_lo, b_hi)
    return out + torch.einsum(eq, a_hi, b_lo) if b_split else out


def mma2(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for b exact in bf16 (V): a's high and low parts, two products."""
    a_hi, a_lo = split(a)
    return torch.einsum(eq, a_hi, b) + torch.einsum(eq, a_lo, b)


def chunk_order(r, k, v, logw, u, S0=None, *, state_split: bool = STATE_SPLIT):
    """r, k, v (B, T, H, 64) bf16, logw (B, T, H, 64) f32, u (H, 64) f32,
    S0 (B, H, 64, 64) f32 or None -> y (B, T, H, 64) bf16, final state f32."""
    B, T, H, D = r.shape
    nc = -(-T // C)
    pad = nc * C - T

    def chunks(a):  # (B, H, nc, C, D); pad rows read as zeros
        return torch.nn.functional.pad(a.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3).reshape(B, H, nc, C, D)

    rc, kc, vc, lw = chunks(r), chunks(k), chunks(v), chunks(logw)
    S = torch.zeros((B, H, D, D)) if S0 is None else S0.float().clone()
    uf = u.float()[None, :, None, :]  # (1, H, 1, D)
    strict = torch.tril(torch.ones(8, 8, dtype=torch.bool), diagonal=-1)
    ys = []
    for c in range(nc):
        rr, kk, vv = rc[:, :, c], kc[:, :, c], vc[:, :, c]  # (B, H, C, D)
        L = lw[:, :, c].cumsum(2)
        Lx = torch.cat([torch.zeros_like(L[:, :, :1]), L[:, :, :-1]], dim=2)
        Lt = L[:, :, -1:]  # (B, H, 1, D)
        A = torch.zeros((B, H, C, C))
        for I in range(C // SUB):
            b = I * SUB
            rows = slice(b, b + SUB)
            if I:
                r_ = rr[:, :, rows] * torch.exp(Lx[:, :, rows] - Lx[:, :, b:b + 1])
                k_ = kk[:, :, :b] * torch.exp(Lx[:, :, b:b + 1] - L[:, :, :b])
                A[:, :, rows, :b] = mma3("bhid,bhjd->bhij", r_, k_)
            # within the sub-chunk: its two 8 x 8 diagonal blocks in f32, exp of
            # Lx_i - L_j (<= 0 for j < i), the bonus at j = i; rows 8.. against
            # columns ..7 as above with the boundary b + 8
            for blk in range(2):
                sub = slice(b + 8 * blk, b + 8 * blk + 8)
                diff = Lx[:, :, sub, None, :] - L[:, :, None, sub, :]  # (B, H, i, j, D)
                e = torch.exp(torch.where(strict[..., None], diff, torch.zeros_like(diff)))
                diag = torch.einsum("bhid,bhjd,bhijd->bhij", rr[:, :, sub], kk[:, :, sub], e) * strict
                bonus = (rr[:, :, sub] * uf * kk[:, :, sub]).sum(-1)
                A[:, :, sub, sub] = diag + torch.diag_embed(bonus)
            m = b + 8
            r_ = rr[:, :, m:m + 8] * torch.exp(Lx[:, :, m:m + 8] - Lx[:, :, m:m + 1])
            k_ = kk[:, :, b:m] * torch.exp(Lx[:, :, m:m + 1] - L[:, :, b:m])
            A[:, :, m:m + 8, b:m] = mma3("bhid,bhjd->bhij", r_, k_)
        y = mma2("bhij,bhje->bhie", A, vv) + mma3("bhid,bhde->bhie", rr * torch.exp(Lx), S, state_split)
        ys.append(y)
        S = S * torch.exp(Lt).transpose(2, 3) + mma2("bhjd,bhje->bhde", kk * torch.exp(Lt - L), vv)
    y = torch.stack(ys, dim=2).reshape(B, H, nc * C, D)[:, :, :T].permute(0, 2, 1, 3)
    return y.to(torch.bfloat16), S


def _inputs(seed, B, T, H, state, strong=False):
    """chip_smoke.py's distributions: r, k, v ~ N(0, 0.25) in bf16, logw =
    -exp(N(0, 0.25) - 2) (strong: + 2), u ~ N(0, 0.01), S0 ~ N(0, 0.25)."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, 64), dtype=np.float32) * 0.5).to(torch.bfloat16)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, T, H, 64), dtype=np.float32) * 0.5 + (2.0 if strong else -2.0))
    u = rng.standard_normal((H, 64), dtype=np.float32) * 0.1
    S0 = rng.standard_normal((B, H, 64, 64), dtype=np.float32) * 0.5 if state else None
    return r, k, v, torch.from_numpy(logw.astype(np.float32)), torch.from_numpy(u), \
        None if S0 is None else torch.from_numpy(S0)


def allowance_used(got, want) -> float:
    """The largest |got - want| over chip_smoke's atol + rtol * |want|."""
    g, w = as_f32(got), as_f32(want)
    return float((np.abs(g - w) / (BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(w))).max())


def sequential64(r, k, v, logw, u, S0=None):
    """The recurrence one step at a time in float64: (y, final state)."""
    f = lambda a: np.asarray(as_f32(a), np.float64)
    r, k, v, logw, u = f(r), f(k), f(v), f(logw), f(u)
    B, T, H, D = r.shape
    S = np.zeros((B, H, D, D)) if S0 is None else f(S0).copy()
    y = np.zeros((B, T, H, D))
    for t in range(T):
        kv = np.einsum("bhd,bhe->bhde", k[:, t], v[:, t])
        y[:, t] = np.einsum("bhd,bhde->bhe", r[:, t], S + u[None, :, :, None] * kv)
        S = S * np.exp(logw[:, t])[..., None] + kv
    return y, S


# T: one chunk, one step past it, two chunks and one past, ragged 300; the
# Pallas kernel and the model's chunked form take a chunk that divides T
CASES = [(64, 64), (65, 13), (129, 43), (300, 60)]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("T,ref_chunk", CASES)
def test_chunk_order_within_half_the_bf16_allowance(T, ref_chunk, state):
    r, k, v, logw, u, S0 = _inputs(T + int(state), 2, T, 2, state)
    y, S = chunk_order(r, k, v, logw, u, S0)
    assert y.dtype == torch.bfloat16 and y.shape == (2, T, 2, 64) and S.dtype == torch.float32
    y_plain, S_plain = wkv6_plain(r, k, v, logw, u, S0)
    assert allowance_used(y, y_plain) <= 0.5
    np.testing.assert_allclose(S.numpy(), S_plain.numpy(), **F32_STATE)
    jr, jk, jv, jw, ju = (jnp.asarray(as_f32(a)) for a in (r, k, v, logw, u))
    if state:
        y_ref, S_ref = ref_rwkv._wkv_chunked(jr, jk, jv, jw, ju, ref_chunk, jnp.asarray(S0.numpy()))
        np.testing.assert_allclose(S.numpy(), as_f32(S_ref), **F32_STATE)
        assert allowance_used(y, y_ref) <= 0.5
    else:
        assert allowance_used(y, ref_ref.wkv6_ref(jr, jk, jv, jw, ju)) <= 0.5
        assert allowance_used(y, ref_ops.wkv6(jr, jk, jv, jw, ju, chunk=ref_chunk)) <= 0.5


def test_state_split_decides_the_rounding_of_the_state_operand():
    """S_prev enters y's product split into bf16 high and low parts: that takes
    the state's rounding out of y, where the high part alone leaves a relative
    2**-9 of r exp(Lx) S_prev in every output."""
    r, k, v, logw, u, S0 = _inputs(1, 2, 129, 2, True)
    y64, _ = sequential64(r, k, v, logw, u, S0)
    used = {split_: allowance_used(chunk_order(r, k, v, logw, u, S0, state_split=split_)[0], y64)
            for split_ in (True, False)}
    assert STATE_SPLIT and used[True] <= 0.25 < 0.5 < used[False]


@pytest.mark.parametrize("state", [False, True])
def test_strong_decay_stays_finite_where_the_plain_form_overflows(state):
    """logw about -7 a step (-470 a chunk): exp(-L) overflows f32 in the
    chunked plain form; the kernel's order forms no positive exponent."""
    r, k, v, logw, u, S0 = _inputs(7, 1, 129, 2, state, strong=True)
    assert float(logw.sum(1).min()) < -88 * 2  # exp(-L) over a chunk is past f32's range
    y_plain, S_plain = wkv6_plain(r, k, v, logw, u, S0)
    assert not (torch.isfinite(y_plain.float()).all() and torch.isfinite(S_plain).all())
    y, S = chunk_order(r, k, v, logw, u, S0)
    assert torch.isfinite(y.float()).all() and torch.isfinite(S).all()
    y64, S64 = sequential64(r, k, v, logw, u, S0)
    np.testing.assert_allclose(as_f32(y), y64, atol=STRONG_TOL, rtol=STRONG_TOL)
    np.testing.assert_allclose(S.numpy(), S64, **F32_STATE)
