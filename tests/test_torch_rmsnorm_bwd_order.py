"""The order of K1's backward kernels, held on the CPU.

``csrc/rmsnorm.cu`` computes RMSNorm's backward in two kernels.  In the first
(``rmsnorm_bwd_reg_kernel<T, NT>`` for rows of whole 16-byte chunks up to 4096
elements) block b of a grid of G owns rows b, b + G, ...; thread t holds chunks
t, t + NT, ... (kBwdChunks of them) of a row, sums x^2 and (dy scale) x over its
columns, the warps meet by butterfly shuffles and the warps' sums are added in
order; each thread adds dy x r into its columns' dscale partial, row after row.
The second (``rmsnorm_bwd_reduce_kernel``) sums the G partial rows of a column
in 64 row lanes (lane l: rows l, l + 64, ... in order), meets the 8 lanes of a
warp by shuffles and adds the 8 warps in order.  ``kernel_order`` repeats that
in plain torch; on inputs made with numpy from a seed it must agree with the
port's plain backward and with ``jax.vjp`` of the reference's
``repro.models.modules.rmsnorm``, for every grid size, so that a case that
fails on the card points to a fault in the kernel and not to its order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import modules as ref_modules
from repro_torch.kernels import rmsnorm as rms_mod
from torch_helpers import as_f32, to_jax, to_torch

# as tests/test_torch_backward.py: f32 sums over every row in another order;
# bf16 one rounding of dx to bf16 on top
BWD_TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
EPS = 1e-6
CHUNKS = 4  # kBwdChunks: 16-byte chunks of a row a thread holds
RED_LANES, RED_BATCH, WARP = 64, 8, 32  # kRedLanes, kRedBatch of the reduction


def threads_for(d: int, itemsize: int) -> int:
    """A block's threads (bwd_threads in csrc/rmsnorm.cu): the fewest of 32, 64,
    ... whose chunks cover the row."""
    nt = 32
    while nt * CHUNKS * (16 // itemsize) < d:
        nt *= 2
    return nt


def butterfly(v: torch.Tensor, offsets) -> torch.Tensor:
    """``v += __shfl_xor_sync(v, o)`` for each o, over the last axis (a warp's lanes)."""
    lane = torch.arange(v.shape[-1])
    for o in offsets:
        v = v + v[..., lane ^ o]
    return v


def block_sums(per_thread: torch.Tensor) -> torch.Tensor:
    """(rows, NT) -> (rows,): warp_sum, then the warps' sums in order."""
    warps = butterfly(per_thread.reshape(per_thread.shape[0], -1, WARP), (16, 8, 4, 2, 1))[..., 0]
    total = torch.zeros(per_thread.shape[0])
    for w in range(warps.shape[1]):
        total = total + warps[:, w]
    return total


def reduce_partials(partial: torch.Tensor) -> torch.Tensor:
    """(G, d) -> (d,) in rmsnorm_bwd_reduce_kernel's order."""
    G, d = partial.shape
    lanes = torch.zeros(RED_LANES, d)
    for b0 in range(0, G, RED_BATCH * RED_LANES):  # a lane's batch of loads, then its adds in row order
        for u in range(RED_BATCH):
            for lane in range(RED_LANES):
                b = b0 + lane + u * RED_LANES
                if b < G:
                    lanes[lane] = lanes[lane] + partial[b]
    # a warp's lanes are 8 row lanes x 4 column threads: row lanes meet at xor 4, 8, 16
    warps = butterfly(lanes.reshape(-1, WARP // 4, d).transpose(1, 2), (1, 2, 4))[..., 0]
    total = torch.zeros(d)
    for w in range(warps.shape[0]):
        total = total + warps[w]
    return total


def kernel_order(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, grid: int, eps: float = EPS):
    """(dx in x's dtype, dscale f32, partial (grid, d)) as the two kernels
    compute them for x and dy (n, d), with ``grid`` blocks."""
    n, d = x.shape
    nt = threads_for(d, x.element_size())
    width = CHUNKS * nt * (16 // x.element_size())  # a block's register tile; zeros past d
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, width - d))  # noqa: E731
    xs, gs = pad(x), pad(dy)
    sc = pad(scale[None])[0]
    # chunk c = t + i * NT: element e of the tile is thread (e // V) % NT's
    vec = 16 // x.element_size()
    thread_of = (torch.arange(width) // vec) % nt
    ss = torch.zeros(n, nt)
    gx = torch.zeros(n, nt)
    for e in range(width):  # a thread's chunks in i, their elements in j: ascending e
        t = thread_of[e]
        ss[:, t] = ss[:, t] + xs[:, e] * xs[:, e]
        gx[:, t] = gx[:, t] + gs[:, e] * sc[e] * xs[:, e]
    r = torch.rsqrt(block_sums(ss) / d + eps)[:, None]
    coef = r * r * r * (block_sums(gx)[:, None] / d)
    dx = (r * gs * sc - xs * coef)[:, :d].to(x.dtype)
    partial = torch.zeros(grid, d)
    for b in range(grid):
        for row in range(b, n, grid):
            partial[b] = partial[b] + gs[row, :d] * xs[row, :d] * r[row]
    return dx, reduce_partials(partial), partial


N_ROWS = 21


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [96, 1000])
@pytest.mark.parametrize("grid", [1, 7, 5, N_ROWS])  # 5 does not divide 21
def test_kernel_order_matches_plain_and_reference(grid, d, dtype):
    rng = np.random.default_rng(grid * 1000 + d)
    x = rng.standard_normal((N_ROWS, d), dtype=np.float32) * 2
    scale = rng.standard_normal(d, dtype=np.float32)
    dy = rng.standard_normal((N_ROWS, d), dtype=np.float32)
    tx, tdy, tscale = to_torch(x, dtype), to_torch(dy, dtype), torch.from_numpy(scale)
    dx, dscale, partial = kernel_order(tx, tscale, tdy, grid)
    assert dx.dtype == tx.dtype and dx.shape == tx.shape and dscale.shape == (d,)
    assert partial.shape == (grid, d)

    want_dx, want_dscale = rms_mod.rmsnorm_bwd_plain(tx, tscale, tdy, EPS)
    np.testing.assert_allclose(as_f32(dx), as_f32(want_dx), **BWD_TOL[dtype])
    np.testing.assert_allclose(as_f32(dscale), as_f32(want_dscale), **BWD_TOL[dtype])

    _, vjp = jax.vjp(lambda s, a: ref_modules.rmsnorm(s, a, EPS), jnp.asarray(scale), to_jax(x, dtype))
    ref_dscale, ref_dx = vjp(to_jax(dy, dtype))
    np.testing.assert_allclose(as_f32(dx), as_f32(ref_dx), **BWD_TOL[dtype])
    np.testing.assert_allclose(as_f32(dscale), as_f32(ref_dscale), **BWD_TOL[dtype])


@pytest.mark.parametrize("grid", [1, 7, 5, N_ROWS])
def test_every_row_lands_in_one_partial(grid):
    """The blocks' rows cover every row once: with dy x r set to one-hot rows,
    the partials hold each row exactly once and the reduction adds them all."""
    d = 64
    partial = torch.zeros(grid, d)
    for b in range(grid):
        for row in range(b, N_ROWS, grid):
            partial[b, row] += 1.0
    assert torch.equal(partial.sum(dim=0)[:N_ROWS], torch.ones(N_ROWS))
    assert torch.equal(reduce_partials(partial), partial.sum(dim=0))


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 342, 511, 512, 513, 528, 1100])
def test_reduction_order_takes_every_partial_row(rows):
    """Partial counts around the lanes (64) and a lane's batch (8 x 64): row b
    carries 2**-(b % 20) in column 0 and b in column 1, so a row left out or
    taken twice shows exactly."""
    b = torch.arange(rows, dtype=torch.float32)
    partial = torch.stack([torch.pow(2.0, -(b % 20)), b, torch.ones(rows)], dim=1)
    got = reduce_partials(partial)
    assert got[1].item() == rows * (rows - 1) / 2 and got[2].item() == rows
    assert got[0].item() == pytest.approx(partial[:, 0].double().sum().item(), rel=1e-6)


@pytest.mark.parametrize("d,itemsize,want", [(4096, 2, 128), (3072, 2, 128), (2048, 2, 64), (1024, 2, 32),
                                             (4096, 4, 256), (2048, 4, 128), (64, 2, 32)])
def test_threads_cover_the_row(d, itemsize, want):
    """GPT-A's d_model 4096 in bf16 is 128 threads of 32 elements, in f32 256 of
    16; Minitron-4B's 3072 leaves the last chunk of every thread empty; 2048 and
    1024 take fewer threads."""
    nt = threads_for(d, itemsize)
    span = CHUNKS * (16 // itemsize)  # elements a thread holds
    assert nt == want
    assert nt * span >= d and (nt == 32 or nt // 2 * span < d)
