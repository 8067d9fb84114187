"""The rounding of the bf16 flash kernel's design, held on the CPU.

``csrc/flash_attention.cu``'s ``flash_mma_kernel`` computes the scores in f32
from bf16 Q and K, scales them after the product, runs the online softmax over
tiles of 64 keys, and rounds P to bf16 before P·V (f32 sums), then rounds the
output once.  The plain versions round only the output.  ``mma_order`` below
repeats the kernel's order of operations in plain torch; on bf16 inputs made
with numpy from a seed it must stay within half of ``chip_smoke.py``'s bf16
allowance (atol = rtol = 2e-2) of both the port's plain version and the JAX
reference, so that a case that fails that allowance on the card points to a
fault and not to the design's one extra rounding.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_ref
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_plain
from torch_helpers import BF16_TOL, as_f32, to_jax, to_torch

TILE = 64  # keys a tile, as the kernel's BN


def mma_order(q, k, v, *, causal: bool) -> torch.Tensor:
    """q (B, T, Hq, D), k and v (B, S, Hkv, D) bf16 -> (B, T, Hq, D) bf16, in the kernel's order."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    scale = D**-0.5
    qf = q.float().reshape(B, T, Hkv, Hq // Hkv, D)
    m = torch.full((B, Hkv, Hq // Hkv, T, 1), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, Hq // Hkv, T, D))
    for k0 in range(0, S, TILE):
        s = torch.einsum("btkgd,bskd->bkgts", qf, k[:, k0:k0 + TILE].float()) * scale
        if causal:
            hidden = torch.arange(T)[:, None] < torch.arange(k0, min(k0 + TILE, S))[None, :]
            s = s.masked_fill(hidden, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p16 = p.to(torch.bfloat16).float()  # the one rounding the plain versions do not make
        acc = acc * alpha + torch.einsum("bkgts,bskd->bkgtd", p16, v[:, k0:k0 + TILE].float())
        m = m_new
    return (acc / l).permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


def allowance_used(got, want) -> float:
    """The largest |got - want| over chip_smoke's atol + rtol * |want|."""
    g, w = as_f32(got), as_f32(want)
    return float((np.abs(g - w) / (BF16_TOL["atol"] + BF16_TOL["rtol"] * np.abs(w))).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 80, 128])  # 80: HuBERT-XLarge
def test_mma_rounding_within_half_the_bf16_allowance(D, causal):
    rng = np.random.default_rng(D + int(causal))
    q, k, v = (rng.standard_normal((1, 512, 4, D), dtype=np.float32) for _ in range(3))
    tq, tk, tv = (to_torch(a, "bfloat16") for a in (q, k, v))
    got = mma_order(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 512, 4, D)
    plain = flash_attention_plain(tq, tk, tv, causal=causal)
    reference = ref_ref.flash_attention_ref(*(to_jax(a, "bfloat16") for a in (q, k, v)), causal=causal)
    assert allowance_used(got, plain) <= 0.5
    assert allowance_used(got, reference) <= 0.5
