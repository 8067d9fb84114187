"""The port's Mamba2 block (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``) on the same numpy inputs: the causal
convolution, the chunked SSD scan, ``mamba2_apply`` in its three cases, the
gated norm through ``modules.rmsnorm``, the scan's invariance to its chunk, and
the state's shape."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as ref_configs
from repro.models import ssm as ref_ssm
from repro_torch import configs
from repro_torch.models import modules, ssm
from torch_helpers import as_f32, numpy_tree, to_jax, to_torch

# f32: the same arithmetic with its sums in another order (XLA's einsums and
# torch's); a state is held relative to its largest entry.  bf16: one rounding
# of the output to bf16 (relative 2**-8) on top of that, for a single operation.
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}
STATE_REL = 1e-5
# bf16 through the whole block, as tests/test_torch_rwkv.py holds its block:
# the two frameworks round at other places.  XLA on the CPU computes a bf16
# sigmoid as 1 / (1 + exp(-x)) with each of its three steps rounded to bf16,
# torch's silu rounds once, so silu(z) and silu(conv) part by one bf16 ulp on
# some elements; through the gated norm and w_out that is up to 0.035 at
# outputs of 4 (4.5 ulps there).
BLOCK_TOL = {"float32": TOL["float32"], "bfloat16": dict(atol=5e-2, rtol=5e-2)}
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B = 2


def _cfgs(dtype, chunk=None):
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("zamba2_2p7b"), dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config("zamba2_2p7b"), dtype=tdt)
    if chunk is not None:
        ref_cfg = dataclasses.replace(ref_cfg, ssm=dataclasses.replace(ref_cfg.ssm, chunk=chunk))
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    return ref_cfg, cfg


def _params(cfg, seed=3):
    """The reference's initial block, its f32 leaves spread so that every term
    counts: A_log and dt_bias away from 0, D and norm_scale away from 1."""
    ref_cfg, _ = _cfgs("float32")
    p = numpy_tree(ref_ssm.mamba2_init(jax.random.PRNGKey(seed), ref_cfg))
    rng = np.random.default_rng(seed)
    for name, mean, sd in (("A_log", 0.0, 0.5), ("dt_bias", 0.0, 0.5), ("D", 1.0, 0.3), ("norm_scale", 1.0, 0.1)):
        p[name] = (mean + sd * rng.standard_normal(p[name].shape)).astype(np.float32)
    return p


def _state_np(rng, cfg, Bn):
    s, d_in = cfg.ssm, cfg.d_model * cfg.ssm.expand
    H = d_in // s.head_dim
    return {"ssm": rng.standard_normal((Bn, H, s.head_dim, s.d_state), dtype=np.float32) * 0.3,
            "conv_x": rng.standard_normal((Bn, s.conv_width - 1, d_in), dtype=np.float32) * 0.5,
            "conv_bc": rng.standard_normal((Bn, s.conv_width - 1, 2 * s.d_state), dtype=np.float32) * 0.5}


def _close_state(got, want, err_msg=""):
    want = as_f32(want)
    np.testing.assert_allclose(as_f32(got), want, rtol=STATE_REL, atol=STATE_REL * np.abs(want).max(), err_msg=err_msg)


# -- the causal convolution ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,with_state", [(20, False), (20, True), (2, True), (2, False), (1, True)])
def test_causal_conv_matches_reference(dtype, T, with_state):
    """T = 2 is shorter than W - 1 = 3: the new state still holds the end of the old."""
    rng = np.random.default_rng(T + 10 * with_state)
    C, W = 48, 4
    x = rng.standard_normal((B, T, C), dtype=np.float32)
    w = rng.standard_normal((W, C), dtype=np.float32)
    st = rng.standard_normal((B, W - 1, C), dtype=np.float32) if with_state else None
    out_ref, new_ref = ref_ssm._causal_conv(to_jax(x, dtype), jnp.asarray(w), None if st is None else to_jax(st, dtype))
    out, new = ssm._causal_conv(to_torch(x, dtype), torch.from_numpy(w), None if st is None else to_torch(st, dtype))
    assert out.dtype == _T[dtype][1] and new.shape == (B, W - 1, C)
    np.testing.assert_allclose(as_f32(out), as_f32(out_ref), **TOL[dtype])  # silu: one bf16 ulp at most
    np.testing.assert_array_equal(as_f32(new), as_f32(new_ref))  # a copy of inputs, exactly


# -- the chunked scan ------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(with_h0):
    rng = np.random.default_rng(5 + with_h0)
    b, T, H, Pd, N, chunk = 2, 64, 3, 8, 5, 16
    x = rng.standard_normal((b, T, H, Pd), dtype=np.float32)
    Bm = rng.standard_normal((b, T, N), dtype=np.float32)
    Cm = rng.standard_normal((b, T, N), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, T, H)))).astype(np.float32)  # softplus: > 0
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((b, H, Pd, N), dtype=np.float32) if with_h0 else None
    y_ref, h_ref = ref_ssm._ssd_chunked(*(jnp.asarray(a) for a in (x, Bm, Cm, dt, A)), chunk,
                                        None if h0 is None else jnp.asarray(h0))
    y, h = ssm._ssd_chunked(*(torch.from_numpy(a) for a in (x, Bm, Cm, dt, A)), chunk,
                            None if h0 is None else torch.from_numpy(h0))
    assert y.dtype == h.dtype == torch.float32
    np.testing.assert_allclose(as_f32(y), as_f32(y_ref), **TOL["float32"])
    _close_state(h, h_ref)
    # the recurrence one step at a time gives the same state
    hs = torch.zeros((b, H, Pd, N)) if h0 is None else torch.from_numpy(h0).clone()
    for t in range(T):
        a = torch.exp(torch.from_numpy(dt[:, t] * A))
        hs = hs * a[:, :, None, None] + torch.einsum("bh,bhp,bn->bhpn", *(torch.from_numpy(v) for v in (dt[:, t], x[:, t], Bm[:, t])))
    _close_state(h, hs)


# -- the block ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,T", [("chunked-whole", 64), ("chunked-padded", 45), ("chunked-state", 20),
                                    ("step", 1), ("one-token-no-state", 1)])
def test_mamba2_apply_matches_reference(dtype, mode, T):
    """The three cases: T > 1 or no state takes the chunked form (T padded to a
    multiple of the chunk, 32 here, when it is not one), one token with a state
    the recurrence; the D skip in all."""
    ref_cfg, cfg = _cfgs(dtype)
    lp = _params(cfg)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((B, T, cfg.d_model), dtype=np.float32)
    st = _state_np(rng, cfg, B) if mode in ("chunked-state", "step") else None
    ref_state = None if st is None else {"ssm": jnp.asarray(st["ssm"]), "conv_x": to_jax(st["conv_x"], dtype),
                                         "conv_bc": to_jax(st["conv_bc"], dtype)}
    out_ref, new_ref = ref_ssm.mamba2_apply({n: jnp.asarray(a) for n, a in lp.items()}, ref_cfg, to_jax(x, dtype), ref_state)
    state = None if st is None else {"ssm": torch.from_numpy(st["ssm"].copy()), "conv_x": to_torch(st["conv_x"], dtype),
                                     "conv_bc": to_torch(st["conv_bc"], dtype)}
    with torch.no_grad():
        out, new = ssm.mamba2_apply({n: torch.from_numpy(np.array(a)) for n, a in lp.items()}, cfg, to_torch(x, dtype), state)
    assert out.dtype == cfg.dtype and out.shape == (B, T, cfg.d_model)
    np.testing.assert_allclose(as_f32(out), as_f32(out_ref), **BLOCK_TOL[dtype])
    for name in ("conv_x", "conv_bc"):  # the last inputs, before the convolution: copies
        np.testing.assert_allclose(as_f32(new[name]), as_f32(new_ref[name]), **TOL[dtype], err_msg=name)
    if dtype == "float32":
        _close_state(new["ssm"], new_ref["ssm"], "ssm")
    else:  # the state sums the silu'd convolution's outputs: held as the block is
        np.testing.assert_allclose(as_f32(new["ssm"]), as_f32(new_ref["ssm"]), **BLOCK_TOL[dtype], err_msg="ssm")
    assert new["ssm"].dtype == torch.float32
    if state is not None:
        assert new is state  # updated in place


def test_padding_leaves_the_state_of_the_unpadded_prompt():
    """dt = 0 on the pads leaves the state as it is: 45 tokens padded to 64
    give the state of 45 tokens in chunks of 5 (no pad)."""
    _, cfg = _cfgs("float32")
    lp = {n: torch.from_numpy(np.array(a)) for n, a in _params(cfg).items()}
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((B, 45, cfg.d_model), dtype=np.float32))
    with torch.no_grad():
        y, st = ssm.mamba2_apply(lp, cfg, x)
        y5, st5 = ssm.mamba2_apply(lp, dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=5)), x)
    _close_state(st["ssm"], st5["ssm"])
    torch.testing.assert_close(y, y5, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_norm_through_rmsnorm_equals_the_reference_expression(dtype):
    """``modules.rmsnorm(norm_scale, y * silu(z))`` is, term for term, the
    reference's inline gated norm (``repro/models/ssm.py:165-168``)."""
    rng = np.random.default_rng(4)
    y = rng.standard_normal((B, 7, 256), dtype=np.float32)
    z = rng.standard_normal((B, 7, 256), dtype=np.float32) * 2
    scale = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    yj, zj = to_jax(y, dtype), to_jax(z, dtype)
    yz = yj * jax.nn.silu(zj)
    var = jnp.mean(jnp.square(yz.astype(jnp.float32)), axis=-1, keepdims=True)
    want = (yz.astype(jnp.float32) * jax.lax.rsqrt(var + 1e-6) * jnp.asarray(scale)).astype(yj.dtype)
    yt, zt = to_torch(y, dtype), to_torch(z, dtype)
    got = modules.rmsnorm(torch.from_numpy(scale), yt * F.silu(zt))
    assert got.dtype == yt.dtype
    np.testing.assert_allclose(as_f32(got), as_f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunked_output_does_not_depend_on_the_chunk(dtype, chunk):
    """The port's twin of tests/test_models_property.py's chunk invariance:
    chunks of 8, 16 and 32 against 64, each also against the reference at
    its chunk."""
    ref_cfg, cfg = _cfgs(dtype, chunk)
    _, cfg64 = _cfgs(dtype, 64)
    lp = _params(cfg, seed=chunk)
    x = np.random.default_rng(chunk).standard_normal((B, 64, cfg.d_model), dtype=np.float32) * 0.1
    tp = {n: torch.from_numpy(np.array(a)) for n, a in lp.items()}
    with torch.no_grad():
        y1, s1 = ssm.mamba2_apply(tp, cfg, to_torch(x, dtype))
        y2, s2 = ssm.mamba2_apply(tp, cfg64, to_torch(x, dtype))
    np.testing.assert_allclose(as_f32(y1), as_f32(y2), **TOL[dtype])
    _close_state(s1["ssm"], s2["ssm"]) if dtype == "float32" else \
        np.testing.assert_allclose(as_f32(s1["ssm"]), as_f32(s2["ssm"]), **TOL[dtype])
    y_ref, _ = ref_ssm.mamba2_apply({n: jnp.asarray(a) for n, a in lp.items()}, ref_cfg, to_jax(x, dtype))
    np.testing.assert_allclose(as_f32(y1), as_f32(y_ref), **BLOCK_TOL[dtype])


@pytest.mark.parametrize("batch", [1, 3])
def test_state_shape_mirrors_reference(batch):
    for arch in ("zamba2_2p7b",):
        for get, ref_get in ((configs.get_config, ref_configs.get_config),
                             (configs.get_smoke_config, ref_configs.get_smoke_config)):
            want = ref_ssm.mamba2_state_shape(ref_get(arch), batch)
            got = ssm.mamba2_state_shape(get(arch), batch)
            assert set(got) == set(want)
            for name, (shape, dtype) in got.items():
                assert shape == want[name][0] and str(dtype).replace("torch.", "") == jnp.dtype(want[name][1]).name


def test_init_shapes_and_f32_leaves_mirror_reference():
    ref_cfg, cfg = _cfgs("bfloat16")
    ref_cfg = dataclasses.replace(ref_cfg, param_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    want = ref_ssm.mamba2_init(jax.random.PRNGKey(0), ref_cfg)
    got = ssm.mamba2_init(torch.Generator().manual_seed(0), cfg, (3, 2))
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == (3, 2) + leaf.shape, name
        assert str(got[name].dtype).replace("torch.", "") == jnp.dtype(leaf.dtype).name, name
    for name in ssm.F32_KEYS:
        assert torch.equal(got[name][1, 0], torch.from_numpy(np.array(want[name]))), name
