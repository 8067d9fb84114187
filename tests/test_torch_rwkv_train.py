"""RWKV-6 training in the port against the JAX package on converted weights:
``RWKVModel.loss`` and the gradient of every leaf against
``jax.value_and_grad`` of the reference's loss (T 32, a multiple of the smoke
config's chunk of 32, and T 300, which the reference pads), remat "full"
against "none", and the block's loss path, which writes no state.  The bonus
``u`` and the decay's ``w0`` are drawn away from their initial values (zeros,
-2 everywhere) so that every term of the WKV-6 backward reaches the loss."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models.transformer import build_model as ref_build_model
from repro_torch import configs, convert
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch.models import rwkv
from repro_torch.models.transformer import build_model
from torch_helpers import reference_params

_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the loss: f32, the same arithmetic in another order of summation; bf16, the
# activations round to bf16 at other places in the two frameworks
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# each leaf's gradient relative in norm: f32 sums in another order; in bf16 the
# roundings of the forward are carried through the backward of two layers
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _cfgs(dtype, remat=None):
    jdt, tdt = _T[dtype]
    extra = {} if remat is None else {"remat": remat}
    return (dataclasses.replace(ref_configs.get_smoke_config("rwkv6_7b"), dtype=jdt),
            dataclasses.replace(configs.get_smoke_config("rwkv6_7b"), dtype=tdt, **extra))


def _twins(ref_cfg):
    """The reference's parameters and the same as a numpy tree, with ``u`` and
    ``w0`` drawn from a seed on both."""
    ref_params, tree = reference_params(ref_cfg, seed=0)
    rng = np.random.default_rng(11)
    lay = tree["layers"]
    lay["u"] = (rng.standard_normal(lay["u"].shape) * 0.3).astype(np.float32)
    lay["w0"] = (-2.0 + rng.standard_normal(lay["w0"].shape) * 0.5).astype(np.float32)
    ref_params = {**ref_params, "layers": {**ref_params["layers"], "u": jnp.asarray(lay["u"]),
                                           "w0": jnp.asarray(lay["w0"])}}
    return ref_params, tree


def _port_value_and_grad(cfg, tree, tokens):
    params = convert.from_reference(tree, cfg)
    flat = convert.flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, metrics = build_model(cfg).loss(params, {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, metrics, dict(zip(flat, grads))


def _tokens(cfg, T, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(2, T)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [32, 300])
def test_loss_and_grads_match_reference(T, dtype):
    ref_cfg, cfg = _cfgs(dtype)
    ref_params, tree = _twins(ref_cfg)
    tokens = _tokens(cfg, T)
    (ref_loss, _), ref_grads = jax.value_and_grad(ref_build_model(ref_cfg).loss, has_aux=True)(
        ref_params, {"tokens": jnp.asarray(tokens)})
    wkv_mod.bwd_launches = 0
    loss, metrics, grads = _port_value_and_grad(cfg, tree, tokens)
    assert wkv_mod.bwd_launches == 0  # the CPU runs the plain backward, never the kernel's wrapper
    assert loss.dtype == torch.float32 and set(metrics) == {"ce"}
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_TOL[dtype])
    ref_flat = convert.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), ref_grads))
    assert set(grads) == set(ref_flat)
    for path, g in grads.items():
        assert g.dtype == torch.float32, path  # f32 gradients on the f32 master leaves
        want = ref_flat[path]
        rel = float(np.linalg.norm(g.numpy() - want) / np.linalg.norm(want))
        assert rel <= GRAD_TOL[dtype], (path, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_full_equals_none_bit_for_bit(dtype):
    """The recomputation in the backward repeats the forward's arithmetic."""
    _, cfg_none = _cfgs(dtype, remat="none")
    ref_cfg, cfg_full = _cfgs(dtype, remat="full")
    _, tree = _twins(ref_cfg)
    tokens = _tokens(cfg_none, 45)
    a_loss, _, a = _port_value_and_grad(cfg_none, tree, tokens)
    b_loss, _, b = _port_value_and_grad(cfg_full, tree, tokens)
    assert torch.equal(a_loss, b_loss)
    assert all(torch.equal(a[p], b[p]) for p in a)


def test_the_loss_path_writes_no_state():
    """Differentiated with no state, the block returns no state and goes
    through WKV6Fn; under no_grad, or with grad on and nothing that requires
    it (an evaluation outside no_grad), it still makes and returns the state."""
    _, cfg = _cfgs("float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    lp = {k: v[0].clone().requires_grad_(True) for k, v in params["layers"].items()}
    x = torch.randn((2, 9, cfg.d_model), generator=torch.Generator().manual_seed(1))
    out, state = rwkv.rwkv6_apply(lp, cfg, x, None)
    assert state is None and out.grad_fn is not None
    with torch.no_grad():
        out2, state2 = rwkv.rwkv6_apply(lp, cfg, x, None)
    assert set(state2) == {"wkv", "shift_t", "shift_c"}
    torch.testing.assert_close(out2, out.detach(), rtol=0, atol=0)
    out3, state3 = rwkv.rwkv6_apply({k: v.detach() for k, v in lp.items()}, cfg, x, None)
    assert torch.is_grad_enabled() and out3.grad_fn is None
    assert set(state3) == set(state2) and all(torch.equal(state3[k], state2[k]) for k in state2)
    torch.testing.assert_close(out3, out2, rtol=0, atol=0)
