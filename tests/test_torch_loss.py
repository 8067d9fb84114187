"""The port's ``Model.loss`` and its gradients against the reference's
``jax.value_and_grad(model.loss)`` on converted weights, for gpt_a, gpt_b and
minitron_4b smoke; ``cross_entropy_loss``; and remat, whose three policies
give the same gradients.

On the CPU the RMSNorm and attention of the loss go through the kernels'
autograd Functions with their plain forward and plain backward, the same
backward arithmetic the card runs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as ref_configs
from repro.models import modules as ref_modules
from repro.models.transformer import build_model as ref_build_model
from repro_torch import configs, convert
from repro_torch.models import modules
from repro_torch.models.transformer import build_model
from torch_helpers import reference_params

# f32: the same arithmetic in another order of summation, through a few layers.
# bf16: activations round to bf16 at other places in the two frameworks; the
# loss is a mean over many tokens, so it keeps 1e-3, a gradient leaf 5e-2.
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _setup(arch, dtype, remat="none"):
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt, remat=remat)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    return ref_cfg, cfg, ref_params, tree


def _port_value_and_grad(cfg, tree, batch):
    params = convert.from_reference(tree, cfg)
    flat = convert.flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, metrics = build_model(cfg).loss(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss, metrics, dict(zip(flat, grads))


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_against_reference(arch, dtype, batch):
    ref_cfg, cfg, ref_params, tree = _setup(arch, dtype)
    (ref_loss, ref_metrics), ref_grads = jax.value_and_grad(ref_build_model(ref_cfg).loss, has_aux=True)(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_value_and_grad(cfg, tree, batch)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert set(metrics) == {"ce", "aux"} and float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=LOSS_TOL[dtype], atol=LOSS_TOL[dtype])
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(ref_metrics["ce"]), rtol=LOSS_TOL[dtype], atol=LOSS_TOL[dtype])
    ref_flat = convert.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), ref_grads))
    assert set(grads) == set(ref_flat)
    for path, g in grads.items():
        assert g.dtype == torch.float32, path  # f32 gradients on the f32 master leaves
        assert _rel(g.numpy(), ref_flat[path]) <= GRAD_TOL[dtype], (path, _rel(g.numpy(), ref_flat[path]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [32, 300])  # 300: a full 256-chunk and a padded one
@pytest.mark.parametrize("arch", ["gpt_a", "gpt_b", "minitron_4b"])
def test_loss_and_grads_match_reference(arch, T, dtype):
    vocab = configs.get_smoke_config(arch).vocab_size
    tokens = np.random.default_rng(3).integers(0, vocab, size=(2, T)).astype(np.int32)
    _check_against_reference(arch, dtype, {"tokens": tokens})


@pytest.mark.parametrize("arch", ["gpt_a", "minitron_4b"])
def test_loss_with_labels_and_mask_matches_reference(arch):
    vocab = configs.get_smoke_config(arch).vocab_size
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, vocab, size=(2, 40)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(2, 40)).astype(np.int32)
    mask = (rng.random((2, 40)) < 0.6).astype(np.float32)
    _check_against_reference(arch, "float32", {"tokens": tokens, "labels": labels, "mask": mask})


def test_an_all_zero_mask_gives_zero_not_nan():
    """The denominator is clamped at 1, as in the reference."""
    cfg = configs.get_smoke_config("gpt_a")
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    loss, _ = build_model(cfg).loss(params, {"tokens": tokens, "labels": tokens, "mask": torch.zeros((2, 8))})
    assert float(loss.detach()) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches_reference(masked):
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.5).astype(np.float32) if masked else None
    got = modules.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                     None if mask is None else torch.from_numpy(mask))
    want = ref_modules.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                          None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_policies_give_the_gradients_of_none(dtype):
    """"full" and "dots" give bit-equal gradients to "none"; "full" recomputes
    every block's forward (its kernels' launch counters and matrix products
    show it), "dots" keeps the matrix products' outputs and recomputes none."""
    T = 40
    out = {}
    for remat in ("none", "full", "dots"):
        _, cfg, _, tree = _setup("minitron_4b", dtype, remat=remat)
        tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, T)).astype(np.int32)
        counter = _CountMM()
        with counter:
            loss, _, grads = _port_value_and_grad(cfg, tree, {"tokens": tokens})
        out[remat] = (float(loss.detach()), grads, counter.mm)
    L = configs.get_smoke_config("minitron_4b").num_layers
    # the recomputation stops once every tensor the backward saved is back
    # (torch's early stop), so of a block's six products (wq, wk, wv, wo, w_up,
    # w_down; relu2) the last, whose output nothing saves, is not recomputed
    mm_recomputed_per_layer = 5
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for path, g in out[remat][1].items():
            assert torch.equal(g, out["none"][1][path]), (remat, path)
    assert out["dots"][2] == out["none"][2]
    assert out["full"][2] == out["none"][2] + L * mm_recomputed_per_layer


def test_remat_rejects_an_unknown_policy():
    cfg = dataclasses.replace(configs.get_smoke_config("gpt_a"), remat="everything")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    for t in convert.flatten(params).values():
        t.requires_grad_(True)
    with pytest.raises(ValueError, match="remat"):
        model.loss(params, {"tokens": torch.zeros((1, 8), dtype=torch.int32)})


# -- the MoE family: ce + the summed aux loss, and the gradients of every leaf ---


def _ref_value_and_grad(ref_cfg, ref_params, tokens):
    (loss, metrics), grads = jax.value_and_grad(ref_build_model(ref_cfg).loss, has_aux=True)(
        ref_params, {"tokens": jnp.asarray(tokens)})
    return loss, metrics, convert.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [32, 300])
@pytest.mark.parametrize("arch", ["qwen2_moe_a2p7b", "deepseek_v2_lite_16b"])
def test_moe_loss_aux_and_grads_match_reference(arch, T, dtype):
    """``Model.loss`` returns ce + aux with aux the Switch load-balance loss
    summed over the layers, as the reference does, within LOSS_TOL.

    f32: every leaf's gradient (the f32 router's through the gates and the aux
    loss included) within GRAD_TOL.  bf16: top-k routing is discrete, and one
    bf16 rounding can decide a near-tie the other way (T 32: 1 of 128 routes of
    qwen2-moe smoke differ between the packages); the reference's pairing of
    gate weights with sorted slots (ROADMAP Queue 3 (e)) then moves the
    weights of the rest of the sequence, so a gradient leaf can move by more
    than GRAD_TOL.  The reference does the same to itself: its bf16 gradients
    part from its f32 gradients by 0.07-1.10 a leaf here.  So in bf16 each
    leaf's gap to the reference is held against that control on the same
    leaf: at most twice the control's gap plus GRAD_TOL."""
    ref_cfg, cfg, ref_params, tree = _setup(arch, dtype)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, size=(2, T)).astype(np.int32)
    ref_loss, ref_metrics, ref_flat = _ref_value_and_grad(ref_cfg, ref_params, tokens)
    loss, metrics, grads = _port_value_and_grad(cfg, tree, {"tokens": tokens})
    assert set(metrics) == {"ce", "aux"} and float(metrics["aux"]) > 0
    assert metrics["aux"].dtype == torch.float32 and metrics["aux"].shape == ()
    for got, want in ((loss, ref_loss), (metrics["ce"], ref_metrics["ce"]), (metrics["aux"], ref_metrics["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_TOL[dtype], atol=LOSS_TOL[dtype])
    assert float(loss.detach()) == pytest.approx(float((metrics["ce"] + metrics["aux"]).detach()), abs=1e-6)
    assert set(grads) == set(ref_flat) and "layers/moe/router" in grads
    assert all(g.dtype == torch.float32 for g in grads.values())  # f32 gradients on the f32 master leaves
    gaps = {path: _rel(g.numpy(), ref_flat[path]) for path, g in grads.items()}
    if dtype == "float32":
        assert max(gaps.values()) <= GRAD_TOL[dtype], gaps
        return
    ref32_cfg, _, ref32_params, _ = _setup(arch, "float32")
    control = _ref_value_and_grad(ref32_cfg, ref32_params, tokens)[2]
    for path, gap in gaps.items():
        control_gap = _rel(ref_flat[path], control[path])
        assert gap <= 2 * control_gap + GRAD_TOL[dtype], (path, gap, control_gap)


def test_moe_remat_full_gives_the_gradients_of_none():
    """The block returns its aux beside x through the checkpoint: "full" gives
    bit-equal loss, aux and gradients to "none"."""
    out = {}
    for remat in ("none", "full"):
        _, cfg, _, tree = _setup("qwen2_moe_a2p7b", "float32", remat=remat)
        tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
        loss, metrics, grads = _port_value_and_grad(cfg, tree, {"tokens": tokens})
        out[remat] = (float(loss.detach()), float(metrics["aux"].detach()), grads)
    assert out["full"][:2] == out["none"][:2]
    for path, g in out["full"][2].items():
        assert torch.equal(g, out["none"][2][path]), path
