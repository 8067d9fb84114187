"""``pad_layer_stack`` and ``padded_num_layers`` against the reference's, and a
stack padded for four stages against the unpadded one, with no process group:
the zero layers (DeepSeek-V2-Lite smoke's two; Zamba2 smoke's two groups,
gated off) are exact identities forward and backward.  ``stage_params`` cuts
each stage's real rows into leaves of their own."""
import types

import numpy as np
import pytest
import torch

from repro.parallel import pipeline as ref_pipeline
from repro_torch import convert
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import _unstack, build_pipeline_parts
from repro_torch.parallel.pipeline import (
    pad_layer_stack,
    padded_num_layers,
    stack_length,
    stage_layer_range,
    stage_params,
)
from torch_pipeline_helpers import jax_tree, smoke_case, stack_rows


@pytest.mark.parametrize("n,S", [(27, 2), (9, 2), (2, 4), (24, 4), (32, 8), (3, 1), (1, 3)])
def test_padding_matches_the_reference(n, S):
    assert padded_num_layers(n, S) == ref_pipeline.padded_num_layers(n, S)
    rng = np.random.default_rng(n * 10 + S)
    tree = {"a": rng.standard_normal((n, 3)).astype(np.float32), "b": {"c": rng.standard_normal((n, 2, 2)).astype(np.float32)}}
    got = pad_layer_stack(convert.unflatten({k: torch.from_numpy(v) for k, v in convert.flatten(tree).items()}), S)
    want = ref_pipeline.pad_layer_stack(jax_tree(tree), S)
    for path, t in convert.flatten(got).items():
        w = np.asarray(convert.flatten(want)[path])
        assert t.numpy().dtype == w.dtype and np.array_equal(t.numpy(), w), path


def _stack_loss(cfg, params, layers, batch):
    """Embedding, every layer of ``layers`` in turn and the final loss:
    (ce, the aux summed, the output of the last layer)."""
    parts = build_pipeline_parts(cfg)
    x, pos = parts.embed(params, batch)
    aux = torch.zeros(())
    for lp in _unstack(layers, stack_rows(layers)):
        x, a = parts.layer(lp, params, x, pos)
        aux = aux if a is None else aux + a
    targets = torch.nn.functional.pad(batch["tokens"][:, 1:], (0, 1))
    mask = torch.ones(targets.shape)
    mask[:, -1] = 0
    return parts.final_loss(params, x, targets, mask), aux, x


@pytest.mark.parametrize("arch", ["deepseek_v2_lite_16b", "zamba2_2p7b"])
def test_zero_layers_are_exact_identities(arch):
    """The stack padded for four stages (two zero layers, or two zero groups
    whose zero gate switches the shared block off) gives the unpadded stack's
    activations, cross entropy and gradients bit for bit; its aux exceeds the
    unpadded one's by the zero layers' own, that of a uniform router, a
    constant with no gradient."""
    cfg, _, params, _, batch = smoke_case(arch, {}, 2, 16)
    key = build_pipeline_parts(cfg).layer_key
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    flat = convert.flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    runs = []
    for layers in (params[key], pad_layer_stack(params[key], 4)):
        ce, aux, x = _stack_loss(cfg, params, layers, tb)
        grads = torch.autograd.grad(ce + aux, list(flat.values()), allow_unused=True)
        runs.append((ce.detach(), aux.detach(), x.detach(), grads))
    (ce0, aux0, x0, g0), (ce1, aux1, x1, g1) = runs
    assert torch.equal(x0, x1) and torch.equal(ce0, ce1)
    for path, a, b in zip(flat, g0, g1):
        assert (a is None and b is None) or torch.equal(a, b), path
    if cfg.moe is not None:
        with torch.no_grad():
            zero = _unstack(pad_layer_stack(params[key], 4), 4)[3]["moe"]
            _, zero_aux = moe_lib.moe_apply(zero, cfg, x0)
        assert float(zero_aux) > 0
        np.testing.assert_allclose(float(aux1), float(aux0) + 2 * float(zero_aux), rtol=1e-6)
    else:
        assert torch.equal(aux0, aux1)


@pytest.mark.parametrize("arch,S", [("deepseek_v2_lite_16b", 4), ("zamba2_2p7b", 2)])
def test_stage_params_cut_the_real_rows_into_leaves(arch, S):
    """Each stage's share of the whole model: its real rows of the stack (none
    on a stage of padding only), copied into leaves of their own that require
    no grad even where the whole model's leaves do (a stage cut after a
    whole-model backward), and every leaf outside the stack shared."""
    cfg, _, params, _, _ = smoke_case(arch, {}, 2, 16)
    flat = convert.flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    key, L = build_pipeline_parts(cfg).layer_key, stack_length(cfg)
    for stage in range(S):
        lo, hi = (min(i, L) for i in stage_layer_range(L, S, stage))
        mine = stage_params(params, cfg, types.SimpleNamespace(shape={"pod": S}, coords={"pod": stage}))
        for path, t in convert.flatten(mine).items():
            if path.split("/", 1)[0] == key:
                assert t.is_leaf and not t.requires_grad and torch.equal(t, flat[path][lo:hi]), (stage, path)
            else:
                assert t is flat[path], (stage, path)
