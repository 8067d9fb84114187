"""``build_pipeline_parts`` against the reference's on converted weights, with
no process group: each branch's ``embed``, one ``layer`` (an RWKV-6 block, a
Zamba2 group, a Mamba2 layer, and the transformer block: dense, MoE with MLA,
MoE with GQA, M-RoPE, the encoder) and ``final_loss``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import build_pipeline_parts as ref_build_parts
from repro_torch.models.transformer import _batch_route, _unstack, build_pipeline_parts
from torch_pipeline_helpers import smoke_case, stack_rows

# f32: the same arithmetic in another framework and another order of sums
TOL = dict(rtol=2e-5, atol=2e-5)
B, T = 2, 16
CASES = [pytest.param("rwkv6_7b", {}, id="rwkv6_7b"),
         pytest.param("zamba2_2p7b", {}, id="hybrid"),
         pytest.param("zamba2_2p7b", {"family": "ssm"}, id="ssm"),
         pytest.param("gpt_a", {}, id="gpt_a"),
         pytest.param("deepseek_v2_lite_16b", {}, id="moe_mla"),
         pytest.param("qwen2_moe_a2p7b", {}, id="moe_gqa"),
         pytest.param("qwen2_vl_7b", {}, id="mrope"),
         pytest.param("hubert_xlarge", {}, id="encoder")]


def _f32(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("arch,replace", CASES)
def test_embed_layer_and_final_loss_match_the_reference(arch, replace):
    cfg, ref_cfg, params, ref_params, batch = smoke_case(arch, replace, B, T)
    parts, ref_parts = build_pipeline_parts(cfg), ref_build_parts(ref_cfg)
    assert parts.layer_key == ref_parts.layer_key
    key = parts.layer_key
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    x, pos = parts.embed(params, tb)
    jx, jpos = ref_parts.embed(ref_params, jb)
    np.testing.assert_allclose(_f32(x), _f32(jx), **TOL)
    assert np.array_equal(pos.numpy(), np.asarray(jpos))
    lp = _unstack(params[key], stack_rows(params[key]))[0]
    jlp = jax.tree.map(lambda a: a[0], ref_params[key])
    with torch.no_grad(), _batch_route(tb):  # the masked plain attention for a VLM batch, as the pipeline runs it
        y, aux = parts.layer(lp, params, x, pos)
    jy, jaux = ref_parts.layer(jlp, ref_params, jx, jpos)
    np.testing.assert_allclose(_f32(y), _f32(jy), **TOL)
    np.testing.assert_allclose(0.0 if aux is None else float(aux), float(jaux), **TOL)
    targets = tb.get("labels", torch.roll(tb.get("tokens", torch.zeros(B, T, dtype=torch.int32)), -1, 1))
    mask = tb.get("mask")
    with torch.no_grad():
        ce = parts.final_loss(params, y, targets, mask)
    jce = ref_parts.final_loss(ref_params, jy, jnp.asarray(targets.numpy()),
                               None if mask is None else jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(float(ce), float(jce), **TOL)
