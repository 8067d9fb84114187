"""``repro_torch.convert``: the JAX package's parameter tree into the port's
state and back, one to one and exact."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.ckpt.checkpoint import _flatten as ref_flatten
from repro_torch import configs, convert
from repro_torch.models.transformer import build_model
from torch_helpers import numpy_tree, reference_params


@pytest.mark.parametrize("arch", ["gpt_a", "minitron_4b"])
def test_keys_and_shapes_match_the_reference_checkpoint_paths(arch):
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    ref_params, tree = reference_params(ref_cfg)
    ref_flat = ref_flatten(ref_params)  # the paths the reference's checkpoints are written under
    state = convert.from_reference(tree, cfg)
    flat = convert.flatten(state)
    assert set(flat) == set(ref_flat)
    assert {"layers/attn/wq", "layers/ln1", "embed", "final_norm", "lm_head"} <= set(flat)
    for path, t in flat.items():
        assert tuple(t.shape) == ref_flat[path].shape, path
        assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert flat["layers/attn/wq"].shape[0] == cfg.num_layers  # layer-stacked
    # the port's own initialiser makes the same tree
    own = convert.flatten(build_model(cfg).init(torch.Generator().manual_seed(0)))
    assert {p: tuple(t.shape) for p, t in own.items()} == {p: tuple(t.shape) for p, t in flat.items()}
    assert convert.expected_shapes(cfg) == {p: tuple(t.shape) for p, t in flat.items()}


def test_round_trip_is_exact():
    ref_cfg, cfg = ref_configs.get_smoke_config("gpt_a"), configs.get_smoke_config("gpt_a")
    _, tree = reference_params(ref_cfg, seed=3)
    back = convert.to_reference(convert.from_reference(tree, cfg))
    flat, flat_back = convert.flatten(tree), convert.flatten(back)
    assert set(flat) == set(flat_back)
    for path in flat:
        assert flat_back[path].dtype == flat[path].dtype
        np.testing.assert_array_equal(flat_back[path], flat[path], err_msg=path)


def test_bf16_leaves_travel_through_f32_exactly():
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("gpt_a"), param_dtype=jnp.bfloat16)
    cfg = dataclasses.replace(configs.get_smoke_config("gpt_a"), param_dtype=torch.bfloat16)
    ref_params, tree = reference_params(ref_cfg, seed=1)
    assert ref_params["layers"]["attn"]["wq"].dtype == jnp.bfloat16
    state = convert.from_reference(tree, cfg)
    assert state["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert state["layers"]["ln1"].dtype == torch.float32  # norm scales stay f32, as the reference makes them
    back = convert.to_reference(state)
    for path, leaf in convert.flatten(numpy_tree(ref_params)).items():
        np.testing.assert_array_equal(convert.flatten(back)[path], leaf, err_msg=path)
    # and the bf16 bits themselves agree with JAX's
    want = np.asarray(ref_params["lm_head"].astype(jnp.float32))
    np.testing.assert_array_equal(state["lm_head"].float().numpy(), want)


def test_wrong_trees_are_refused():
    ref_cfg, cfg = ref_configs.get_smoke_config("gpt_a"), configs.get_smoke_config("gpt_a")
    _, tree = reference_params(ref_cfg)
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="lm_head"):
        convert.from_reference(missing, cfg)
    extra = dict(tree, rogue=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="rogue"):
        convert.from_reference(extra, cfg)
    bad = dict(tree, final_norm=np.ones(7, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        convert.from_reference(bad, cfg)
    # a swiglu tree into a gelu config: the extra w_gate is named
    other = reference_params(dataclasses.replace(ref_cfg, ffn_activation="swiglu"))[1]
    with pytest.raises(ValueError, match="w_gate"):
        convert.from_reference(other, cfg)


def test_flatten_unflatten_inverse():
    tree = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    flat = convert.flatten(tree)
    assert flat == {"a/b": 1, "a/c/d": 2, "e": 3}
    assert convert.unflatten(flat) == tree


@pytest.mark.parametrize("arch", ["qwen2_moe_a2p7b", "deepseek_v2_lite_16b"])
def test_moe_keys_and_shapes_match_the_reference_checkpoint_paths(arch):
    """The MoE leaves (router, experts (L, E, d, f) and (L, E, f, d), shared
    experts) and MLA's (wq, w_dkv, w_uk, w_uv, wo) under the reference's paths;
    the router f32 whatever param_dtype, as the reference makes it."""
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    ref_params, tree = reference_params(ref_cfg)
    ref_flat = ref_flatten(ref_params)
    flat = convert.flatten(convert.from_reference(tree, cfg))
    assert set(flat) == set(ref_flat) == set(convert.expected_shapes(cfg))
    moe_leaves = {"layers/moe/" + k for k in ("router", "w_gate", "w_up", "w_down", "shared/w_gate",
                                              "shared/w_up", "shared/w_down")}
    attn_leaves = {"layers/attn/" + k for k in (("wq", "w_dkv", "w_uk", "w_uv", "wo") if cfg.mla is not None
                                                  else ("wq", "wk", "wv", "wo"))}
    assert moe_leaves | attn_leaves <= set(flat) and not any(p.startswith("layers/ffn") for p in flat)
    L, E = cfg.num_layers, cfg.moe.num_experts
    assert flat["layers/moe/w_gate"].shape == (L, E, cfg.d_model, cfg.moe.expert_d_ff)
    assert flat["layers/moe/w_down"].shape == (L, E, cfg.moe.expert_d_ff, cfg.d_model)
    for path, t in flat.items():
        assert tuple(t.shape) == ref_flat[path].shape, path
    own = convert.flatten(build_model(cfg).init(torch.Generator().manual_seed(0)))
    assert {p: tuple(t.shape) for p, t in own.items()} == {p: tuple(t.shape) for p, t in flat.items()}
    # in bf16 parameters the router stays f32, as the reference's moe_init makes it
    ref16 = dataclasses.replace(ref_cfg, param_dtype=jnp.bfloat16)
    cfg16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    ref_p16, tree16 = reference_params(ref16, seed=2)
    state = convert.flatten(convert.from_reference(tree16, cfg16))
    assert state["layers/moe/router"].dtype == torch.float32 == _torch_dtype(ref_p16["layers"]["moe"]["router"])
    assert state["layers/moe/w_up"].dtype == torch.bfloat16 == _torch_dtype(ref_p16["layers"]["moe"]["w_up"])
    back = convert.flatten(convert.to_reference(convert.unflatten(state)))
    for path, leaf in convert.flatten(numpy_tree(ref_p16)).items():
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)


def _torch_dtype(a):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[jnp.dtype(a.dtype).name]


@pytest.mark.parametrize("arch", ["qwen2_moe_a2p7b", "deepseek_v2_lite_16b"])
def test_moe_round_trip_is_exact(arch):
    ref_cfg, cfg = ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)
    _, tree = reference_params(ref_cfg, seed=3)
    back = convert.flatten(convert.to_reference(convert.from_reference(tree, cfg)))
    for path, leaf in convert.flatten(tree).items():
        assert back[path].dtype == leaf.dtype
        np.testing.assert_array_equal(back[path], leaf, err_msg=path)
