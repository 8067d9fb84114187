"""The placement plan applied (ROADMAP 7b-i, 7b-ii): every shard
``shard_params`` keeps of the eight dense-family configs and the two MoE
configs at full size equals the reference's
``NamedSharding(mesh, spec).shard_shape`` on an ``AbstractMesh`` of (16, 16)
and of (2, 2), leaf by leaf (on ``meta``: no device, nothing drawn): both
``MOE_RULES`` candidates (Qwen1.5-MoE's 60 experts on their features at 16,
on their expert dim at 2) and the shared expert's stacked leaves, which the
plan splits on their first dim; ``unshard`` puts the ``model`` ranks' blocks
back bit for bit; RWKV-6 and the Zamba2 hybrid have plans since 7b-iii (their
shards are held in ``test_torch_dryrun_tp_recurrent.py``); and with no
tensor-parallel context, or one of a single rank, every operation is the
identity and the loss is the one it was, bit for bit."""
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as ref_configs
from repro.models.transformer import build_model as ref_build_model
from repro.parallel import sharding as ref_sharding
from repro_torch import configs
from repro_torch.convert import flatten
from repro_torch.data.pipeline import input_batch_for
from repro_torch.launch.dryrun import meta_params
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import build_model
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import shard_params, unshard
from repro_torch.parallel.transport import Transport
from torch_pipeline_helpers import _jax_flat

DENSE = ["gpt_a", "gpt_b", "minitron_4b", "nemotron_4_15b", "deepseek_coder_33b", "granite_34b", "qwen2_vl_7b",
         "hubert_xlarge"]
MOE = ["qwen2_moe_a2p7b", "deepseek_v2_lite_16b"]
MESHES = [(16, 16), (2, 2)]
AXES = ("data", "model")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_every_shard_is_the_reference_s_shard_shape(arch, shape):
    cfg = configs.get_config(arch)
    assert tp.tp_family(cfg)
    ref_shapes = jax.eval_shape(ref_build_model(ref_configs.get_config(arch)).init, jax.random.PRNGKey(0))
    specs = _jax_flat(ref_sharding.make_param_shardings(ref_shapes, AbstractMesh(shape, AXES)))
    ref_flat = _jax_flat(ref_shapes)
    whole = meta_params(build_model(cfg))
    rank = math.prod(shape) - 1  # the last rank: every coordinate past 0
    shards = flatten(shard_params(whole, Mesh(shape, AXES, rank), tp.model_plan(cfg, Mesh(shape, AXES))))
    assert set(shards) == set(ref_flat)
    for p, t in shards.items():
        want = NamedSharding(AbstractMesh(shape, AXES), specs[p].spec).shard_shape(ref_flat[p].shape)
        assert tuple(t.shape) == tuple(want), (p, tuple(t.shape), want)
        assert str(t.dtype).split(".")[-1] == str(ref_flat[p].dtype), p


def test_split_dims_follow_the_plan_leaf_by_leaf():
    mesh = Mesh((16, 16), AXES)
    gpt = tp.split_dims(tp.model_plan(configs.get_config("gpt_a"), mesh))
    assert gpt == {"embed": 1, "lm_head": 1, "final_norm": None, "ln1": None, "ln2": None, "wq": 1, "wk": 1,
                   "wv": 1, "wo": 0, "w_up": 1, "w_down": 0}
    hubert = tp.split_dims(tp.model_plan(configs.get_config("hubert_xlarge"), mesh))
    assert hubert["lm_head"] is None and hubert["embed"] == 1  # 504 classes do not divide 16
    rwkv = tp.split_dims(tp.model_plan(configs.get_config("rwkv6_7b"), mesh))  # by heads since 7b-iii
    assert rwkv == {"embed": 1, "lm_head": 1, "final_norm": None, "ln_scale": None, "mu_r": None, "mu_k": None,
                    "mu_v": None, "mu_w": None, "mu_g": None, "mu_ck": None, "wr": 1, "wk": 1, "wv": 1, "wg": 1,
                    "wo": 0, "w0": 0, "u": 0, "w_lora_a": None, "w_lora_b": 1, "ck": 1, "cv": 0, "cr": 1}
    zamba = tp.split_dims(tp.model_plan(configs.get_config("zamba2_2p7b"), mesh))  # the (G, M) leaves on d
    mamba = {"w_z": 0, "w_x": 0, "w_bc": None, "w_dt": None, "conv_x": None, "conv_bc": None, "A_log": None,
             "D": None, "dt_bias": None, "w_out": None, "norm_scale": None, "ln": None, "gate": None}
    assert zamba == {"embed": 1, "lm_head": 1, "final_norm": None, "ln1": None, "ln2": None, "wq": 1, "wk": 1,
                     "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1, "w_down": 0, **mamba}  # 4 taps do not divide 16
    # the MoE leaves by their path from moe: the routed and the shared w_gate split on different dims
    qwen = tp.split_dims(tp.model_plan(configs.get_config("qwen2_moe_a2p7b"), mesh))
    shared = {"moe/shared/w_gate": 0, "moe/shared/w_up": 0, "moe/shared/w_down": 0, "moe/router": None}
    assert qwen == {"embed": 1, "lm_head": 1, "final_norm": None, "ln1": None, "ln2": None, "wq": 1, "wk": 1,
                    "wv": 1, "wo": 0, "moe/w_gate": 2, "moe/w_up": 2, "moe/w_down": 1, **shared}  # 60 experts on 16
    qwen_ep = tp.split_dims(tp.model_plan(configs.get_config("qwen2_moe_a2p7b"), Mesh((2, 2), AXES)))
    assert [qwen_ep[f"moe/{n}"] for n in ("w_gate", "w_up", "w_down")] == [0, 0, 0]
    deepseek = tp.split_dims(tp.model_plan(configs.get_config("deepseek_v2_lite_16b"), mesh))
    assert deepseek == {"embed": 1, "lm_head": 1, "final_norm": None, "ln1": None, "ln2": None, "wq": 1,
                        "w_dkv": None, "w_uk": 1, "w_uv": 1, "wo": 0, "moe/w_gate": 0, "moe/w_up": 0,
                        "moe/w_down": 0, **shared}  # 64 experts on 16
    assert tp.model_plan(configs.get_config("gpt_a"), Mesh((2, 1), AXES)) is None


@pytest.mark.parametrize("arch", ["gpt_a", "granite_34b", "hubert_xlarge", "qwen2_moe_a2p7b", "deepseek_v2_lite_16b"])
def test_unshard_puts_the_model_blocks_back(arch):
    cfg = configs.get_smoke_config(arch)
    gen = torch.Generator()
    gen.manual_seed(0)
    whole = build_model(cfg).init(gen)
    plan = tp.model_plan(cfg, Mesh((2, 4), AXES))
    blocks = [shard_params(whole, Mesh((2, 4), AXES, 4 + j), plan) for j in range(4)]
    back = flatten(unshard(blocks, plan))
    for p, t in flatten(whole).items():
        assert torch.equal(back[p], t), p
    assert any(b.shape != t.shape for b, t in zip(flatten(blocks[1]).values(), flatten(whole).values()))


def test_no_context_and_one_rank_change_nothing():
    x = torch.randn(2, 3, 8)
    for op in (tp.copy_in, tp.reduce_out):
        assert op(x) is x
    assert tp.gather(x, -1) is x and tp.slice_(x, -1) is x and tp.split_dim("wq") is None
    cfg = configs.get_smoke_config("gpt_a")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = build_model(cfg).init(gen)
    batch = {k: torch.from_numpy(v) for k, v in input_batch_for(cfg, 2, 16).items()}
    plain, _ = build_model(cfg).loss(params, batch)
    mesh = Mesh((1, 1), AXES)
    one = tp.TPContext(mesh, Transport(mesh), tp.model_plan(cfg, Mesh((1, 2), AXES)))
    with tp.use(one):
        assert tp.split_dim("wq") is None and tp.copy_in(x) is x
        same, _ = build_model(cfg).loss(params, batch)
    assert torch.equal(plain, same)
