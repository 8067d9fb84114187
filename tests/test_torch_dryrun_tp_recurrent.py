"""The placement plan and the dry-run's train programs for RWKV-6, the Zamba2
hybrid (ROADMAP 7b-iii) and the pure Mamba2 stack (7b-v) under tensor
parallelism.

Every shard ``shard_params`` keeps of RWKV-6 7B and Zamba2-2.7B at full size
equals the reference's ``NamedSharding(mesh, spec).shard_shape`` on an
``AbstractMesh`` of (16, 16) and of (2, 2), leaf by leaf: RWKV-6 by heads;
Zamba2's (9, 5, ...) Mamba2 leaves where the plan puts them, one dim to the
left of the rules' head split (ROADMAP Queue 3 (p)): ``w_z`` and ``w_x`` on
d, ``conv_x`` on its 4 taps at 2 and whole at 16.  A rank of each program
(multi x train: a rank of each stage of (2, 16, 16), of its stage's rows;
single x train: a rank of (16, 16)) holds, in f32, exactly the bytes of those
shards.  The pure Mamba2 stack at Zamba2-2.7B's widths (``family="ssm"``, the
same ``replace`` in both packages) likewise, by heads: ``w_z``, ``w_x`` and
``conv_x`` on d_inner, ``w_out`` and ``norm_scale`` on their rows.  And the
card's three ``train_tp_recurrent`` calls on ``meta``: the bytes they put on
each axis, counted from the code."""
import dataclasses
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
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import Mesh, production_mesh_shape
from repro_torch.models.rwkv import LORA
from repro_torch.models.transformer import build_model, build_pipeline_parts
from repro_torch.parallel.data_parallel import DataParallelLoss
from repro_torch.parallel.pipeline import stack_length, stage_layer_range
from repro_torch.parallel.sharding import shard_params
from repro_torch.parallel.tensor_parallel import model_plan, split_dims, tp_family
from repro_torch.parallel.transport import MetaTransport
from torch_pipeline_helpers import _jax_flat

RECURRENT = ["rwkv6_7b", "zamba2_2p7b"]
AXES = ("data", "model")


def _reference(arch: str, shape, names, **replace):
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch), **replace)
    ref_shapes = jax.eval_shape(ref_build_model(ref_cfg).init, jax.random.PRNGKey(0))
    amesh = AbstractMesh(shape, names)
    return ref_shapes, amesh, _jax_flat(ref_sharding.make_param_shardings(ref_shapes, amesh))


@pytest.mark.parametrize("shape", [(16, 16), (2, 2)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", RECURRENT)
def test_every_shard_is_the_reference_s_shard_shape(arch, shape):
    cfg = configs.get_config(arch)
    assert tp_family(cfg)
    ref_shapes, amesh, specs = _reference(arch, shape, AXES)
    ref_flat = _jax_flat(ref_shapes)
    whole = dryrun.meta_params(build_model(cfg))
    plan = model_plan(cfg, Mesh(shape, AXES))
    shards = flatten(shard_params(whole, Mesh(shape, AXES, math.prod(shape) - 1), plan))
    assert set(shards) == set(ref_flat)
    for p, t in shards.items():
        want = NamedSharding(amesh, specs[p].spec).shard_shape(ref_flat[p].shape)
        assert tuple(t.shape) == tuple(want), (p, tuple(t.shape), want)
    if arch == "zamba2_2p7b":  # w_z and w_x on d, conv_x on its taps where 4 divides over model
        d, TP = cfg.d_model, shape[1]
        assert shards["groups/mamba/mamba/w_z"].shape[2:] == (d // TP, 2 * d)
        assert shards["groups/mamba/mamba/conv_x"].shape[2] == (4 // TP if 4 % TP == 0 else 4)
        assert split_dims(plan)["conv_x"] == (0 if 4 % TP == 0 else None)
    else:
        assert shards["layers/u"].shape[1:] == (64 // shape[1], 64)


@pytest.mark.parametrize("shape", [(16, 16), (2, 2)], ids=lambda s: "x".join(map(str, s)))
def test_every_shard_of_the_pure_stack_is_the_reference_s_shard_shape(shape):
    """The pure stack's (L, ...) Mamba2 leaves split by heads: 80 heads of 64,
    5 a rank at 16 and 40 at 2; the leaves its heads share whole."""
    cfg = dataclasses.replace(configs.get_config("zamba2_2p7b"), family="ssm")
    assert tp_family(cfg)
    ref_shapes, amesh, specs = _reference("zamba2_2p7b", shape, AXES, family="ssm")
    ref_flat = _jax_flat(ref_shapes)
    plan = model_plan(cfg, Mesh(shape, AXES))
    shards = flatten(shard_params(dryrun.meta_params(build_model(cfg)), Mesh(shape, AXES, math.prod(shape) - 1), plan))
    assert set(shards) == set(ref_flat)
    for p, t in shards.items():
        want = NamedSharding(amesh, specs[p].spec).shard_shape(ref_flat[p].shape)
        assert tuple(t.shape) == tuple(want), (p, tuple(t.shape), want)
    L, d, TP = cfg.num_layers, cfg.d_model, shape[1]
    assert shards["layers/mamba/w_z"].shape == (L, d, 2 * d // TP) and shards["layers/mamba/A_log"].shape == (L, 80)
    assert shards["layers/mamba/w_out"].shape == (L, 2 * d // TP, d) and shards["layers/mamba/norm_scale"].shape == (
        L, 2 * d // TP)


@pytest.mark.parametrize("multi", [True, False], ids=["multi", "single"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_a_recurrent_train_rank_holds_the_reference_s_shards(arch, multi):
    shape, names = production_mesh_shape(multi)
    cfg = shp.config_for(arch, "train_4k")
    ref_shapes, amesh, specs = _reference(arch, shape, names)
    key, L = build_pipeline_parts(cfg).layer_key + "/", stack_length(cfg)
    batch = dryrun.train_batch(cfg, 8, 16)
    for stage in range(shape[0]) if multi else [None]:
        at = {"pod": stage} if multi else {}
        mesh = Mesh(shape, names, Mesh(shape, names).rank_at(data=0, model=shape[-1] - 1, **at))
        assert model_plan(cfg, mesh) is not None
        program = dryrun.train_program if multi else dryrun.dp_train_program
        _, (params, _, _), _ = program(cfg, mesh, batch)
        lo, hi = stage_layer_range(L, shape[0], stage) if multi else (0, L)
        hi = min(hi, L)
        want = 0
        for p, leaf in _jax_flat(ref_shapes).items():
            whole = ((hi - lo,) + tuple(leaf.shape[1:])) if p.startswith(key) else tuple(leaf.shape)
            want += 4 * math.prod(NamedSharding(amesh, specs[p].spec).shard_shape(whole))
        assert dryrun.argument_bytes(params) == want, (arch, stage)


def _meta_call(arch: str, layers: int, **replace):
    """One ``DataParallelLoss`` call of ``arch`` (with ``replace``'s fields)
    at full width with ``layers`` layers, bf16 activations, remat "full", on
    rank 0 of (data, model) = (1, 2), 4 x 512 tokens, on ``meta``: (cfg, the
    rank's parameters, the transport's counts)."""
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers, dtype=torch.bfloat16, **replace)
    assert cfg.remat == "full"
    mesh = Mesh((1, 2), AXES, 0)
    model, plan = build_model(cfg), model_plan(cfg, mesh)
    params = shard_params(dryrun.meta_params(model), mesh, plan)
    loss_fn = DataParallelLoss(model.loss, mesh, transport=MetaTransport(mesh), plan=plan)
    loss_fn(params, dryrun.train_batch(cfg, 4, 512))
    return cfg, params, loss_fn.transport.counts()


def test_meta_tp_rwkv_bytes_equal_a_count_from_the_code():
    """RWKV-6 7B at 2 layers: ``act`` = (4, 512, 4096) bf16.  A layer:
    forward, ``wo``'s and ``cv``'s outputs reduced and the receptance's
    columns gathered, each twice (the recomputation repeats them: the block's
    last product reads both); backward, the gradients of the time mix's four
    ``copy_in`` inputs, the LoRA's ``tanh`` (4, 512, 64) and ``xk2`` summed.
    Then the embedding's columns (act / 2), the head's input gradient (act),
    the cross entropy's sums (2, 4, 512) f32 and its maxima (4, 512) f32.
    Nothing over ``data`` (one rank)."""
    cfg, params, counts = _meta_call("rwkv6_7b", 2)
    assert params["layers"]["u"].shape == (2, 32, 64)  # 32 of the 64 heads a rank
    tok = 4 * 512
    act = 2 * tok * 4096
    reduce = 2 * (2 * 2 * act + 5 * act + 2 * tok * LORA) + act + 4 * 2 * tok
    gather = 2 * (2 * act // 2) + act // 2 + 4 * tok
    assert counts == {"data": {"send": 0, "all_reduce": 0, "all_gather": 0, "reduce_scatter": 0},
                      "model": {"send": 0, "all_reduce": reduce, "all_gather": gather, "reduce_scatter": 0}}


def test_meta_tp_hybrid_bytes_equal_a_count_from_the_code():
    """Zamba2-2.7B at 12 layers (2 groups of 5 Mamba2 layers and the shared
    block): ``act`` = (4, 512, 2560) bf16, ``inner`` (4, 512, 5120).  A
    Mamba2 layer: forward, ``w_z``'s and ``w_x``'s partial outputs and the
    convolution's partial sums reduced, each twice under remat; backward, the
    convolution's input gradient reduced and the sliced x's gradient gathered
    (act / 2).  The shared block: the attention's and the FFN's outputs
    reduced, twice (the group ends in the FFN's sum times the gate), and their
    inputs' gradients backward.  Then the embedding, the head and the cross
    entropy as RWKV-6's."""
    cfg, params, counts = _meta_call("zamba2_2p7b", 12)
    assert params["groups"]["mamba"]["mamba"]["w_z"].shape == (2, 5, 1280, 5120)
    assert params["groups"]["mamba"]["mamba"]["conv_x"].shape == (2, 5, 2, 5120)
    assert params["shared_attn"]["attn"]["wq"].shape == (2560, 1280)  # 16 of the 32 heads of 80
    tok = 4 * 512
    act, inner = 2 * tok * 2560, 2 * tok * 5120
    reduce = 2 * (5 * (2 * 3 + 1) * inner + (2 * 2 + 2) * act) + act + 4 * 2 * tok
    gather = 2 * 5 * act // 2 + act // 2 + 4 * tok
    assert counts == {"data": {"send": 0, "all_reduce": 0, "all_gather": 0, "reduce_scatter": 0},
                      "model": {"send": 0, "all_reduce": reduce, "all_gather": gather, "reduce_scatter": 0}}


def test_meta_tp_pure_stack_bytes_equal_a_count_from_the_code():
    """The pure Mamba2 stack at Zamba2-2.7B's widths, 6 layers (the card's
    run): ``act`` = (4, 512, 2560) bf16, 40 of the 80 heads a rank.  A
    layer: forward, the gated norm's f32 sum of squares (4, 512, 1) reduced,
    twice (the recomputation repeats it and stops at ``w_out``'s product,
    before its sum), and ``w_out``'s output once; backward, the gradients of
    ``copy_in(x)`` (act), of B and C (4, 512, 128) bf16 and of the sum of
    squares summed, and ``slice_`` gathers those of dt (4, 512, 40) f32, A
    and D (40 f32 each).  Then the embedding, the head and the cross entropy
    as RWKV-6's."""
    cfg, params, counts = _meta_call("zamba2_2p7b", 6, family="ssm")
    m = params["layers"]["mamba"]
    assert m["w_z"].shape == (6, 2560, 2560) and m["w_out"].shape == (6, 2560, 2560) and m["D"].shape == (6, 80)
    tok = 4 * 512
    act = 2 * tok * 2560
    reduce = 6 * (2 * 4 * tok + act + act + 2 * tok * 128 + 4 * tok) + act + 4 * 2 * tok
    gather = 6 * (4 * tok * 40 + 2 * 4 * 40) + act // 2 + 4 * tok
    assert counts == {"data": {"send": 0, "all_reduce": 0, "all_gather": 0, "reduce_scatter": 0},
                      "model": {"send": 0, "all_reduce": reduce, "all_gather": gather, "reduce_scatter": 0}}
