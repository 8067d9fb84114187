"""The dry-run's train programs for the MoE and MLA families under tensor
parallelism (ROADMAP 7b-ii): a rank of Qwen1.5-MoE and of DeepSeek-V2-Lite at
full size holds, in f32, exactly the bytes of the reference's
``NamedSharding(mesh, spec).shard_shape`` under the placement plan (fsdp off):
under multi x train (pod, data, model) = (2, 16, 16) a rank of each stage, of
its stage's rows; under single x train (data, model) = (16, 16) a rank of the
plain data-parallel step, of the whole model.  Qwen1.5-MoE's 60 experts split
on their features there, DeepSeek-V2-Lite's 64 on the expert dim."""
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as ref_configs
from repro.models.transformer import build_model as ref_build_model
from repro.parallel import sharding as ref_sharding
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import Mesh, production_mesh_shape
from repro_torch.parallel.pipeline import stage_layer_range
from repro_torch.parallel.tensor_parallel import model_plan, split_dims
from torch_pipeline_helpers import _jax_flat

MOE = ["qwen2_moe_a2p7b", "deepseek_v2_lite_16b"]


@pytest.mark.parametrize("multi", [True, False], ids=["multi", "single"])
@pytest.mark.parametrize("arch", MOE)
def test_a_moe_train_rank_holds_the_reference_s_shards(arch, multi):
    shape, names = production_mesh_shape(multi)
    cfg = shp.config_for(arch, "train_4k")
    ref_shapes = jax.eval_shape(ref_build_model(ref_configs.get_config(arch)).init, jax.random.PRNGKey(0))
    amesh = AbstractMesh(shape, names)
    specs = _jax_flat(ref_sharding.make_param_shardings(ref_shapes, amesh))
    batch = dryrun.train_batch(cfg, 8, 16)
    stages = range(shape[0]) if multi else [None]
    for stage in stages:
        at = {"pod": stage} if multi else {}
        mesh = Mesh(shape, names, Mesh(shape, names).rank_at(data=0, model=shape[-1] - 1, **at))
        plan = model_plan(cfg, mesh)
        assert plan is not None
        routed = split_dims(plan)["moe/w_gate"]
        assert routed == (2 if cfg.moe.num_experts % shape[-1] else 0)
        program = dryrun.train_program if multi else dryrun.dp_train_program
        _, (params, _, _), _ = program(cfg, mesh, batch)
        lo, hi = stage_layer_range(cfg.num_layers, shape[0], stage) if multi else (0, cfg.num_layers)
        hi = min(hi, cfg.num_layers)
        want = 0
        for p, leaf in _jax_flat(ref_shapes).items():
            whole = ((hi - lo,) + tuple(leaf.shape[1:])) if p.startswith("layers/") else tuple(leaf.shape)
            want += 4 * math.prod(NamedSharding(amesh, specs[p].spec).shard_shape(whole))
        assert dryrun.argument_bytes(params) == want, (arch, stage)


def test_meta_tp_moe_bytes_equal_a_count_from_the_code():
    """The card's ``train_tp_moe`` call on ``meta``: DeepSeek-V2-Lite at full
    width with 2 layers, rank 0 of (data, model) = (2, 2), 8 x 512 tokens
    (4 rows a rank), bf16 activations, remat "full".  ``act`` = (4, 512,
    2048) bf16.  A layer, forward: MLA's output reduction (act), the shared
    expert's three (its two (4, 512, 2816) products, then act), and the
    gather of the rank's half of ``out_buf`` (4, 32, 64, 2048); the
    recomputation in the backward repeats all of these but the shared
    expert's last reduction, whose output no backward reads.  Backward: the
    sums of x's gradient into the queries (act) and into the dispatch (act),
    of the latent's (4, 512, 576), and the gathers of the shared expert's two
    sliced inputs' gradients, (4, 512, 1024) and (4, 512, 1408).  Then the
    embedding's columns (act / 2), the head's input gradient (act), the cross
    entropy's sums (2, 4, 512) f32 and its maxima (4, 512) f32.  Over
    ``data``: the gradients of the rank's 795,879,424 parameters in f32, the
    mask count and the loss, and each layer's aux means (2, 64) f32, twice."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import flatten
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel.data_parallel import DataParallelLoss
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.transport import MetaTransport

    cfg = dataclasses.replace(get_config("deepseek_v2_lite_16b"), num_layers=2, dtype=torch.bfloat16)
    assert cfg.remat == "full"
    mesh = Mesh((2, 2), ("data", "model"), 0)
    model, plan = build_model(cfg), model_plan(cfg, mesh)
    params = shard_params(dryrun.meta_params(model), mesh, plan)
    assert sum(t.numel() for t in flatten(params).values()) == 795_879_424
    loss_fn = DataParallelLoss(model.loss, mesh, transport=MetaTransport(mesh), plan=plan)
    loss_fn(params, dryrun.train_batch(cfg, 8, 512))
    act = 2 * 4 * 512 * 2048
    shared_h = 2 * 4 * 512 * 2816
    out_buf = 2 * 4 * 32 * 64 * 2048
    assert out_buf == 33_554_432  # the rank's half of a (4, 64, 64, 2048) bf16 buffer of 67,108,864 B
    forward = act + 2 * shared_h + act
    recomputed = act + 2 * shared_h
    backward = 2 * act + 2 * 4 * 512 * 576
    reduce = 2 * (forward + recomputed + backward) + act + 4 * 2 * 4 * 512
    gather = 2 * (2 * out_buf + 2 * 4 * 512 * (1024 + 1408)) + act // 2 + 4 * 4 * 512
    assert loss_fn.transport.counts() == {
        "data": {"send": 0, "all_reduce": 4 * 795_879_424 + 8 + 2 * 2 * 2 * 64 * 4, "all_gather": 0,
                 "reduce_scatter": 0},
        "model": {"send": 0, "all_reduce": reduce, "all_gather": gather, "reduce_scatter": 0}}
