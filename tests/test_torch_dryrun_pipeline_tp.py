"""The dry-run's multi x train under tensor parallelism inside the stages
(ROADMAP 7b-iv): for the dense decoder family a rank of each stage of the
production mesh (pod, data, model) = (2, 16, 16) holds, in f32, exactly the
bytes of the reference's ``NamedSharding(mesh, spec).shard_shape`` of its
stage's rows under the placement plan (fsdp off), and GPT-A's pipelined
tensor-parallel step (4 layers, (2, 1, 2), 8 x 512, bf16 activations: the
card's ``train_pipeline`` phase) puts on each axis the bytes written out
below from the code."""
import dataclasses
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as ref_configs
from repro.models.transformer import build_model as ref_build_model
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import Mesh, production_mesh_shape
from repro_torch.parallel.pipeline import stage_layer_range
from repro_torch.parallel.tensor_parallel import model_plan
from torch_pipeline_helpers import _jax_flat

META = torch.device("meta")
DENSE = ["gpt_a", "gpt_b", "minitron_4b", "nemotron_4_15b", "deepseek_coder_33b", "granite_34b", "qwen2_vl_7b",
         "hubert_xlarge"]


@pytest.mark.parametrize("arch", DENSE)
def test_a_multi_train_rank_holds_the_reference_s_shards_of_its_stage(arch):
    shape, names = production_mesh_shape(True)
    cfg = shp.config_for(arch, "train_4k")
    ref_shapes = jax.eval_shape(ref_build_model(ref_configs.get_config(arch)).init, jax.random.PRNGKey(0))
    amesh = AbstractMesh(shape, names)
    specs = _jax_flat(ref_sharding.make_param_shardings(ref_shapes, amesh))
    batch = dryrun.train_batch(cfg, 8, 16)
    for stage in range(shape[0]):
        mesh = Mesh(shape, names, Mesh(shape, names).rank_at(pod=stage, data=0, model=shape[2] - 1))
        assert model_plan(cfg, mesh) is not None
        _, (params, _, _), _ = dryrun.train_program(cfg, mesh, batch)
        lo, hi = stage_layer_range(cfg.num_layers, shape[0], stage)
        want = 0
        for p, leaf in _jax_flat(ref_shapes).items():
            whole = ((hi - lo,) + tuple(leaf.shape[1:])) if p.startswith("layers/") else tuple(leaf.shape)
            want += 4 * math.prod(NamedSharding(amesh, specs[p].spec).shard_shape(whole))
        assert dryrun.argument_bytes(params) == want, (arch, stage)


ACT = 2 * 512 * 4096 * 2  # a microbatch's activation: 2 rows x 512 x 4096, bf16
REST = 4 * (50304 * 4096 // 2 + 4096 * 50304 // 2 + 4096)  # f32 gradients of embed's and lm_head's blocks, final_norm


# GPT-A, 4 layers, a rank of each stage of (2, 1, 2), one step: the boundary as
# before the slice; pod's all-reduce the blocks of rest, the loss and the norm;
# over model a microbatch reduces 5 activations a layer (remat "full" repeats
# the attention's forward reduction), stage 0 gathers the embedding's columns
# (ACT / 2), the last stage reduces the loss's input gradient (ACT) and the
# cross entropy's sums (2 x 2 x 512 f32) and gathers its maxima (2 x 512 f32),
# striped gathers the received halves (ACT / 2); the norm's 2 f32 over model
@pytest.mark.parametrize("boundary", ["direct", "striped"])
@pytest.mark.parametrize("stage", [0, 1])
def test_meta_pipeline_tp_bytes_equal_a_count_from_the_code(stage, boundary):
    cfg = dataclasses.replace(get_config("gpt_a"), num_layers=4, dtype=torch.bfloat16)
    assert cfg.remat == "full"
    mesh = Mesh((2, 1, 2), ("pod", "data", "model"), 2 * stage)
    tokens = {"tokens": torch.empty((8, 512), dtype=torch.int32, device=META)}
    fn, _, transport = dryrun.train_program(cfg, mesh, tokens, boundary=boundary)
    fn()
    striped = boundary == "striped"
    reduce = 4 * 2 * 5 * ACT + (4 * (ACT + 2 * 2 * 512 * 4) if stage else 0) + 8
    gather = 4 * (ACT // 2 if stage == 0 else 2 * 512 * 4) + (4 * ACT // 2 if striped else 0)
    assert transport.counts() == {
        "pod": {"send": 4 * ACT // (2 if striped else 1), "all_reduce": REST + 8, "all_gather": 0, "reduce_scatter": 0},
        "data": {"send": 0, "all_reduce": 0, "all_gather": 0, "reduce_scatter": 0},
        "model": {"send": 0, "all_reduce": reduce, "all_gather": gather, "reduce_scatter": 0}}
