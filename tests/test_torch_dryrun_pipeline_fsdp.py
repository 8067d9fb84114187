"""The dry-run's multi x train under FSDP over ``data`` inside the stages
(ROADMAP 7f-ii), the reference's dry-run's program for its train shapes.

  * A rank of each stage of the production mesh (pod, data, model) = (2, 16,
    16) holds, in f32, exactly the reference's
    ``NamedSharding(AbstractMesh, spec).shard_shape`` of each leaf of its
    stage's rows under ``make_param_shardings(fsdp=True)``, for every
    architecture the sweep runs.
  * ``run_one(..., "multi")`` on a train shape is FSDP by default
    (``"program": "pipeline+fsdp"``), and ``fsdp=False`` is the program
    without it: each stage's ``data`` bytes are what the code owes either way.
  * GPT-A's pipelined FSDP call (2 layers, (2, 2, 1), 8 x 512, n_micro 4,
    bf16 activations: the card's ``train_pipeline_fsdp`` phase) puts on each
    axis the bytes written out below from the code."""
import dataclasses
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro import configs as ref_configs
from repro.models.transformer import build_model as ref_build_model
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import flatten
from repro_torch.launch import dryrun
from repro_torch.launch import shapes as shp
from repro_torch.launch.mesh import Mesh, production_mesh_shape
from repro_torch.models.transformer import build_pipeline_parts
from repro_torch.parallel import fsdp
from repro_torch.parallel.pipeline import PipelineLoss, stack_length, stage_layer_range
from repro_torch.parallel.tensor_parallel import model_plan
from repro_torch.parallel.transport import MetaTransport
from torch_pipeline_helpers import _jax_flat

META = torch.device("meta")
AXES = ("pod", "data", "model")


@pytest.mark.parametrize("arch", ARCHS[:10])
def test_a_multi_train_rank_holds_the_reference_s_fsdp_blocks_of_its_stage(arch):
    shape, names = production_mesh_shape(True)
    cfg = shp.config_for(arch, "train_4k")
    ref_shapes = jax.eval_shape(ref_build_model(ref_configs.get_config(arch)).init, jax.random.PRNGKey(0))
    amesh = AbstractMesh(shape, names)
    specs = _jax_flat(ref_sharding.make_param_shardings(ref_shapes, amesh, fsdp=True))
    key, L = build_pipeline_parts(cfg).layer_key + "/", stack_length(cfg)
    batch = dryrun.train_batch(cfg, 8, 16)
    for stage in range(shape[0]):
        mesh = Mesh(shape, names, Mesh(shape, names).rank_at(pod=stage, data=shape[1] - 1, model=shape[2] - 1))
        _, (params, _, _), _ = dryrun.train_program(cfg, mesh, batch, fsdp=True)
        lo, hi = stage_layer_range(L, shape[0], stage)
        hi = min(hi, L)
        got = {p: tuple(t.shape) for p, t in flatten(params).items()}
        assert set(got) == set(specs)
        for p, leaf in _jax_flat(ref_shapes).items():
            whole = ((hi - lo,) + tuple(leaf.shape[1:])) if p.startswith(key) else tuple(leaf.shape)
            assert got[p] == tuple(NamedSharding(amesh, specs[p].spec).shard_shape(whole)), (arch, stage, p)
        assert any("data" in tuple(specs[p].spec) for p in got), arch


def _rank_data_bytes(cfg, mesh, batch, *, use_fsdp: bool) -> dict:
    """What one step of the rank's program puts on ``data``, from the code:
    under FSDP each data-split block gathered once, its gradient
    reduce-scattered once (DP x the block), the leaves whole over ``data``
    all-reduced with the loss (4 B) and the norm's four sums (16 B); without
    it every gradient all-reduced with the loss."""
    _, (params, _, _), _ = dryrun.train_program(cfg, mesh, batch, fsdp=use_fsdp)
    split = fsdp.data_dims(model_plan(cfg, mesh, fsdp=use_fsdp))
    blocks = {p: t.numel() for p, t in flatten(params).items()}
    gathered = 4 * sum(n for p, n in blocks.items() if p in split)
    whole = 4 * sum(n for p, n in blocks.items() if p not in split)
    return {"send": 0, "all_reduce": whole + 4 + (16 if split else 0), "all_gather": gathered,
            "reduce_scatter": mesh.shape["data"] * gathered}


@pytest.fixture(scope="module")
def hubert_rows():
    return {f: dryrun.run_one("hubert_xlarge", "train_4k", "multi", fsdp=f) for f in (None, False)}


@pytest.mark.parametrize("default", [True, False], ids=["default", "no_fsdp"])
def test_run_one_multi_train_is_fsdp_by_default(hubert_rows, default):
    r = hubert_rows[None if default else False]
    cfg = shp.config_for("hubert_xlarge", "train_4k")
    shape, names = production_mesh_shape(True)
    assert r["status"] == "ok" and r["fsdp"] is default and r["plan"]["fsdp"] is default
    assert r["program"] == ("pipeline+fsdp" if default else "pipeline") and r["tensor_parallel"]
    assert r["plan_bytes_per_device"] == dryrun.plan_bytes(cfg, Mesh(shape, names), fsdp=default)
    batch = dryrun.train_batch(cfg, shp.SHAPES["train_4k"]["global_batch"], shp.SHAPES["train_4k"]["seq_len"])
    for stage, figs in r["stages"].items():
        mesh = Mesh(shape, names, Mesh(shape, names).rank_at(pod=int(stage)))
        assert figs["collectives"]["by_axis"]["data"] == _rank_data_bytes(cfg, mesh, batch, use_fsdp=default)
    on, off = (hubert_rows[f]["stages"]["0"] for f in (None, False))
    assert on["memory"]["argument_bytes"] < off["memory"]["argument_bytes"]
    assert on["collectives"]["by_axis"]["model"] == off["collectives"]["by_axis"]["model"]


ACT = 1 * 512 * 4096 * 2  # a microbatch's data shard: 8 / (4 x 2) rows x 512 x 4096, bf16
LAYER = 12 * 4096 * 4096  # a GPT-A layer's matrices: wq, wk, wv, wo and the FFN's two (4 x 4096)
VOCAB = 50304


# GPT-A, 2 layers (one a stage), a rank of each stage of (2, 2, 1), one call
# and its norm: the plan at 4 MiB splits the layer's six matrices, embed (on
# its rows) and lm_head (on d) over data; each block is gathered once, its
# gradient reduce-scattered once; the norms (ln1, ln2, final_norm: 3 x 4096)
# stay whole, all-reduced with the loss and the norm's four sums.  pod: a
# boundary sends 4 activations, forward from stage 0 and back from stage 1;
# rest's blocks, the loss and the layers' squares all-reduced.
@pytest.mark.parametrize("boundary", ["direct", "striped"])
@pytest.mark.parametrize("stage", [0, 1])
def test_meta_pipeline_fsdp_bytes_equal_a_count_from_the_code(stage, boundary):
    cfg = dataclasses.replace(get_config("gpt_a"), num_layers=2, dtype=torch.bfloat16)
    mesh = Mesh((2, 2, 1), AXES, 2 * stage)
    plan = model_plan(cfg, mesh, fsdp=True)
    assert sorted(fsdp.data_dims(plan)) == sorted(["embed", "lm_head", "layers/attn/wq", "layers/attn/wk",
                                                   "layers/attn/wv", "layers/attn/wo", "layers/ffn/w_up",
                                                   "layers/ffn/w_down"])
    tokens = {"tokens": torch.empty((8, 512), dtype=torch.int32, device=META)}
    _, (params, _, _), _ = dryrun.train_program(cfg, mesh, tokens, boundary=boundary, fsdp=True)
    loss_fn = PipelineLoss(cfg, mesh, 4, boundary, transport=MetaTransport(mesh), plan=plan)
    _, grads = loss_fn(params, tokens)
    loss_fn.grad_norm(grads)
    blocks = LAYER // 2 + VOCAB * 4096 // 2 * 2  # the layer's and rest's data blocks
    assert math.prod(params["embed"].shape) == VOCAB * 4096 // 2
    assert loss_fn.transport.counts() == {
        "pod": {"send": 4 * ACT, "all_reduce": 4 * (VOCAB * 4096 + 4096) + 8, "all_gather": 0, "reduce_scatter": 0},
        "data": {"send": 0, "all_reduce": 4 * 3 * 4096 + 4 + 16, "all_gather": 4 * blocks,
                 "reduce_scatter": 2 * 4 * blocks},
        "model": {"send": 0, "all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}}
