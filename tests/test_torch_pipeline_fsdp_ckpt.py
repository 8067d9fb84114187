"""Checkpoints of an FSDP state inside the pipeline's stages (ROADMAP Queue 1
(d) with 7f-ii): on one (pod, data, model) = (2, 2, 2) world of ``gloo`` CPU
ranks, in f32 from the port's seed-0 parameters, the pure Mamba2 stack
(zamba2 smoke with ``family="ssm"``) under the plan with fsdp on at a
threshold of 0 (by heads over ``model``; ``data`` on ``norm_scale``'s layer
axis, each stage's two rows split over it: 7f-iii) and the smoke hybrid with
three layers a group at 0 (one group a stage; ``model`` on M for ``w_out``
and ``norm_scale``: 7b-vi).

Each rank trains one pipelined step (``striped``) from its blocks of its
stage; ``gather_train_state`` puts the whole state together on rank 0 (each
stage over ``data`` at each ``model`` index, then over ``model``, then the
stages in layer order), which writes it through ``AsyncCheckpointer``; every
rank steps once more (the live run), then loads the file, cuts it
(``stage_params``, ``shard_params``) and steps once from it.  Held as
``test_torch_fsdp_ckpt.py`` holds the plain step's: the cut state and the
resumed step bit for bit, and the file against the same mesh's run without
fsdp."""
import numpy as np
import pytest
import torch

from repro_torch.convert import expected_shapes
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import tensor_parallel as tp
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import save_inputs, spawn
from torch_stacked_helpers import HYBRID_M2, PURE, axes, ckpt_rank, hold_ckpt, smoke, stacked_paths

SHAPE = (2, 2, 2)
BATCH, SEQ = 8, 32
CASES = {"mamba2_pure": ("zamba2_2p7b", PURE), "hybrid_m2": ("zamba2_2p7b", HYBRID_M2)}
STACKED = {"mamba2_pure": ("data", ["layers/mamba/norm_scale"]),
           "hybrid_m2": ("model", ["groups/mamba/mamba/norm_scale", "groups/mamba/mamba/w_out"])}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.data.pipeline import DataConfig, make_batches

    tmp = tmp_path_factory.mktemp("pipeline_fsdp_ckpt")
    cases, out = [], {}
    for i, (name, (arch, replace)) in enumerate(CASES.items()):
        cfg, _, params = smoke(arch, replace)
        mesh = Mesh(SHAPE, axes(SHAPE))
        plans = {"fsdp": tp.model_plan(cfg, mesh, fsdp=True, min_bytes=0), "tp": tp.model_plan(cfg, mesh)}
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in make_batches(cfg, DataConfig(seed=0, batch_size=BATCH, seq_len=SEQ), num_steps=2)]
        sub = tmp / f"case{i}"
        sub.mkdir()
        cases.append((cfg, *save_inputs(sub, params, batches), plans))
        out[name] = {"cfg": cfg, "plans": plans, "shape": SHAPE}
    results = spawn(ckpt_rank, int(np.prod(SHAPE)), tmp, SHAPE, cases, str(tmp))
    for i, name in enumerate(CASES):
        out[name].update(results=[r[i] for r in results], file=str(tmp / f"case{i}" / f"step_{1:08d}.npz"))
    return out


@pytest.mark.parametrize("name", CASES)
def test_the_plan_splits_a_stacked_axis(world, name):
    axis, paths = STACKED[name]
    assert stacked_paths(world[name]["plans"]["fsdp"], axis) == paths


@pytest.mark.parametrize("name", CASES)
def test_a_checkpoint_of_the_fsdp_state_resumes_bit_for_bit(world, name):
    case = world[name]
    with np.load(case["file"]) as z:
        shapes = {k: z[k].shape for k in z.keys()}
        assert int(z["opt/.step"]) == 1
    for p, s in expected_shapes(case["cfg"]).items():
        assert shapes[f"params/{p}"] == tuple(s) and shapes[f"opt/.nu/{p}"] == tuple(s), p
    hold_ckpt(case)
