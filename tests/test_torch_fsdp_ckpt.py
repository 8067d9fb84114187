"""Checkpoints of an FSDP state on the plain step (ROADMAP Queue 1 (d)): on
one (data, model) = (2, 2) world of ``gloo`` CPU ranks, in f32 from the port's
seed-0 parameters, RWKV-6's smoke under the plan with fsdp on at a threshold
of 0 (``data`` on every leaf it divides, ``w0``'s layer axis among them:
7f-iii) and the smoke hybrid with three layers a group at 0 (``model`` on M
for ``w_out`` and ``norm_scale``: 7b-vi, and ``data`` on other dims).

Each rank trains one step from its blocks; ``gather_train_state`` puts the
whole state together on rank 0 (over ``data`` at each ``model`` index, then
over ``model``), which writes it through ``AsyncCheckpointer``; every rank
steps once more (the live run), then loads the file, cuts it by the plan
(``shard_params``) and steps once from it.  Held: the file's keys and shapes
are a whole model's; the cut state is every rank's live blocks, moments and
step bit for bit; the resumed step is the live step bit for bit; and the
file's leaves are the same mesh's run under the plan without fsdp (the
tensor-parallel plan) gathered alike, bit for bit where the two runs' blocks
are, else within 1e-5 of its largest entry (the clip's norm is summed in
another order)."""
import numpy as np
import pytest
import torch

from repro_torch.convert import expected_shapes, flatten
from repro_torch.launch.mesh import Mesh
from repro_torch.parallel import tensor_parallel as tp
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import save_inputs, spawn
from torch_stacked_helpers import HYBRID_M2, axes, ckpt_rank, hold_ckpt, smoke

SHAPE = (2, 2)
BATCH, SEQ = 4, 32
CASES = {"rwkv6_7b": ("rwkv6_7b", {}), "hybrid_m2": ("zamba2_2p7b", HYBRID_M2)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.data.pipeline import DataConfig, make_batches

    tmp = tmp_path_factory.mktemp("fsdp_ckpt")
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
def test_the_plan_splits_what_the_case_names(world, name):
    fplan = world[name]["plans"]["fsdp"]
    stacked = {"rwkv6_7b": ("data", ["layers/w0"]),
               "hybrid_m2": ("model", ["groups/mamba/mamba/norm_scale", "groups/mamba/mamba/w_out"])}[name]
    from torch_stacked_helpers import stacked_paths

    assert stacked_paths(fplan, stacked[0]) == stacked[1]
    assert tp.split_paths(fplan, "data")


@pytest.mark.parametrize("name", CASES)
def test_a_checkpoint_of_the_fsdp_state_resumes_bit_for_bit(world, name):
    case = world[name]
    with np.load(case["file"]) as z:
        shapes = {k: z[k].shape for k in z.keys()}
    for p, s in expected_shapes(case["cfg"]).items():
        assert shapes[f"params/{p}"] == tuple(s) and shapes[f"opt/.mu/{p}"] == tuple(s), p
    hold_ckpt(case)
