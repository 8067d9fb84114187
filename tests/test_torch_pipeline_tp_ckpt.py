"""Checkpoints of a pipeline that is tensor-parallel inside its stages (ROADMAP
7b-iv, with 7c): ``launch.train.train`` with ``pipeline`` and ``ckpt_dir`` on
a (pod, data, model) = (2, 2, 2) mesh of eight ``gloo`` CPU ranks, gpt_a smoke
in f32, three steps and a save after each.  Rank 0 alone writes one
``step_<n>.npz`` a save; the last holds the whole state: its keys, shapes and
dtypes are a plain run's, the reference's ``load_pytree`` reads it into the
reference's own init tree, it is bit for bit the state put together from the
ranks' blocks of their stages (``assemble_blocks``), and cut into stages and
blocks (``stage_params``, ``shard_params``) it is every rank's own parameters,
moments and step."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.ckpt import checkpoint as ref_ckpt
from repro.models.transformer import build_model as ref_build_model
from repro.optim.optimizer import init_opt_state as ref_init_opt_state
from repro_torch import configs
from repro_torch.ckpt.checkpoint import load_pytree
from repro_torch.convert import flatten
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import train
from repro_torch.parallel.pipeline import stage_params
from repro_torch.parallel.sharding import shard_params
from repro_torch.parallel.tensor_parallel import model_plan
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import _jax_flat, assemble_blocks, spawn, train_rank

SHAPE, AXES = (2, 2, 2), ("pod", "data", "model")
STEPS, BATCH, SEQ = 3, 8, 16


def test_a_tensor_parallel_pipelined_checkpoint_is_the_gathered_state(tmp_path):
    cfg = dataclasses.replace(configs.get_smoke_config("gpt_a"), dtype=torch.float32)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("gpt_a"), dtype=jnp.float32)
    ck = tmp_path / "ck"
    runs = [(cfg, SHAPE, AXES, dict(steps=STEPS, batch=BATCH, seq=SEQ, log_every=STEPS, pipeline=True,
                                    ckpt_dir=str(ck), ckpt_every=1))]
    ranks = [r[0] for r in spawn(train_rank, 8, tmp_path, runs)]
    plan = model_plan(cfg, Mesh(SHAPE, AXES))
    assert plan is not None
    assert sorted(f for f in os.listdir(ck) if f.endswith(".npz")) == [f"step_{n:08d}.npz" for n in (1, 2, 3)]
    path = str(ck / f"step_{STEPS:08d}.npz")
    assert all(r["checkpoint"]["path"] == path for r in ranks)

    plain = train(cfg, steps=1, batch=BATCH, seq=SEQ, log_every=1, device="cpu", ckpt_dir=str(tmp_path / "plain"))
    with np.load(path) as z, np.load(plain["checkpoint"]["path"]) as q:
        assert sorted(z.keys()) == sorted(q.keys())
        assert all(z[k].shape == q[k].shape and z[k].dtype == q[k].dtype for k in q.keys())
        assert int(z["opt/.step"]) == STEPS
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    ref_like = {"params": ref_params, "opt": ref_init_opt_state(ref_params)}
    by_ref = ref_ckpt.load_pytree(path, ref_like)
    assert jax.tree.structure(by_ref) == jax.tree.structure(ref_like)
    got = load_pytree(path, {"params": plain["params"], "opt": plain["opt_state"]})
    for part, tree in (("params", got["params"]), ("mu", got["opt"].mu), ("nu", got["opt"].nu)):
        whole = assemble_blocks(ranks, cfg, plan, lambda r: r[part])
        mine = flatten(tree)
        assert set(whole) == set(mine) and all(torch.equal(v, mine[k]) for k, v in whole.items()), part
    np.testing.assert_array_equal(np.asarray(_jax_flat(by_ref["params"])["layers/attn/wq"]),
                                  got["params"]["layers"]["attn"]["wq"].numpy())
    for rank, r in enumerate(ranks):
        mesh = Mesh(SHAPE, AXES, rank)
        for part, tree in (("params", got["params"]), ("mu", got["opt"].mu), ("nu", got["opt"].nu)):
            cut = flatten(shard_params(stage_params(tree, cfg, mesh), mesh, plan))
            assert set(cut) == set(r[part])
            for k, v in cut.items():
                assert v.dtype == r[part][k].dtype and torch.equal(v, r[part][k]), (rank, part, k)
        assert torch.equal(got["opt"].step, r["step"])
