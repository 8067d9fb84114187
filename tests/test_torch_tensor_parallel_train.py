"""Tensor parallelism over ``model`` trained (ROADMAP 7b-i): ``launch.train.train``
on a (data, model) = (2, 2) mesh of four ``gloo`` ranks on the CPU, gpt_a
smoke in f32 from the reference's ``PRNGKey(0)`` parameters, converted.

Two steps of 8 x 16 leave the ranks that share a ``model`` index bit-equal
and the leaves the plan leaves whole bit-equal on all four; the state, put
back together from the ranks (``unshard``), is within 1e-5 of the reference's
jitted ``make_train_step(model.loss)`` on the same batches.  A step moves 4 B
a parameter of the rank's shards and 8 over ``data``, and over ``model`` what
the design owes (written out below).  With ``ckpt_dir`` rank 0 gathers the
split leaves and their moments and writes the whole state: the file has the
keys, shapes and dtypes of a one-process run's, the reference's
``load_pytree`` reads it, and cut again by the plan it equals every rank's
shards bit for bit.  Under ``torchrun`` the MoE family (7b-ii), RWKV-6 and
the Zamba2 hybrid (7b-iii), which split, carry no note in rank 0's
``[train]`` line; the pure Mamba2 stack's note, which no arch of the launcher
reaches, is held in ``test_torch_tensor_parallel_hybrid.py``."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as ref_configs
from repro.ckpt import checkpoint as ref_ckpt
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import make_batches as ref_make_batches
from repro.models.transformer import build_model as ref_build_model
from repro.optim.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.optim.optimizer import init_opt_state as ref_init_opt_state
from repro.optim.optimizer import make_train_step as ref_make_train_step
from repro_torch import configs, convert
from repro_torch.ckpt.checkpoint import load_pytree
from repro_torch.convert import flatten, unflatten
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import optimizer_config, train
from repro_torch.parallel.sharding import shard_params, unshard
from repro_torch.parallel.tensor_parallel import is_split, model_plan
from torch_helpers import F32_TOL  # noqa: F401  (importing it sets one torch thread, as the spawned ranks run)
from torch_pipeline_helpers import _jax_flat, spawn, train_rank
from torch_tp_helpers import close_in_norm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, AXES = (2, 2), ("data", "model")
STEPS, BATCH, SEQ = 2, 8, 16
REFERENCE_TOL = 1e-5  # the port's f32 step against the reference's (test_torch_optim.py's steps)


def _cfgs():
    return (dataclasses.replace(configs.get_smoke_config("gpt_a"), dtype=torch.float32),
            dataclasses.replace(ref_configs.get_smoke_config("gpt_a"), dtype=jnp.float32))


def model_bytes_owed(cfg, rows: int) -> dict:
    """What a step moves over ``model`` on one rank of the smoke gpt_a, whose
    remat is "none" (no recomputation), in f32 at SEQ tokens: a layer's
    attention and FFN each reduce their output forward and their input's
    gradient backward, (rows, SEQ, d) each; the loss's input gradient too; the
    cross entropy's one chunk reduces (2, rows, SEQ) and gathers its maxima
    (1, rows, SEQ); the embedding gathers its (rows, SEQ, d / TP) columns; the
    clip's norm reduces one f32."""
    act = 4 * rows * SEQ * cfg.d_model
    return {"send": 0, "all_reduce": 4 * cfg.num_layers * act + act + 4 * 2 * rows * SEQ + 4,
            "all_gather": act // SHAPE[1] + 4 * rows * SEQ, "reduce_scatter": 0}


def _state(r) -> dict:
    return {**{"params/" + k: v for k, v in r["params"].items()}, **{"mu/" + k: v for k, v in r["mu"].items()},
            **{"nu/" + k: v for k, v in r["nu"].items()}}


def test_tp_training_is_the_reference_s_jitted_step_and_checkpoints_whole(tmp_path):
    cfg, ref_cfg = _cfgs()
    assert cfg.remat == "none"
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    params = convert.from_reference(jax.tree.map(np.asarray, ref_params), cfg)
    ck = str(tmp_path / "ck")
    runs = [(cfg, SHAPE, AXES, dict(steps=STEPS, batch=BATCH, seq=SEQ, log_every=STEPS, params=params,
                                    ckpt_dir=ck, ckpt_every=1))]
    ranks = [r[0] for r in spawn(train_rank, 4, tmp_path, runs)]
    plan = model_plan(cfg, Mesh(SHAPE, AXES))
    split = {p for p, spec in flatten(plan).items() if is_split(spec)}
    assert split and len(split) < len(flatten(plan))

    by_model = {}
    for r in ranks:
        by_model.setdefault(r["coords"]["model"], []).append(r)
        assert r["losses"] == ranks[0]["losses"] and torch.equal(r["step"], ranks[0]["step"])
        for k, v in _state(r).items():
            if k.split("/", 1)[1] not in split:
                assert torch.equal(v, _state(ranks[0])[k]), k
    for same in by_model.values():
        a, b = (_state(r) for r in same)
        assert all(torch.equal(v, b[k]) for k, v in a.items())

    shard_elems = sum(t.numel() for t in ranks[0]["params"].values())
    assert shard_elems < sum(t.numel() for t in flatten(params).values())
    assert ranks[0]["bytes"]["data"]["all_reduce"] == STEPS * (4 * shard_elems + 8)
    want = model_bytes_owed(cfg, BATCH // SHAPE[0])
    assert ranks[0]["bytes"]["model"] == {k: STEPS * v for k, v in want.items()}

    whole = {part: flatten(unshard([unflatten(by_model[j][0][part]) for j in sorted(by_model)], plan))
             for part in ("params", "mu", "nu")}
    ocfg = optimizer_config(3e-3, STEPS)
    step = jax.jit(ref_make_train_step(ref_build_model(ref_cfg).loss, RefOptimizerConfig(
        peak_lr=ocfg.peak_lr, warmup_steps=ocfg.warmup_steps, total_steps=ocfg.total_steps)))
    p, o = ref_params, ref_init_opt_state(ref_params)
    losses = []
    for b in ref_make_batches(ref_cfg, RefDataConfig(seed=0, batch_size=BATCH, seq_len=SEQ), num_steps=STEPS):
        p, o, m = step(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    close_in_norm(whole["params"], _jax_flat(p), REFERENCE_TOL)
    close_in_norm(whole["mu"], _jax_flat(o.mu), REFERENCE_TOL)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=REFERENCE_TOL)

    path = os.path.join(ck, f"step_{STEPS:08d}.npz")
    assert sorted(f for f in os.listdir(ck) if f.endswith(".npz")) == [f"step_{n:08d}.npz" for n in (1, 2)]
    assert all(r["checkpoint"]["path"] == path for r in ranks)
    plain = train(cfg, steps=1, batch=BATCH, seq=SEQ, log_every=1, device="cpu", ckpt_dir=str(tmp_path / "plain"))
    with np.load(path) as z, np.load(plain["checkpoint"]["path"]) as q:
        assert sorted(z.keys()) == sorted(q.keys())
        assert all(z[k].shape == q[k].shape and z[k].dtype == q[k].dtype for k in q.keys())
        assert int(z["opt/.step"]) == STEPS
    ref_like = {"params": ref_params, "opt": ref_init_opt_state(ref_params)}
    by_ref = ref_ckpt.load_pytree(path, ref_like)
    assert jax.tree.structure(by_ref) == jax.tree.structure(ref_like)
    got = load_pytree(path, {"params": plain["params"], "opt": plain["opt_state"]})
    np.testing.assert_array_equal(np.asarray(by_ref["params"]["layers"]["attn"]["wq"]),
                                  got["params"]["layers"]["attn"]["wq"].numpy())
    for rank, r in enumerate(ranks):
        mesh = Mesh(SHAPE, AXES, rank)
        cut = {"params": shard_params(got["params"], mesh, plan), "mu": shard_params(got["opt"].mu, mesh, plan),
               "nu": shard_params(got["opt"].nu, mesh, plan)}
        for part, tree in cut.items():
            mine = r[part]
            assert set(flatten(tree)) == set(mine)
            for k, v in flatten(tree).items():
                assert v.dtype == mine[k].dtype and torch.equal(v, mine[k]), (rank, part, k)
        assert torch.equal(got["opt"].step, r["step"])


def test_torchrun_says_which_family_keeps_model_replicas():
    """The MoE family (7b-ii), RWKV-6 and the hybrid (7b-iii) split over
    ``model``: their lines carry no note (no family keeps replicas, the pure
    Mamba2 stack included, 7b-v)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "OMP_NUM_THREADS": "1"}
    for arch, key, note in (("qwen2-moe-a2.7b", "qwen2_moe_a2p7b", ""), ("rwkv6-7b", "rwkv6_7b", ""),
                            ("zamba2-2.7b", "zamba2_2p7b", "")):
        cfg = configs.get_smoke_config(key)
        args = ["--arch", arch, "--smoke", "--steps", "1", "--batch", "4", "--seq", "16", "--device", "cpu"]
        r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                            "-m", "repro_torch.launch.train", *args], capture_output=True, text=True, env=env,
                           timeout=300, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[train]")]
        assert lines == [f"[train] arch={cfg.name} device=cpu mesh={{'data': 2, 'model': 2}} "
                         f"params={cfg.param_count() / 1e6:.1f}M{note}"]
