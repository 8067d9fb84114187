"""Checkpoints under the pipeline (ROADMAP.md Queue 1, 7c):
``launch.train.train`` on a (2, 1, 2) (pod, data, model) mesh of four
``gloo`` ranks on the CPU, with ``ckpt_dir`` and a save after every step.
Rank 0 writes one ``step_<n>.npz`` a save holding the whole, unpadded state:
its keys, shapes and dtypes are those of a plain run's file, the reference's
``load_pytree`` reads it into the reference's own init tree, the padded row of
a stack that needs one (DeepSeek-V2-Lite smoke cut to 3 layers: 2 rows a
stage, the last padded) is not in it, and cut back into stages
(``stage_params``) it equals every rank's own parameters, moments and step bit
for bit.  ``assemble_params`` undoes ``stage_params``."""
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
from repro_torch.parallel.pipeline import assemble_params, stage_params
from torch_pipeline_helpers import spawn, train_rank

SHAPE, AXES = (2, 1, 2), ("pod", "data", "model")
STEPS, BATCH, SEQ = 3, 8, 16
CASES = {"gpt_a": {}, "deepseek_v2_lite_16b": {"num_layers": 3}}


def _cfgs(arch):
    rep = CASES[arch]
    return (dataclasses.replace(configs.get_smoke_config(arch), dtype=torch.float32, **rep),
            dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jnp.float32, **rep))


def _equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k, v in a.items():
        assert v.dtype == b[k].dtype and torch.equal(v, b[k]), k


def test_pipelined_checkpoints_hold_the_whole_unpadded_state(tmp_path):
    runs = [(_cfgs(arch)[0], SHAPE, AXES, dict(steps=STEPS, batch=BATCH, seq=SEQ, log_every=STEPS, pipeline=True,
                                               ckpt_dir=str(tmp_path / arch), ckpt_every=1)) for arch in CASES]
    ranks = spawn(train_rank, 4, tmp_path, runs)
    for i, arch in enumerate(CASES):
        cfg, ref_cfg = _cfgs(arch)
        d = tmp_path / arch
        assert sorted(f for f in os.listdir(d) if f.endswith(".npz")) == [f"step_{n:08d}.npz" for n in (1, 2, 3)]
        path = str(d / f"step_{STEPS:08d}.npz")
        assert all(r[i]["checkpoint"]["path"] == path for r in ranks)

        plain = train(cfg, steps=1, batch=BATCH, seq=SEQ, log_every=1, device="cpu",
                      ckpt_dir=str(tmp_path / f"{arch}_plain"))
        with np.load(path) as z, np.load(plain["checkpoint"]["path"]) as p:
            assert sorted(z.keys()) == sorted(p.keys())
            for k in p.keys():
                assert z[k].shape == p[k].shape and z[k].dtype == p[k].dtype, k
            assert z["params/layers/ln1"].shape[0] == cfg.num_layers  # no padded row
            assert int(z["opt/.step"]) == STEPS

        ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
        ref_like = {"params": ref_params, "opt": ref_init_opt_state(ref_params)}
        by_ref = ref_ckpt.load_pytree(path, ref_like)
        got = load_pytree(path, {"params": plain["params"], "opt": plain["opt_state"]})
        ref_flat = {"/".join(str(getattr(q, "key", getattr(q, "name", q))) for q in p): np.asarray(v)
                    for p, v in jax.tree_util.tree_flatten_with_path(by_ref)[0]}
        port_flat = {"params/" + k: v for k, v in flatten(got["params"]).items()}
        port_flat.update({"opt/mu/" + k: v for k, v in flatten(got["opt"].mu).items()})
        port_flat.update({"opt/nu/" + k: v for k, v in flatten(got["opt"].nu).items()})
        port_flat["opt/step"] = got["opt"].step
        assert set(ref_flat) == set(port_flat)
        for k, v in port_flat.items():
            assert np.array_equal(ref_flat[k], v.numpy()), k

        stages = []
        for rank, res in enumerate(ranks):
            mine, mesh = res[i], Mesh(SHAPE, AXES, rank)
            _equal(flatten(stage_params(got["params"], cfg, mesh)), mine["params"])
            _equal(flatten(stage_params(got["opt"].mu, cfg, mesh)), mine["mu"])
            _equal(flatten(stage_params(got["opt"].nu, cfg, mesh)), mine["nu"])
            assert torch.equal(got["opt"].step, mine["step"])
            if mesh.coords["model"] == 0:
                stages.append(stage_params(got["params"], cfg, mesh))
        _equal(flatten(assemble_params(stages, cfg)), flatten(got["params"]))
