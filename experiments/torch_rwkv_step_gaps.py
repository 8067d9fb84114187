#!/usr/bin/env python3
"""How far 15 bf16 train steps of RWKV-6 part between runs that compute the
same function: the port against the reference's jitted step, and each against
itself with one thing changed.  Runs on the CPU (JAX and the port's plain
path), at ``tests/test_torch_train.py``'s settings: rwkv6_7b smoke, batches of
8 x 32, lr 3e-3, one converted init, the same batches, PyTorch on one thread.

    PYTHONPATH=src python experiments/torch_rwkv_step_gaps.py

The runs:

- ``ref``: the reference's jitted step, XLA's default compile (a fusion keeps
  its bf16 intermediates in f32);
- ``ref_every_op``: the same compiled with ``xla_allow_excess_precision``
  off, so that every bf16 op rounds its result, as PyTorch's eager ops do;
- ``ref_chunk16``, ``ref_every_op_chunk16``: those two with the WKV in chunks
  of 16 instead of the config's 32 (another order of f32 sums, nothing else);
- ``port``: the port's launcher, the WKV differentiated through ``WKV6Fn``;
- ``port_autograd``: the port with autograd through the plain chunked WKV
  forward instead (another order of f32 sums in the WKV's backward).

Prints one JSON line: each run's losses, and for each pair of runs the
largest relative gap of a step's loss.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro import configs as ref_configs  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import make_batches as ref_make_batches  # noqa: E402
from repro.models.transformer import build_model as ref_build_model  # noqa: E402
from repro.optim import optimizer as ref_opt  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import wkv6 as wkv_mod  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

STEPS, BATCH, SEQ, LR = 15, 8, 32, 3e-3
EVERY_OP = {"xla_allow_excess_precision": False}
# one thread, as the tests run the port: on several, one process in a few sums
# some CPU reduction in another order, and the 15 steps carry that as far as
# any change below
torch.set_num_threads(1)


def reference_losses(chunk: int, compiler_options=None) -> list:
    cfg = dataclasses.replace(ref_configs.get_smoke_config("rwkv6_7b"), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, rwkv=dataclasses.replace(cfg.rwkv, chunk=chunk))
    params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    ocfg = ref_opt.OptimizerConfig(peak_lr=LR, warmup_steps=min(20, STEPS // 5 + 1), total_steps=STEPS)
    jitted = jax.jit(ref_opt.make_train_step(ref_build_model(cfg).loss, ocfg))
    st = ref_opt.init_opt_state(params)
    step, losses = None, []
    for b in ref_make_batches(cfg, RefDataConfig(seed=0, batch_size=BATCH, seq_len=SEQ), num_steps=STEPS):
        b = {k: jnp.asarray(v) for k, v in b.items()}
        if step is None:
            step = jitted.lower(params, st, b).compile(compiler_options) if compiler_options else jitted
        params, st, m = step(params, st, b)
        losses.append(float(m["loss"]))
    return losses


@contextlib.contextmanager
def autograd_through_plain():
    """``ops.wkv6`` differentiates the plain chunked forward by autograd
    instead of going through ``WKV6Fn``."""
    class Plain:
        @staticmethod
        def apply(r, k, v, logw, u, chunk):
            return wkv_mod.wkv6_plain(r, k, v, logw, u, None, chunk=chunk)[0]

    fn = wkv_mod.WKV6Fn
    wkv_mod.WKV6Fn = Plain
    try:
        yield
    finally:
        wkv_mod.WKV6Fn = fn


def port_losses() -> list:
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("rwkv6_7b"), dtype=jnp.bfloat16)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_build_model(ref_cfg).init(jax.random.PRNGKey(0)))
    cfg = dataclasses.replace(configs.get_smoke_config("rwkv6_7b"), dtype=torch.bfloat16)
    out = train(cfg, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, seed=0, log_every=STEPS, device="cpu",
                params=convert.from_reference(tree, cfg))
    return [h["loss"] for h in out["history"]]


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    runs = {"ref": reference_losses(32), "ref_every_op": reference_losses(32, EVERY_OP),
            "ref_chunk16": reference_losses(16), "ref_every_op_chunk16": reference_losses(16, EVERY_OP),
            "port": port_losses()}
    with autograd_through_plain():
        runs["port_autograd"] = port_losses()
    gaps = {f"{a} vs {b}": float(np.max(np.abs(np.subtract(runs[a], runs[b])) / np.abs(runs[b])))
            for a, b in itertools.combinations(runs, 2)}
    print(json.dumps({"device": "cpu", "losses": runs, "max_relative_gap": gaps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
