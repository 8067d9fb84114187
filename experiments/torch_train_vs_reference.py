#!/usr/bin/env python3
"""The port's train launcher against the reference's jitted train step on the
CPU, at a width of your choosing: the loss of every step of both, from one
converted init on the same batches.

    PYTHONPATH=src python experiments/torch_train_vs_reference.py [--d-model 1024 --layers 2 \\
        --d-ff 4096 --heads 8 --vocab 50304 --batch 2 --seq 128 --steps 8 --lr 1e-3]

GPT-A's shape (head size 128, gelu, bf16 activations, f32 parameters) with
its width, depth and vocabulary cut to the arguments; ``remat="none"``.
Prints one JSON line.  Runs on the CPU only (JAX and the port's plain
path): keep the sizes small enough for the host's memory.
"""
from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.launch.train import train  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for name, default in (("--d-model", 1024), ("--layers", 2), ("--d-ff", 4096), ("--heads", 8),
                          ("--vocab", 50304), ("--batch", 2), ("--seq", 128), ("--steps", 8)):
        ap.add_argument(name, type=int, default=default)
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args(argv)
    kw = dict(num_layers=args.layers, d_model=args.d_model, num_heads=args.heads, num_kv_heads=args.heads,
              head_dim=128, d_ff=args.d_ff, vocab_size=args.vocab, remat="none")
    ref_cfg = dataclasses.replace(ref_configs.get_config("gpt_a"), **kw)
    cfg = dataclasses.replace(configs.get_config("gpt_a"), **kw)

    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params)
    ocfg = ref_opt.OptimizerConfig(peak_lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1), total_steps=args.steps)
    step = jax.jit(ref_opt.make_train_step(ref_build_model(ref_cfg).loss, ocfg))
    st = ref_opt.init_opt_state(ref_params)
    ref_losses = []
    for b in ref_make_batches(ref_cfg, RefDataConfig(seed=0, batch_size=args.batch, seq_len=args.seq),
                              num_steps=args.steps):
        ref_params, st, m = step(ref_params, st, {k: jnp.asarray(v) for k, v in b.items()})
        ref_losses.append(float(m["loss"]))
    del ref_params, st, step

    hist = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, seed=0,
                 log_every=args.steps, device="cpu", params=convert.from_reference(tree, cfg))["history"]
    losses = [h["loss"] for h in hist]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    print(json.dumps({"config": {k: v for k, v in vars(args).items()}, "reference": ref_losses, "port": losses,
                      "max_rel_diff": max(rel)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
