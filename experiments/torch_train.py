#!/usr/bin/env python3
"""How ``repro_torch`` trains a model on the card: which learning rates the
train phases of ``chip_smoke.py`` tolerate, whether the kernel path and the
plain path part over several steps, and where a step's time goes.

    python3 experiments/torch_train.py [--arch gpt_a --layers 8] [--seq T] [--skip-sweep] [--skip-profile]

Needs one NVIDIA Hopper card and ``nvcc``.  ``--arch`` at full width and at
the config's depth, or ``--layers``, which the script requires where the
train state at full depth (18 B a parameter: f32 parameters, gradients and
moments, and the bf16 computing copy) exceeds the card's memory: GPT-A
(d_model 4096, d_ff 16384, vocabulary 50304) and ``rwkv6_7b`` train with
``--layers 8``; e.g. ``hubert_xlarge`` with ``--seq 1024`` or
``zamba2_2p7b`` at full depth.  Random weights
from seed 0, bf16 activations, f32 parameters and moments, the config's
``remat`` ("full"), batches of 4 x ``--seq`` (512) from ``make_batches(seed
0)``: tokens, or HuBERT's frame embeddings and labels.  Prints JSON lines:

- ``sweep``: 8 steps through ``launch.train.train`` at each learning rate;
  "stable" when every later loss stays below step 0's;
- ``paths``: 3 steps at the launcher's default lr 3e-3, once on the kernel path
  and once on the plain path (masked plain sdpa, plain RMSNorm and the plain
  chunked WKV-6 through autograd), and the loss of the first batch after them;
- ``sensitivity``: one update at lr 1e-5 (no decay) on the first batch: that
  batch's loss before and after, after undoing the update of one top-level
  group of leaves at a time, and each leaf's update over its own size (rms);
- ``profile``: one traced train step, then its loss-and-gradient part and its
  AdamW part apart: the host's wall time, the card's busy time, the idle
  share, the launches, the kernels that took most of the device time, and
  (``picked``) the backward kernels' calls and device time.

The first line names the card and its power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from chip_smoke import plain_path, traced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import flatten  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batches  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.optim.optimizer import (  # noqa: E402
    OptimizerConfig,
    adamw_update,
    gradients,
    init_opt_state,
    make_train_step,
)

SWEEP = (3e-3, 1e-3, 1e-4, 1e-5, 3e-6, 1e-6)
STEPS, BATCH, SEQ = 8, 4, 512
PICK = ("rmsnorm_bwd", "flash_bwd", "wkv6_bwd", "wkv6_du")  # the backward kernels' time a step, wherever they rank
TRAIN_BYTES_PER_PARAM = 18  # f32 parameters, gradients and two moments, and the bf16 computing copy


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def release() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt_a")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth to train at full width (default the config's; required where that does not fit)")
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--skip-sweep", action="store_true")
    ap.add_argument("--skip-profile", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"gpu": smi, "torch": torch.__version__})

    cfg = get_config(args.arch)
    if args.layers is None:
        need = TRAIN_BYTES_PER_PARAM * cfg.param_count()
        have = torch.cuda.get_device_properties(0).total_memory
        if need > have:
            print(f"{cfg.name} at its {cfg.num_layers} layers needs {need / 1e9:.1f} GB of train state, more than "
                  f"the card's {have / 1e9:.1f} GB: give --layers", file=sys.stderr)
            return 2
    layers = args.layers or cfg.num_layers
    cfg = dataclasses.replace(cfg, num_layers=layers)
    seq = args.seq
    model = build_model(cfg)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
               for b in make_batches(cfg, DataConfig(seed=0, batch_size=BATCH, seq_len=seq), num_steps=3)]

    def fresh():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        return model.init(gen)

    if not args.skip_sweep:
        for lr in SWEEP:
            hist = train(cfg, steps=STEPS, batch=BATCH, seq=seq, lr=lr, seed=0, log_every=STEPS, device="cuda")["history"]
            losses = [h["loss"] for h in hist]
            emit({"phase": "sweep", "arch": cfg.name, "layers": layers, "seq": seq, "lr": lr,
                  "stable": max(losses[1:]) < losses[0], "losses": losses,
                  "grad_norms": [h["grad_norm"] for h in hist],
                  "step_ms": [h["seconds"] * 1e3 for h in hist]})
            release()
        ocfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=min(20, 3 // 5 + 1), total_steps=3)
        for name, ctx in (("kernel", contextlib.nullcontext), ("plain", plain_path)):
            params = fresh()
            st = init_opt_state(params)
            step = make_train_step(model.loss, ocfg)
            losses, norms = [], []
            with ctx():
                for b in batches:
                    params, st, m = step(params, st, b)
                    losses.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
                with torch.no_grad():
                    after = float(model.loss(params, batches[0])[0])
            emit({"phase": "paths", "path": name, "lr": 3e-3, "losses": losses, "grad_norms": norms,
                  "batch0_loss_after": after})
            del params, st
            release()

        params = fresh()
        st = init_opt_state(params)
        flat = flatten(params)
        old = {k: v.detach().clone() for k, v in flat.items()}
        with torch.no_grad():
            before = float(model.loss(params, batches[0])[0])
        ocfg = OptimizerConfig(peak_lr=1e-5, warmup_steps=1, total_steps=3, weight_decay=0.0)
        params, st, _ = make_train_step(model.loss, ocfg)(params, st, batches[0])
        undone = {}
        with torch.no_grad():
            after = float(model.loss(params, batches[0])[0])
            for group in params:
                keys = [k for k in flat if k.split("/")[0] == group]
                new = {k: flat[k].detach().clone() for k in keys}
                for k in keys:
                    flat[k].copy_(old[k])
                undone[group] = float(model.loss(params, batches[0])[0])
                for k in keys:
                    flat[k].copy_(new[k])
                del new
            rel = {k: float((flat[k] - old[k]).square().mean().sqrt() / old[k].square().mean().sqrt()) for k in flat}
        emit({"phase": "sensitivity", "lr": 1e-5, "batch0_loss_before": before, "batch0_loss_after": after,
              "batch0_loss_with_group_undone": undone, "update_rms_over_leaf_rms": rel})
        del params, st, old, flat
        release()

    if not args.skip_profile:
        params = fresh()
        st = init_opt_state(params)
        ocfg = OptimizerConfig(peak_lr=3e-6, warmup_steps=2, total_steps=STEPS)
        step = make_train_step(model.loss, ocfg)
        for b in batches[:2]:  # warm-up
            params, st, _ = step(params, st, b)
        emit({"phase": "profile", "part": "step", "arch": cfg.name, "layers": layers, **traced(lambda: step(params, st, batches[2]), top=12, pick=PICK)})
        leaves = list(flatten(params).values())

        def loss_and_grad():
            loss, _ = model.loss(params, batches[2])
            return gradients(loss, leaves)

        emit({"phase": "profile", "part": "loss_and_grad", **traced(loss_and_grad, top=12, pick=PICK)})
        grads = dict(zip(flatten(params), loss_and_grad()))
        with torch.no_grad():
            emit({"phase": "profile", "part": "adamw_update", **traced(lambda: adamw_update(ocfg, grads, params, st), top=8)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
