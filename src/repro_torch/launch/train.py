"""Training launcher: data pipeline -> train step (loss, gradients through the
kernels' backward, AdamW) -> metrics.  Counterpart of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gpt-a --smoke \\
      --steps 200 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch gpt-a \\
      --smoke --steps 4 --batch 8 --seq 32 --log-every 1
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --arch hubert-xlarge \\
      --smoke --steps 6 --batch 4 --seq 32 --ckpt-dir local/ck --ckpt-every 2
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 8 \\
      -m repro_torch.launch.train --arch minitron-4b --smoke --pipeline --steps 2 --device cpu

Runs on the card; ``--device cpu`` runs the plain PyTorch path on the CPU.
With ``--ckpt-dir`` the train state ``{"params", "opt"}`` is checkpointed in
the reference's format (``repro_torch.ckpt``) every ``--ckpt-every`` steps and
at the end.  As in the reference, a periodic checkpoint is named by the loop
index of the step it follows: ``step_00000004.npz`` holds the state after 5
updates (its ``opt/.step`` reads 5); the final one is ``step_<steps>``.  There
is no resume flag (the reference has none): to continue, ``load_pytree`` the
state and run ``make_train_step`` on the batches from ``opt/.step`` on.

``--pipeline`` runs the cross-pod pipeline (``repro_torch.parallel.pipeline``)
over the ranks that ``torch.distributed.run`` (torchrun) starts: each reads
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, joins a ``gloo`` process group,
and on the card takes ``cuda:(LOCAL_RANK % device_count)``, so every rank
shares the one card of a one-card machine.  The mesh is the reference's host
mesh over the world (``--production-mesh``: the (2, 16, 16) mesh, which needs
exactly 512 ranks).  Rank 0 prints the lines.  Not yet ported: a plain
(non-pipelined) step over several ranks and checkpoints under ``--pipeline``
(ROADMAP.md Queue 1, slices 7d and 7c); both raise.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.ckpt.checkpoint import AsyncCheckpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import TIMEOUT, Mesh, make_host_mesh, make_production_mesh
from repro_torch.models.modules import ModelConfig, Params
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state, make_train_step
from repro_torch.parallel.pipeline import make_pipeline_loss, stage_params


def optimizer_config(lr: float, steps: int) -> OptimizerConfig:
    """The launcher's schedule for a run of ``steps`` steps, as the reference's."""
    return OptimizerConfig(peak_lr=lr, warmup_steps=min(20, steps // 5 + 1), total_steps=steps)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, lr: float = 3e-3, seed: int = 0,
          log_every: int = 10, device=None, params: Optional[Params] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, mesh: Optional[Mesh] = None, pipeline: bool = False, n_micro: int = 4,
          boundary: str = "striped") -> Dict:
    """Trains ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens from
    ``make_batches(seed)``, from ``params`` (updated in place) or from random
    parameters made from ``seed`` on ``device``.  Prints the reference's line
    every ``log_every`` steps and at the last.  With ``ckpt_dir``, saves
    ``{"params", "opt"}`` after every step whose loop index is a nonzero
    multiple of ``ckpt_every`` (metadata ``{"step", "loss"}``) and after the
    last as ``step_<steps>`` (``{"step"}``), as the reference's launcher.

    With ``pipeline``, this rank trains its stage of the cross-pod pipeline
    over ``mesh`` (``n_micro`` microbatches, ``boundary`` "striped" or
    "direct"): ``params``, where given, are this rank's (``stage_params``),
    else the whole model is made from ``seed`` and cut to them.  Only rank 0
    of the mesh prints.  A mesh of more than one rank without ``pipeline``,
    and ``ckpt_dir`` with it, raise ``NotImplementedError``.

    Returns {"params", "opt_state", "history": [{"step", "loss", "grad_norm",
    "lr", "started", "seconds"}, ...], "checkpoint"}, where ``seconds`` is each
    step's wall time from ``started`` (``time.perf_counter()``), ending in a
    synchronisation, and ``checkpoint`` is None or {"path": the latest,
    "saves": the checkpointer's ``timings``}; under ``pipeline`` each entry also
    holds ``bytes`` and ``transport_seconds``, this rank's transport counters
    after the step."""
    device = resolve_device(device)
    mesh = mesh or Mesh((1,), ("data",))
    if mesh.size > 1 and not pipeline:
        raise NotImplementedError(f"a mesh {mesh.shape} without --pipeline: data parallelism on the plain step is "
                                  "not ported yet (ROADMAP.md Queue 1, slice 7d)")
    if pipeline and ckpt_dir:
        raise NotImplementedError("checkpoints under --pipeline are not ported yet (ROADMAP.md Queue 1, slice 7c)")
    model = build_model(cfg)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = model.init(gen)
        if pipeline:
            params = stage_params(params, cfg, mesh)
    opt_cfg = optimizer_config(lr, steps)
    opt_state = init_opt_state(params)
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    loss_fn = make_pipeline_loss(cfg, mesh, n_micro=n_micro, boundary=boundary) if pipeline else model.loss
    step_fn = make_train_step(loss_fn, opt_cfg)
    data = make_batches(cfg, DataConfig(seed=seed, batch_size=batch, seq_len=seq), num_steps=steps)
    speak = mesh.rank == 0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    history: List[Dict] = []
    tokens_done = 0
    sync()
    t0 = time.perf_counter()
    for step, b in enumerate(data):
        t_step = time.perf_counter()
        b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        sync()
        now = time.perf_counter()
        tokens_done += batch * seq
        history.append({"step": step, "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"]), "started": t_step, "seconds": now - t_step})
        if pipeline:
            history[-1]["bytes"] = loss_fn.transport.counts()
            history[-1]["transport_seconds"] = loss_fn.transport.times()
        if speak and (step % log_every == 0 or step == steps - 1):
            h = history[-1]
            print(f"step {step:5d} loss {h['loss']:.4f} gnorm {h['grad_norm']:.3f} lr {h['lr']:.2e} "
                  f"tok/s {tokens_done / max(now - t0, 1e-9):,.0f}", flush=True)
        if ckpt and step and step % ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt_state}, {"step": step, "loss": history[-1]["loss"]})
    checkpoint = None
    if ckpt:
        ckpt.save(steps, {"params": params, "opt": opt_state}, {"step": steps})
        ckpt.close()
        checkpoint = {"path": ckpt.latest_path(), "saves": ckpt.timings}
        print(f"[train] checkpoint at {checkpoint['path']}", flush=True)
    return {"params": params, "opt_state": opt_state, "history": history, "checkpoint": checkpoint}


def _join_world(device_arg: Optional[str]) -> Optional[str]:
    """Under torchrun (``WORLD_SIZE`` > 1): join the ``gloo`` group and return
    this rank's device, ``cuda:(LOCAL_RANK % device_count)`` unless the CPU
    is asked for.  Otherwise the device as asked."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n == 1:
        return device_arg
    dist.init_process_group("gloo", rank=int(os.environ["RANK"]), world_size=n, timeout=TIMEOUT)
    if device_arg is None and torch.cuda.is_available():
        return f"cuda:{int(os.environ.get('LOCAL_RANK', '0')) % torch.cuda.device_count()}"
    return device_arg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--pipeline", action="store_true", help="PP over the pod axis, one rank a process (torchrun)")
    ap.add_argument("--n-micro", type=int, default=4)
    ap.add_argument("--boundary", default="striped", choices=["striped", "direct"])
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' must be asked for")
    args = ap.parse_args(argv)

    device = _join_world(args.device)
    try:
        device = resolve_device(device)
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        mesh = (make_production_mesh if args.production_mesh else make_host_mesh)(multi_pod=args.pipeline)
        where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        if mesh.rank == 0:
            print(f"[train] arch={cfg.name} device={where} mesh={mesh.shape} params={cfg.param_count() / 1e6:.1f}M",
                  flush=True)
        return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr, seed=args.seed,
                     log_every=args.log_every, device=device, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     mesh=mesh, pipeline=args.pipeline, n_micro=args.n_micro, boundary=args.boundary)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
