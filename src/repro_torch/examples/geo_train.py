"""Geo-distributed training, end to end:

1. Algorithm 1 picks the DC split for a 2-DC fleet (what-if, no hardware).
2. The discrete-event simulator compares Atlas vs Varuna/GPipe on it.
3. The REAL cross-pod pipeline (``repro_torch.parallel.pipeline``: sends and
   receives over the ``pod`` axis, striped Atlas boundary) trains a reduced
   model on the mesh (pod, data, model) = (2, 2, 2): eight ``gloo`` ranks
   that this script spawns, which share the one card (``cuda:(rank %
   device_count)``; the RMSNorm and flash attention kernels and their backward
   kernels), or run on the CPU when asked.

  PYTHONPATH=src python -m repro_torch.examples.geo_train [--device cpu]

The times of parts 1 and 2 are the simulator's model of the paper's A100
testbed, not this card's.
"""
import argparse
import json
import math
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.convert import tree_map
from repro_torch.core import topology, wan
from repro_torch.core.dc_selection import JobModel, algorithm1, best_plan
from repro_torch.core.simulator import GeoTopology, simulate, testbed_spec
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention, rmsnorm
from repro_torch.launch.mesh import TIMEOUT, make_mesh
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state, make_train_step
from repro_torch.parallel.pipeline import make_pipeline_loss, stage_params

MESH = ((2, 2, 2), ("pod", "data", "model"))
DEADLINE_S = 900  # the spawned ranks' whole run; a rank that waits on another fails after TIMEOUT


def _pipeline_rank(rank: int, world: int, store: str, cfg, steps: int, device, params) -> None:
    """One rank of part 3: joins the mesh, takes its stage of ``params`` (or
    of parameters made from seed 0 on its device), trains ``steps`` steps of
    the pipelined step, rank 0 printing, and writes its losses and its
    kernels' launch counts beside ``store``."""
    torch.set_num_threads(1)  # eight ranks on the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        if device is None:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = resolve_device(device)
        mesh = make_mesh(*MESH)
        model = build_model(cfg)
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            params = model.init(gen)
        else:  # the caller's tensors, which every rank shares: copied before they are updated in place
            params = tree_map(lambda t: t.to(dev, copy=True), params)
        params = stage_params(params, cfg, mesh)
        loss_fn = make_pipeline_loss(cfg, mesh, n_micro=4, boundary="striped")
        step_fn = make_train_step(loss_fn, OptimizerConfig(peak_lr=3e-3, warmup_steps=5, total_steps=steps))
        opt_state = init_opt_state(params)
        losses = []
        for i, b in enumerate(make_batches(cfg, DataConfig(batch_size=8, seq_len=64), num_steps=steps)):
            params, opt_state, m = step_fn(params, opt_state, {k: torch.from_numpy(v).to(dev) for k, v in b.items()})
            losses.append(float(m["loss"]))
            if rank == 0 and (i % 10 == 0 or i == steps - 1):
                print(f"[pipeline] step {i:3d} loss {losses[-1]:.4f}", flush=True)
        launches = {"rmsnorm": rmsnorm.launches, "rmsnorm_bwd": rmsnorm.bwd_launches,
                    "flash_attention": flash_attention.launches, "flash_attention_bwd": flash_attention.bwd_launches}
        with open(f"{store}.rank{rank}.json", "w") as f:
            json.dump({"rank": rank, "coords": mesh.coords, "losses": losses, "launches": launches,
                       "bytes": loss_fn.transport.counts()}, f)
    finally:
        dist.destroy_process_group()


def _spawn(world: int, *args) -> list:
    """``_pipeline_rank`` on ``world`` processes (the spawn start method);
    raises if a rank raises, dies or outlives DEADLINE_S (every rank is
    stopped), else returns each rank's results."""
    tmp = tempfile.mkdtemp(prefix="geo_train_")
    store = os.path.join(tmp, "store")
    ctx = torch.multiprocessing.start_processes(_pipeline_rank, args=(world, store, *args), nprocs=world,
                                                join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE_S
    try:
        while not ctx.join(timeout=max(0.05, end - time.monotonic())):
            if time.monotonic() >= end:
                raise TimeoutError(f"{world} pipeline ranks outlived {DEADLINE_S} s")
        out = []
        for r in range(world):
            with open(f"{store}.rank{r}.json") as f:
                out.append(json.load(f))
        return out
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
        shutil.rmtree(tmp, ignore_errors=True)


def main(steps: int = 30, device=None, params=None):
    """Parts 1-3; part 3 trains ``params`` (the smoke GPT-A's whole model,
    converted; each rank copies its stage) or parameters made from seed 0 on
    each rank's device.  Returns the ranks' losses, kernel launch counts and
    transport byte counters."""
    resolve_device(device)
    # ---- 1) plan ----
    job = JobModel(
        t_fwd_ms=10.0,
        act_bytes=wan.activation_bytes(1, 4096, 4096),
        partition_param_bytes=412e6 * 2,
        microbatches=16,
    )
    plans = algorithm1(job, {"us-east": 240, "us-west": 240}, P=8)
    plan = best_plan(plans)
    print(f"[plan] best D={plan.D} partitions={plan.partitions} "
          f"throughput={plan.throughput:.4f} gpus={plan.gpus_used}")

    # ---- 2) simulate ----
    stage_dc = []
    for i, dc in enumerate(sorted(plan.partitions)):
        stage_dc += [i] * plan.partitions[dc]
    spec = testbed_spec(
        hidden=4096, seq_len=4096, micro_batch=1, layers_per_stage=1,
        layer_params=412e6, num_stages=len(stage_dc), microbatches=16,
        stage_dc=stage_dc,
    )
    for policy, mt, D in (("gpipe", False, 1), ("varuna", False, 1), ("atlas", True, 2)):
        r = simulate(spec, GeoTopology(wan_latency_ms=40, multi_tcp=mt),
                     policy=policy, n_pipelines=D, validate=True)
        print(f"[sim] {policy:7s} multi_tcp={mt}  iter={r.iteration_ms:8.0f}ms "
              f"util={r.utilization:.0%}")

    # ---- 2b) same job on a heterogeneous (skewed) WAN ----
    for name, topo in (("uniform", GeoTopology(wan_latency_ms=40)),
                       ("skewed", topology.skewed_3dc()),
                       ("azure", topology.azure_testbed())):
        r = simulate(spec, topo, policy="atlas", n_pipelines=2, validate=True)
        print(f"[sim] atlas on {name:8s} iter={r.iteration_ms:8.0f}ms "
              f"util={r.utilization:.0%}")

    # ---- 3) real cross-pod pipeline on eight ranks ----
    cfg = get_smoke_config("gpt_a")
    world = math.prod(MESH[0])
    print(f"[pipeline] mesh={dict(zip(MESH[1], MESH[0]))} arch={cfg.name} boundary=striped")
    ranks = _spawn(world, cfg, steps, device, params)
    print("[pipeline] done — PP across pods, DP+TP inside (paper §4.2 layout)")
    return {"ranks": ranks}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' must be asked for")
    main(device=ap.parse_args().device)
