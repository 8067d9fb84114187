#!/usr/bin/env python3
"""Where the time of chip_smoke.py's distributed phases goes, on the card.

    python3 experiments/torch_spawn_timeline.py [--root DIR] [--out FILE] [--kernels]

Needs one NVIDIA Hopper card and ``nvcc``.  Builds the kernels of the
``chip_smoke.py`` in DIR (default: this checkout; an unpacked ``git archive``
of another commit works the same), makes its dry-run predictions in a
process of its own beside the build, and runs that script's distributed
phases in its own order (``DISTRIBUTED_PHASES`` where the script names them,
else the six phases that each spawn their ranks), nothing else (with
``--kernels``, its kernel checks first).  Every rank
those phases spawn is timed in four parts:

- ``start_s``: from the parent's spawn to the rank's function entered (a new
  interpreter, its imports);
- ``join_s``: ``join_as_rank`` (the card's context, the ``gloo`` group);
- ``pin_s``, ``first_launch_s``, ``cublas_s``: the process's first pinned
  host buffer, its first kernel launch and its first matrix product (cuBLAS's
  handle and workspace), each timed alone here, before the rank's own work;
- ``work_s``: from then to ``destroy_process_group``, the rank's runs;

and ``teardown_s``, from there to the parent seeing the process gone.  The
phases' own lines are printed as the script prints them; one JSON line a
phase follows with its wall seconds and its spawns' parts, then the card's
name and power limit, then the whole as JSON (also written to FILE).
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT_ENV, DIR_ENV = "SPAWN_TIMELINE_ROOT", "SPAWN_TIMELINE_DIR"
# the phases that spawn ranks, in the order chip_smoke.py's main runs them,
# for a script that does not name them itself
SPAWNING_PHASES = ("phase_train_pipeline", "phase_train_pipeline_hybrid", "phase_train_dp", "phase_train_tp",
                   "phase_train_tp_moe", "phase_train_tp_recurrent")


def _timed_join(join):
    def timed(rank, world, store):
        rec = {"pid": os.getpid(), "rank": rank, "world": world, "entered": time.time()}
        joined = join(rank, world, store)
        rec["joined"] = time.time()
        for part, fn in (("pin_s", lambda: torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True)),
                         ("first_launch_s", lambda: torch.ones(1, device="cuda").add_(1)),
                         ("cublas_s", lambda: torch.ones(256, 256, device="cuda") @ torch.ones(256, 256, device="cuda"))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            rec[part] = time.perf_counter() - t0
        rec["ready"] = time.time()
        _write(rec)
        return joined
    return timed


def _timed_destroy(destroy):
    def timed(*args, **kwargs):
        path = os.path.join(os.environ[DIR_ENV], f"rank.{os.getpid()}.json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            rec["left"] = time.time()
            _write(rec)
        return destroy(*args, **kwargs)
    return timed


def _write(rec: dict) -> None:
    path = os.path.join(os.environ[DIR_ENV], f"rank.{rec['pid']}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(path + ".tmp", path)


def _instrument():
    """Imports the timed tree's ``chip_smoke`` and wraps its ``join_as_rank``
    and ``torch.distributed.destroy_process_group``: in this process, and in
    every spawned rank, which imports this file again as its main module."""
    sys.path.insert(0, os.environ[ROOT_ENV])
    import chip_smoke
    import torch.distributed as dist

    if not getattr(chip_smoke.join_as_rank, "_timed", False):
        chip_smoke.join_as_rank = _timed_join(chip_smoke.join_as_rank)
        chip_smoke.join_as_rank._timed = True
        dist.destroy_process_group = _timed_destroy(dist.destroy_process_group)
    return chip_smoke


if os.environ.get(ROOT_ENV) and os.environ.get(DIR_ENV) and __name__ != "__main__":
    _instrument()  # a spawned rank: its function reads the wrapped join_as_rank


def _spawn_parts(spawns: list, tdir: str) -> list:
    recs = []
    for name in os.listdir(tdir):
        if name.startswith("rank.") and name.endswith(".json"):
            with open(os.path.join(tdir, name)) as f:
                recs.append(json.load(f))
    out = []
    for s in spawns:
        mine = sorted((r for r in recs if s["spawned"] <= r["entered"] <= s["ended"]), key=lambda r: r["rank"])
        ranks = [{"rank": r["rank"], "start_s": r["entered"] - s["spawned"], "join_s": r["joined"] - r["entered"],
                  "pin_s": r["pin_s"], "first_launch_s": r["first_launch_s"], "cublas_s": r["cublas_s"],
                  "work_s": r.get("left", s["ended"]) - r["ready"], "teardown_s": s["ended"] - r.get("left", s["ended"])}
                 for r in mine]
        out.append({"fn": s["fn"], "world": s["world"], "wall_s": s["ended"] - s["spawned"], "ranks": ranks})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE), help="the checkout whose chip_smoke.py is timed")
    ap.add_argument("--out", default=None, help="write the whole result as JSON here")
    ap.add_argument("--kernels", action="store_true", help="run the script's kernel checks first")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_spawn_timeline: no CUDA device; it times the card's phases and has no CPU mode", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    tdir = os.path.join(root, "local", "spawn_timeline")
    os.makedirs(tdir, exist_ok=True)
    for name in os.listdir(tdir):
        os.remove(os.path.join(tdir, name))
    os.environ[ROOT_ENV], os.environ[DIR_ENV] = root, tdir
    cs = _instrument()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = cs.phase_env()
    pred_path = os.path.join(tdir, "predictions.json")
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src"), "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    env.pop(ROOT_ENV)
    pred = subprocess.Popen([sys.executable, "-c", f"import chip_smoke; chip_smoke.write_predictions({pred_path!r})"],
                            cwd=root, env=env)
    cs.phase_build()
    if pred.wait(timeout=900) != 0:
        raise AssertionError(f"the predictions: exit {pred.returncode}")
    with open(pred_path) as f:
        cs._PREDICTED.update(json.load(f))
    if args.kernels:
        cs.phase_kernels()
        cs.release()
    spawns = []
    spawn_ranks = cs.spawn_ranks

    def timed_spawn(fn, world, *a, **kw):
        s = {"fn": fn.__name__, "world": world, "spawned": time.time()}
        try:
            return spawn_ranks(fn, world, *a, **kw)
        finally:
            s["ended"] = time.time()
            spawns.append(s)

    cs.spawn_ranks = timed_spawn
    phases = []
    for name in getattr(cs, "DISTRIBUTED_PHASES", SPAWNING_PHASES):
        fn = getattr(cs, name)
        before = len(spawns)
        t0 = time.perf_counter()
        fn(None) if inspect.signature(fn).parameters else fn()
        wall = time.perf_counter() - t0
        cs.release()
        line = {"phase": name, "wall_s": wall, "spawns": _spawn_parts(spawns[before:], tdir)}
        phases.append(line)
        print(json.dumps(line), flush=True)
    out = {"root": root, "phases": phases, "seconds": time.perf_counter() - t_start,
           "distributed_s": sum(p["wall_s"] for p in phases)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(smi, flush=True)
    print(json.dumps({k: v for k, v in out.items() if k != "phases"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
