"""The readings a cell's limits are set from, on the card and at the cell's
own size, in one process: for each seed the program's compared numbers (the
lower reading), for ``--control-seeds`` the control's (the reference in
float8 in the program's place: the upper reading), and for ``--fault-seeds``
each fault of ``--faults`` planted in the program.  One JSON line a reading
goes to ``--out`` as it is taken.

    python3 chipbench/tools/readings.py --workload gpta-stage-train --seeds 11,12,13 \\
        --control-seeds 11,12,13 --fault-seeds 11 --faults half_batch --seconds 1 --out chiprun_out/r.json
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
for p in (ROOT / "src", ROOT):
    sys.path.insert(0, str(p))


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    from chipbench import run as bench_run

    bench_run._environment()
    import torch

    from chipbench import compare
    from chipbench.reference.common import Precision
    from chipbench.spec import load_cell, load_module, model_config, shapes

    cell = load_cell(args.workload, ROOT)
    kind = cell.traffic["kind"]
    driver = load_module("drivers", kind)
    ref = load_module("reference", cell.config["reference"])
    m, mix, dev = shapes(cell.config), cell.traffic, torch.device("cuda", 0)
    controls, fault_seeds = set(_seeds(args.control_seeds)), set(_seeds(args.fault_seeds))
    faults = [f for f in args.faults.split(",") if f]
    out = open(args.out, "a")

    def worst(got):  # a train run's five worst leaves by gradient gap, for the look behind a limit
        gaps = compare.leaf_gaps(got["grad_leaf"], want["grad_leaf"])
        return {"worst_leaves": dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:5])}

    def emit(seed, what, numbers, extra=None):
        line = {"workload": args.workload, "seed": seed, "what": what,
                "numbers": {k: v for k, v, _ in numbers}, **(extra or {})}
        out.write(json.dumps(line) + "\n")
        out.flush()
        print(json.dumps(line), flush=True)

    def program(seed, fault=None):
        torch.cuda.reset_peak_memory_stats()
        ctx = bench_run.Context(cell, model_config(cell.config), dev, seed, args.seconds, False, fault)
        return driver.program(ctx)

    for seed in sorted(set(_seeds(args.seeds)) | controls | fault_seeds):
        t0 = time.perf_counter()
        rec = program(seed)
        extra = {"memory_peak_bytes": rec["memory_peak_bytes"]}
        if kind == "train":
            want = driver.follow(ref, m, mix, ref.layout(m), seed, dev, Precision("f32"), driver.CHECKED_STEPS)
            number = lambda got: compare.train_numbers(got, want, {})  # noqa: E731
            floor = compare.IGNORED_GRAD * statistics.median(want["grad_leaf"].values())
            extra["leaves_left_out"] = sorted(k for k, g in want["grad_leaf"].items() if g < floor)
            extra.update(worst(rec["got"]))
        else:
            number = lambda got: compare.serve_numbers(*driver.check(ref, m, seed, dev, got, Precision("f32")), {})  # noqa: E731
        emit(seed, "program", number(rec["got"]), dict(extra, seconds=time.perf_counter() - t0))
        if seed in controls:
            if kind == "train":
                low = driver.follow(ref, m, mix, ref.layout(m), seed, dev, Precision("fp8"), driver.CHECKED_STEPS)
                emit(seed, "control", number(low), worst(low))
            else:
                emit(seed, "control", compare.serve_numbers(*driver.control(ref, m, seed, dev, rec["got"]), {}))
        if seed in fault_seeds:
            for fault in faults:
                emit(seed, f"fault:{fault}", number(program(seed, fault)["got"]))
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
