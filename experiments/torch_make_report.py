#!/usr/bin/env python3
"""Render the port's §Dry-run and §Roofline tables from the dry-run's JSON
files (``repro_torch.launch.dryrun``, one file a combination).

    PYTHONPATH=src python -m repro_torch.launch.dryrun          # writes local/torch_dryrun/
    python3 experiments/torch_make_report.py [--dir local/torch_dryrun] > tables.md

Every number is computed on ``meta`` for one rank of the production meshes,
not measured: bytes and FLOPs counted over the port's own program, seconds at
one H100 SXM's published peaks at 700 W (989 TFLOP/s bf16, 3.35 TB/s HBM;
NVLink 450 GB/s inside a node of 8, a 400 Gb/s NIC's 50 GB/s beyond it).
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.launch.dryrun import DEVICE_BYTES  # noqa: E402
from repro_torch.launch.shapes import SHAPES  # noqa: E402
from repro_torch.launch.roofline import DRYRUN_DIR, binding_term, load_results  # noqa: E402


def gb(x):
    return f"{x/1e9:.2f}" if isinstance(x, (int, float)) else "-"


def report(rs) -> str:
    ok = [r for r in rs if r["status"] == "ok"]
    sk = [r for r in rs if r["status"] == "skipped"]
    err = [r for r in rs if r["status"] == "error"]
    out = [f"<!-- generated by experiments/torch_make_report.py: ok={len(ok)} skipped={len(sk)} errors={len(err)} -->",
           "",
           "### Dry-run (one rank's program on meta, per combination; computed, not measured)",
           "",
           "| arch | shape | mesh | program | host s | peak GB/dev | args GB/dev | plan GB/dev | fits 80 GB | "
           "DCN MB | collectives |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(ok, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        mem, coll = r["memory"], r["collectives"]
        ops = " ".join(f"{k}:{v/1e6:.0f}MB" for k, v in sorted(coll["by_op"].items()))
        fits = "yes" if mem["peak_bytes"] <= DEVICE_BYTES else "**no**"
        program = r.get("program", "-") + ("+tensor_parallel" if r.get("tensor_parallel") else "")
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {program} | {r['host_s']} | "
                   f"{gb(mem['peak_bytes'])} | {gb(mem['argument_bytes'])} | {gb(r.get('plan_bytes_per_device'))} | "
                   f"{fits} | {coll['dcn']/1e6:.1f} | {ops or '-'} |")
    for r in sk:
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | skipped | - | - | - | - | - | - | {r['reason']} |")
    for r in err:
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | **error** | - | - | - | - | - | - | {r['error']} |")
    out += ["",
            "### Roofline terms (per device; one H100 SXM at 700 W: 989 TF/s bf16, 3.35 TB/s HBM, "
            "NVLink 450 GB/s in a node of 8, NIC 50 GB/s beyond; computed, not measured; the binding term "
            "weighs the counted FLOPs, the model's are for comparison)",
            "",
            "| arch | shape | mesh | model compute s | counted compute s | memory s | collective s | DCN MB | "
            "binding | model TF/dev |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(ok, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        rf = r["roofline"]
        dom, _ = binding_term(r)
        out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {rf['compute_s']:.4g} | {rf['compute_s_hlo']:.4g} | "
                   f"{rf['memory_s']:.4g} | {rf['collective_s']:.4g} | {rf['dcn_bytes']/1e6:.1f} | **{dom}** | "
                   f"{rf['model_flops_per_device']/1e12:.2f} |")
    out += ["", matrix(rs)]
    return "\n".join(out) + "\n"


def matrix(rs) -> str:
    """Every combination in one table, an arch a row: the peak GB a device (✗
    where it passes the H100's 80 GB) and the binding roofline term with its
    seconds, or why it is skipped."""
    cols = [(shape, mesh) for shape in SHAPES for mesh in ("single", "multi")]
    by = {(r["arch"], r["shape"], r["mesh"]): r for r in rs}
    lines = ["### Every combination (peak GB a device, ✗ over 80 GB; the binding term and its seconds; "
             "computed on meta, not measured)", "",
             "| arch | " + " | ".join(f"{s} {m}" for s, m in cols) + " |", "|---" * (len(cols) + 1) + "|"]
    for arch in sorted({r["arch"] for r in rs}):
        cells = []
        for shape, mesh in cols:
            r = by.get((arch, shape, mesh))
            if r is None:
                cells.append("-")
            elif r["status"] == "skipped":
                cells.append("skip: encoder")  # the only skips: an encoder does not decode
            elif r["status"] == "error":
                cells.append("**error**")
            else:
                dom, val = binding_term(r)
                peak = r["memory"]["peak_bytes"]
                cells.append(f"{peak/1e9:.1f}{' ✗' if peak > DEVICE_BYTES else ''}, {dom[:3]} {val:.3g}")
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DRYRUN_DIR, help="the dry-run's JSON files")
    args = ap.parse_args(argv)
    rs = load_results(args.dir)
    if not rs:
        print(f"no dry-run results under {os.path.abspath(args.dir)}", file=sys.stderr)
        return 1
    sys.stdout.write(report(rs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
