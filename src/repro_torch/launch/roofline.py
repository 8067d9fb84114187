"""Roofline table (deliverable g): reads the dry-run's JSON files and emits
per-(arch x shape x mesh) compute/memory/collective terms, the dominant
bottleneck, and the MODEL_FLOPS/counted-FLOPS usefulness ratio; the port's
counterpart of ``benchmarks/roofline.py``, over a directory it is given.
``dominant_term`` and the tables are the reference's; ``binding_term`` is the
port's own, from the FLOPs counted over its program.

The seconds are those ``repro_torch.launch.dryrun`` wrote: one H100 SXM at its
published 700 W peaks, 989 TFLOP/s bf16 and 3.35 TB/s HBM, a collective at
NVLink's 450 GB/s each way inside a node of 8 and at a 400 Gb/s NIC's 50 GB/s
beyond it.  They are computed on ``meta``, not measured.  The functions read
the reference's files as well (the same keys).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

DRYRUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "local", "torch_dryrun")


def load_results(dryrun_dir: str = DRYRUN_DIR) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    return out


def dominant_term(r: Dict) -> Tuple[str, float]:
    rf = r["roofline"]
    terms = {
        "compute": rf.get("compute_s") or 0.0,
        "memory": rf.get("memory_s") or 0.0,
        "collective": rf.get("collective_s") or 0.0,
    }
    k = max(terms, key=terms.get)
    return k, terms[k]


def binding_term(r: Dict) -> Tuple[str, float]:
    """The term that binds the port's program: the FLOPs counted over it
    (``compute_s_hlo``) against its memory and collective terms.
    ``dominant_term``, the reference's, weighs the analytic MODEL_FLOPS spread
    evenly over every chip (``compute_s``), which a rank of the port, running
    whole replicas and whole rows, does not do; the reference's tables
    (``roofline_rows``, ``markdown_table``) keep it."""
    rf = r["roofline"]
    terms = {
        "compute": rf.get("compute_s_hlo") or 0.0,
        "memory": rf.get("memory_s") or 0.0,
        "collective": rf.get("collective_s") or 0.0,
    }
    k = max(terms, key=terms.get)
    return k, terms[k]


def roofline_rows(mesh: Optional[str] = "single", boundary: str = "striped", dryrun_dir: str = DRYRUN_DIR):
    rows = []
    for r in load_results(dryrun_dir):
        if r.get("status") != "ok":
            continue
        if mesh and r["mesh"] != mesh:
            continue
        if r.get("boundary", "striped") != boundary:
            continue
        rf = r["roofline"]
        dom, val = dominant_term(r)
        name = f"roofline/{r['arch']}_{r['shape']}_{r['mesh']}"
        rows.append((f"{name}/compute_s", _r(rf["compute_s"]), ""))
        rows.append((f"{name}/memory_s", _r(rf["memory_s"]), ""))
        rows.append((f"{name}/collective_s", _r(rf["collective_s"]),
                     f"dcn={rf['dcn_bytes']/1e6:.1f}MB"))
        rows.append((f"{name}/dominant", 0.0, f"{dom}={val:.4g}s"))
        rows.append((f"{name}/useful_flops_ratio", _r(rf["useful_flops_ratio"]), ""))
    return rows


def _r(x, nd=5):
    return round(x, nd) if isinstance(x, (int, float)) and x == x else float("nan")


def markdown_table(mesh: str = "single", boundary: str = "striped", dryrun_dir: str = DRYRUN_DIR) -> str:
    """The §Roofline table's body."""
    lines = [
        "| arch | shape | compute s | memory s | collective s | DCN MB | dominant | useful ratio |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in load_results(dryrun_dir):
        if r.get("status") != "ok" or r["mesh"] != mesh:
            continue
        if r.get("boundary", "striped") != boundary:
            continue
        rf = r["roofline"]
        dom, _ = dominant_term(r)
        ur = rf.get("useful_flops_ratio")
        # as the reference writes it: the conditional takes the whole line, so a
        # row without a ratio is left out
        lines.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']:.4g} | "
            f"{rf['memory_s']:.4g} | {rf['collective_s']:.4g} | "
            f"{rf['dcn_bytes']/1e6:.1f} | **{dom}** | "
            f"{ur:.3g} |" if ur is not None else ""
        )
    return "\n".join(line for line in lines if line)
