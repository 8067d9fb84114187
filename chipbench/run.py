"""Runs one cell of the benchmark of ``repro_torch`` on the card it starts on.

    python3 chipbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One process: it names the card and stops if
there is none (or fewer than the cell asks for), makes its weights and inputs
on the card from ``--seed``, warms the cell's own shapes (``setup_s``),
measures for ``--seconds``, checks what the timed path produced against the
plain float32 reference in ``chipbench/reference/``, and prints as its last
line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit
(also the last lines of standard error).

Everything is found by name, so a later change adds files and entries and
edits none:

* a cell: an entry of ``workloads`` in ``BENCHMARK.json`` naming a
  configuration and a traffic mix, and ``chipbench/limits/<cell>.json``, the
  limits of the numbers its check compares (``chipbench/compare.py``);
* a configuration: an entry of ``configs`` and its JSON file under
  ``chipbench/configs/``: the program's ``ModelConfig`` fields under
  ``model`` (each nested group built as its field's dataclass), the sizes
  the program fixes in code under ``fixed``, the plain reference's module
  under ``reference``;
* a model family: ``chipbench/reference/<name>.py``, the plain reference:
  the weights' ``layout``, ``loss`` for training, ``prefill`` and
  ``F32_LEAVES`` for serving, and ``layer_flops``, a layer's operations,
  which ``chipbench/costs/model_flops.py`` reads for MFU;
* a traffic mix: ``chipbench/traffic/<name>.json``, parameters only, whose
  ``kind`` names the driver (``chipbench/drivers/<kind>.py``) and is read by
  the one generator (``chipbench/generator.py``);
* a metric: an entry of ``end_to_end`` or ``per_layer`` and
  ``chipbench/metrics/<name>.py``, whose ``read(r)`` takes the run's record
  and returns a number or None (nothing to read: the metric is left out);
  a kernel's roofline takes its work from ``chipbench/costs/<kernel>.py``.

Caches stay inside the checkout at fixed paths: the kernels build into
``build/`` (``repro_torch.kernels.build``), and Triton's and PyTorch's
extension caches go under ``build/chipbench/``."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# run as a script, this folder heads sys.path, where ``trace.py`` would hide the standard library's module
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names the process may not hold


class Context:
    """What a driver gets: the cell, the program's config, the device, the
    run's arguments, and a fault to plant (None outside the checks' tests)."""

    def __init__(self, cell, model_cfg, device, seed, seconds, trace, fault=None):
        self.cell, self.model_cfg, self.device = cell, model_cfg, device
        self.seed, self.seconds, self.trace, self.fault = seed, seconds, trace, fault
        self.t_start = T_START


def _environment() -> None:
    cache = ROOT / "build" / "chipbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"  # keeps a library that could load JAX from doing so
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def held_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":  # the benchmark's own tests, on the CPU
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def metrics_of(cell, run: dict, trace: bool) -> dict:
    from chipbench.spec import read_metric

    r = {"run": run, "config": cell.config, "traffic": cell.traffic, "cell": cell.name}
    out = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = read_metric(m["name"], r)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(ctx, torch) -> dict:
    """The driver's run of the cell, its metrics and check, as the result line."""
    from chipbench import compare
    from chipbench.spec import load_module

    run = load_module("drivers", ctx.cell.traffic["kind"]).run(ctx)
    result = {"correct": compare.correct(run["numbers"], run["failed"]), "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics_of(ctx.cell, run, ctx.trace),
              "device": device_info(torch, ctx.device, ctx.cell.chips)}
    if ctx.trace:
        t = run["trace"]
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
    result["checks"] = compare.as_dict(run["numbers"])
    result["_run"] = run
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chipbench: no program at {ROOT / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    _environment()
    import torch

    from chipbench.spec import load_cell, model_config

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chipbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}", file=sys.stderr)
        return 3
    ctx = Context(cell, model_config(cell.config), torch.device("cuda", 0), args.seed, args.seconds, bool(args.trace))
    result = measure(ctx, torch)
    run = result.pop("_run")
    print("run " + " ".join(f"{k}={run[k]!r}" for k in ("setup_s", "window_s", "reference_s", "attempted")),
          file=sys.stderr)
    held = held_forbidden()
    if held:
        print(f"chipbench: the process holds {held} after the window", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
