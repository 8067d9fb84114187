"""Small cells on the CPU for the benchmark's own tests: the drivers, the
references and the check run as on the card, at sizes a test can hold."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from chipbench import run as bench_run  # noqa: E402
from chipbench.spec import Cell, load_cell, model_config  # noqa: E402

DENSE = {"num_layers": 2, "d_model": 64, "num_heads": 2, "num_kv_heads": 2, "head_dim": 32, "d_ff": 128,
         "vocab_size": 256}
RWKV = {"num_layers": 2, "d_model": 128, "num_heads": 2, "num_kv_heads": 2, "d_ff": 256, "vocab_size": 256,
        "rwkv": {"head_dim": 64, "chunk": 16}}
TRAIN = {"micro_batch": 2, "accum_steps": 2, "seq_len": 32}
PREFILL = {"ring": 64, "lengths": {"median": 20, "sigma": 0.6, "min": 4, "max": 48, "cycle": 16}}


def small_cell(name: str, dtype: str = "float32", remat: str = "none", limits=None) -> Cell:
    """The committed cell ``name`` with its model and traffic cut to a test's size."""
    cell = copy.deepcopy(load_cell(name, ROOT))
    m = cell.config["model"]
    m.update(RWKV if m.get("rwkv") else DENSE)
    m.update(dtype=dtype, remat=remat)
    cell.traffic.update(TRAIN if cell.traffic["kind"] == "train" else PREFILL)
    if limits is not None:
        cell.limits = limits
    return cell


def drive(cell: Cell, seed: int = 3, seconds: float = None, trace: bool = False, fault=None) -> dict:
    """A run of ``cell`` on the CPU past the harness's look for a card: the
    result line as ``run.main`` prints it, with the driver's record under
    ``_run``."""
    if seconds is None:
        seconds = 0.3
    ctx = bench_run.Context(cell, model_config(cell.config), torch.device("cpu"), seed, seconds, trace, fault)
    return bench_run.measure(ctx, torch)
