"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout, a configuration's file (``file`` in its entry), a traffic mix's
``chipbench/traffic/<traffic>.json`` and a cell's limits
``chipbench/limits/<workload>.json``.  Nothing here knows a cell."""
from __future__ import annotations

import dataclasses
import importlib.util
import functools
import json
import typing
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

DTYPES = ("bfloat16", "float32")  # the dtypes a configuration may name


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]  # the configuration's file
    traffic: Dict[str, Any]  # the mix's file
    limits: Dict[str, Any]  # the numbers `correct` compares, each with its limit
    end_to_end: List[Dict[str, Any]]  # the metrics this cell reports with --trace 0
    per_layer: List[Dict[str, Any]]  # ... and with --trace 1


def _load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def _reported_in(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    """A per-layer metric is read in the cells its ``workloads`` lists, or
    without that key in every cell that reports the metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits_file = BENCH / "limits" / f"{name}.json"
    limits = _load_json(limits_file) if limits_file.exists() else {}
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if _reported_in(m, name, e2e_names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, layer)


def shapes(config: Dict[str, Any]) -> Dict[str, Any]:
    """A configuration's sizes as the reference and the cost counts read
    them: the program's ``ModelConfig`` fields (``model``) and the sizes the
    program fixes in code (``fixed``)."""
    return dict(config["model"], **config.get("fixed", {}))


def _build(cls, kw: Dict[str, Any], where: str):
    """``cls(**kw)``, each nested group built as its field's dataclass, a
    dtype named by its text, a list given as a tuple."""
    import torch

    hints = typing.get_type_hints(cls)
    out = {}
    for key, value in kw.items():
        if key not in hints:
            raise SystemExit(f"{where}: {cls.__name__} has no field {key!r}")
        typ = hints[key]
        if typing.get_origin(typ) is typing.Union:
            typ = next(a for a in typing.get_args(typ) if a is not type(None))
        if value is None:
            out[key] = None
        elif dataclasses.is_dataclass(typ):
            out[key] = _build(typ, value, f"{where}.{key}")
        elif typ is torch.dtype:
            if value not in DTYPES:
                raise SystemExit(f"{where}: {key} {value!r} is not one of {DTYPES}")
            out[key] = getattr(torch, value)
        elif typing.get_origin(typ) is tuple:
            out[key] = tuple(value)
        else:
            out[key] = value
    return cls(**out)


def model_config(config: Dict[str, Any]):
    """The program's ``ModelConfig`` of a configuration file's ``model`` group."""
    from repro_torch.models.modules import ModelConfig

    return _build(ModelConfig, config["model"], config["name"])


@functools.lru_cache(maxsize=None)
def load_module(kind: str, name: str) -> ModuleType:
    """``chipbench/<kind>/<name>.py`` loaded by its path (a name may hold
    dots), once a process."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"chipbench.{kind}.{name.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise SystemExit(f"no {kind} file for {name!r}: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metric(name: str, run: Dict[str, Any]) -> Optional[float]:
    """What ``chipbench/metrics/<name>.py`` reads from a run; None where it
    finds nothing to read."""
    return load_module("metrics", name).read(run)
