"""Shared helpers of the simulator's parity tests (``test_torch_sim_*.py``,
``test_torch_obs.py``): the reference's simulator and the port's copy side by
side, and ``plain`` to compare what they return, floats bit for bit.

Every input is built twice, once from each package, from the same plain
numbers: a test writes ``build(m)`` against a namespace ``m`` of one package's
modules and ``same(build)`` runs it on both.  The copy's classes are not the
reference's, so feeding one package's object to the other proves nothing.
"""
from __future__ import annotations

import dataclasses
import enum
import importlib
import math
import pathlib
import types
from collections import deque

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: module path under the package -> attribute of the namespace
MODULES = {
    "units": "units",
    "obs": "obs",
    "obs.tracer": "tracer",
    "obs.schema": "schema",
    "obs.metrics": "metrics",
    "obs.crosscheck": "crosscheck",
    "obs.export": "export",
    "obs.emit": "emit",
    "obs.__main__": "cli",
    "core": "core",
    "core.wan": "wan",
    "core.topology": "topology",
    "core.simulator": "simulator",
    "core.temporal": "temporal",
    "core.fastforward": "fastforward",
    "core.validate": "validate",
    "core.dc_selection": "dc_selection",
    "core.bubbletea": "bubbletea",
    "core.failures": "failures",
    "core.control": "control",
    "core.fleet": "fleet",
    "core.reference": "reference",
}


def module_file(root: str, name: str) -> pathlib.Path:
    """Where ``root.name`` must live: ``src/<root>/<name as a path>``."""
    rel = pathlib.Path(*name.split("."))
    pkg = ROOT / "src" / root / rel
    return pkg / "__init__.py" if pkg.is_dir() else pkg.with_suffix(".py")


def _load(root: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(root=root)
    for name, attr in MODULES.items():
        mod = importlib.import_module(f"{root}.{name}")
        assert pathlib.Path(mod.__file__).resolve() == module_file(root, name).resolve(), (root, name, mod.__file__)
        setattr(ns, attr, mod)
    return ns


REF = _load("repro")
PORT = _load("repro_torch")


def world(m, n=3, names=("a", "b", "c")):
    """``n`` DCs 20 ms apart on multi-TCP links, named ``names``."""
    lat = [[0.0 if i == j else 20.0 for j in range(n)] for i in range(n)]
    return m.topology.TopologyMatrix.from_latency(lat, multi_tcp=True, dc_names=names)


def job(m, **kw):
    """The reference tests' small job: 10 ms forwards, 24 microbatches."""
    kw.setdefault("t_fwd_ms", 10.0)
    kw.setdefault("act_bytes", 1e7)
    kw.setdefault("partition_param_bytes", 2e8)
    kw.setdefault("microbatches", 24)
    return m.dc_selection.JobModel(**kw)


def plain(x, root=None):
    """``x`` as plain Python: dataclasses and other objects become dicts of
    their attributes under ``__class__`` (their name), tuples stay tuples
    (dict keys included), lists and deques become lists, sets frozensets.
    A float is itself, except NaN (``"nan"``) and -0.0 (``"-0.0"``), so that
    ``==`` on the results is equality bit for bit.  With ``root``, every
    object of either package must come from ``root``'s modules."""
    if isinstance(x, bool) or x is None or isinstance(x, (int, str, bytes)):
        return x
    if isinstance(x, float):
        if math.isnan(x):
            return "nan"
        if x == 0.0 and math.copysign(1.0, x) < 0:
            return "-0.0"
        return x
    if isinstance(x, tuple):
        return tuple(plain(v, root) for v in x)
    if isinstance(x, (list, deque)):
        return [plain(v, root) for v in x]
    if isinstance(x, (set, frozenset)):
        return frozenset(plain(v, root) for v in x)
    if isinstance(x, dict):
        return {plain(k, root): plain(v, root) for k, v in x.items()}
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, (types.FunctionType, types.MethodType, types.BuiltinFunctionType)):
        return ("function", x.__qualname__)
    cls = type(x)
    top = cls.__module__.split(".")[0]
    if root is not None and top in ("repro", "repro_torch"):
        assert top == root, f"{cls.__module__}.{cls.__qualname__} where {root}'s was due"
    if hasattr(x, "__dict__"):
        attrs = vars(x)
    elif dataclasses.is_dataclass(x):
        attrs = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    else:
        raise TypeError(f"plain: cannot flatten {cls.__module__}.{cls.__qualname__}")
    out = {"__class__": cls.__qualname__}
    out.update({k: plain(v, root) for k, v in attrs.items()})
    return out


def same(build):
    """Run ``build(m)`` on the reference and on the port; their results must be
    equal bit for bit (``plain``), each made of its own package's objects.
    Returns both results."""
    ref = build(REF)
    port = build(PORT)
    a, b = plain(ref, "repro"), plain(port, "repro_torch")
    assert a == b, _first_difference(a, b)
    return ref, port


def _first_difference(a, b, path="result"):
    """Where two plain results first part, for the failure message."""
    if type(a) is not type(b):
        return f"{path}: {type(a).__name__} {a!r:.200} != {type(b).__name__} {b!r:.200}"
    if isinstance(a, dict):
        if list(a) != list(b):
            return f"{path}: keys {sorted(map(repr, a))!r:.300} != {sorted(map(repr, b))!r:.300}"
        for k in a:
            if a[k] != b[k]:
                return _first_difference(a[k], b[k], f"{path}[{k!r}]")
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return f"{path}: length {len(a)} != {len(b)}"
        for i, (u, v) in enumerate(zip(a, b)):
            if u != v:
                return _first_difference(u, v, f"{path}[{i}]")
    return f"{path}: {a!r:.300} != {b!r:.300}"
