"""Weights made from ``--seed`` on the card: one ``torch.Generator`` a leaf,
seeded from (seed, the leaf's index), and one draw of the whole layer-stacked
leaf.  A leaf can then be made again alone (``leaf``), which is how the
checks find the weights a run started from after the program has trained
them in place.

A layout is an ordered list of ``(path, shape, init)``: ``path`` the leaf's
keys in the program's nested dict, ``init`` one of ``("normal", std)``,
``("fan_in", scale)`` (a std of scale / sqrt(shape[-2])), ``("uniform", lo,
hi)`` or ``("const", value)``.  The family's reference module gives it
(``layout``)."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch

Layout = List[Tuple[Tuple[str, ...], Tuple[int, ...], tuple]]


def _generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + 7919 * (index + 1)) % (2**63 - 1))
    return gen


def leaf(layout: Layout, index: int, seed: int, device, dtype: torch.dtype) -> torch.Tensor:
    """Leaf ``index`` of ``layout`` as ``make`` makes it."""
    _, shape, init = layout[index]
    gen = _generator(seed, index, torch.device(device))
    kind = init[0]
    if kind == "const":
        return torch.full(shape, float(init[1]), dtype=dtype, device=device)
    if kind == "uniform":
        t = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        return t.mul_(init[2] - init[1]).add_(init[1]).to(dtype)
    std = init[1] if kind == "normal" else init[1] / math.sqrt(shape[-2])
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return t.mul_(std)


def make(layout: Layout, seed: int, device, dtype_of) -> Dict[str, Any]:
    """The nested parameter dict; ``dtype_of(path)`` gives each leaf's dtype."""
    params: Dict[str, Any] = {}
    for i, (path, _, _) in enumerate(layout):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf(layout, i, seed, device, dtype_of(path))
    return params


def get(params: Dict[str, Any], path: Sequence[str]) -> torch.Tensor:
    for key in path:
        params = params[key]
    return params

