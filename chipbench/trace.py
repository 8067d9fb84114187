"""What a ``torch.profiler`` window of the card shows: the device's busy
seconds (the union of its kernels', copies' and fills' intervals), each
kernel's time and launches by name, the operations that took most time and
the longest idle gaps named by the host operation they fell in."""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, List, Tuple

import torch

from chipbench.device import sync


def _events(prof) -> Tuple[List[Tuple[str, int, int]], List[Tuple[str, int, int]]]:
    """(device events, host events) as (name, start ns, end ns)."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        kind = str(e.device_type())
        item = (e.name(), start, start + dur)
        (device if kind.endswith("CUDA") else host).append(item)
    return device, host


def _union(intervals: List[Tuple[int, int]]) -> Tuple[int, List[Tuple[int, int]]]:
    """(covered ns, the gaps between covered stretches) of sorted intervals."""
    covered, gaps, end = 0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            covered += e - s
            end = e
        elif e > end:
            covered += e - end
            end = e
    return covered, gaps


class Window:
    """The readings of one traced stretch of a run (``traced``)."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels: Dict[str, List[float]] = {}  # name -> [seconds, launches]
        self.device_ops: List[List[Any]] = []
        self.idle_gaps: List[List[Any]] = []

    def seconds_and_calls(self, names: List[str], call: str) -> Tuple[float, int]:
        """The seconds of every kernel whose name holds one of ``names``, and
        the launches of the one whose name holds ``call`` (one a call)."""
        secs = sum(v[0] for k, v in self.kernels.items() if any(n in k for n in names))
        calls = sum(int(v[1]) for k, v in self.kernels.items() if call in k)
        return secs, calls


@contextlib.contextmanager
def traced(out: Window, device: torch.device) -> Iterator[None]:
    """Profile the block, which ends in a synchronisation, into ``out``;
    several blocks traced into one ``Window`` add up."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield
        sync(device)
        out.window_s += time.perf_counter() - t0
    device, host = _events(prof)
    busy, gaps = _union([(s, e) for _, s, e in device])
    out.busy_s += busy / 1e9
    for name, s, e in device:
        k = out.kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e9
        k[1] += 1
    out.device_ops = [[n, v[0]] for n, v in sorted(out.kernels.items(), key=lambda kv: -kv[1][0])[:10]]
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (gs + ge) // 2
        inside = [(s, n) for n, s, e in host if s <= mid <= e]
        out.idle_gaps.append([max(inside)[1] if inside else "no host operation", (ge - gs) / 1e9])
    out.idle_gaps = sorted(out.idle_gaps, key=lambda g: -g[1])[:10]
