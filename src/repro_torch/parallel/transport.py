"""A counted transport over a mesh's axes, on ``torch.distributed``'s ``gloo``.

Point-to-point send and receive to a neighbour on an axis (the pipeline's
``pod`` boundary), all-reduce (sum), all-gather and reduce-scatter (sum) over
an axis group.  Every call adds the bytes this rank hands to it to
``bytes[axis][op]``: a send its tensor, an all-reduce and a reduce-scatter
their whole buffer, an all-gather its own part (what a ring moves on the wire
is a multiple of these, the same for every call of an op).
``pod`` is the WAN link between DCs; ``data`` and ``model`` are links inside a
DC.  ``seconds[axis][op]`` adds each call's wall time, the staging through
host memory included, and ``seconds[axis]["recv"]`` the receives' (their
bytes are the sender's), which is mostly waiting on the neighbour.

``gloo``'s point-to-point takes CPU tensors, and NCCL will not put two ranks
on one card, so a CUDA tensor goes through a pinned host buffer of this
transport's (kept and grown, one for each use).  Sends, receives and gathers
move raw bytes, so any dtype travels bit for bit.  Nothing falls back: a
failed or timed-out call raises (the timeout is the process group's), and a
call on a group that does not hold this rank raises, where ``gloo`` would only
warn and leave the tensor as it was.

``MetaTransport`` is the dry-run's: the same calls on ``meta`` tensors over a
``Mesh`` without process groups, counted by the same ``_count`` (the bytes of
the tensor handed over), moving nothing.  What it returns is what the real
transport allocates on the device: a received tensor, a gathered one.
"""
from __future__ import annotations

import copy
import time
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

OPS = ("send", "all_reduce", "all_gather", "reduce_scatter")


class Transport:
    def __init__(self, mesh):
        self.mesh = mesh
        self.bytes: Dict[str, Dict[str, int]] = {a: dict.fromkeys(OPS, 0) for a in mesh.axis_names}
        self.seconds: Dict[str, Dict[str, float]] = {a: dict.fromkeys(OPS + ("recv",), 0.0)
                                                     for a in mesh.axis_names}
        self._pinned: Dict[str, torch.Tensor] = {}

    def counts(self) -> Dict[str, Dict[str, int]]:
        """A copy of the byte counters."""
        return copy.deepcopy(self.bytes)

    def times(self) -> Dict[str, Dict[str, float]]:
        """A copy of the wall-time counters."""
        return copy.deepcopy(self.seconds)

    def _count(self, axis: str, op: str, host: torch.Tensor, t0: float) -> None:
        self.bytes[axis][op] += host.numel() * host.element_size()
        self.seconds[axis][op] += time.perf_counter() - t0

    def _group(self, axis: str):
        g = self.mesh.group(axis)
        if g is not None and dist.get_rank(g) < 0:
            raise RuntimeError(f"rank {self.mesh.rank} is not in its own {axis!r} group")
        return g

    def _host(self, t: torch.Tensor, use: str) -> torch.Tensor:
        """This transport's pinned buffer for ``use``, as a tensor of t's
        dtype and shape (grown as needed, kept between calls)."""
        n = t.numel() * t.element_size()
        buf = self._pinned.get(use)
        if buf is None or buf.numel() < n:
            buf = self._pinned[use] = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return buf[:n].view(t.dtype).view(t.shape)

    def _stage(self, t: torch.Tensor, use: str) -> torch.Tensor:
        """``t``'s bytes in a CPU tensor: t itself on the CPU (made
        contiguous), else the pinned buffer for ``use``, filled from the device."""
        if t.device.type == "cpu":
            return t.contiguous()
        return self._host(t, use).copy_(t)

    def _neighbour(self, axis: str, step: int) -> int:
        i = self.mesh.coords[axis] + step
        if not 0 <= i < self.mesh.shape[axis]:
            raise ValueError(f"rank {self.mesh.rank} has no neighbour {step:+d} on {axis!r}")
        return self.mesh.rank_at(**{axis: i})

    def send(self, t: torch.Tensor, axis: str, step: int) -> None:
        """Send ``t`` to the rank ``step`` along ``axis`` from this one."""
        t0 = time.perf_counter()
        host = self._stage(t, "send")
        dist.send(_as_bytes(host), self._neighbour(axis, step))
        self._count(axis, "send", host, t0)

    def recv(self, shape: Sequence[int], dtype: torch.dtype, device, axis: str, step: int) -> torch.Tensor:
        """A tensor of ``shape`` and ``dtype`` on ``device`` from the rank
        ``step`` along ``axis`` from this one."""
        t0 = time.perf_counter()
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        host = t if t.device.type == "cpu" else self._host(t, "recv")
        dist.recv(_as_bytes(host), self._neighbour(axis, step))
        if host is not t:
            t.copy_(host)
        self.seconds[axis]["recv"] += time.perf_counter() - t0
        return t

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` over ``axis``'s group, in place; the identity on an axis of size 1."""
        g = self._group(axis)
        if g is None:
            return t
        t0 = time.perf_counter()
        host = self._stage(t, "all_reduce")
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=g)
        if host is not t:
            t.copy_(host)
        self._count(axis, "all_reduce", host, t0)
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every rank's ``t`` on ``axis``, concatenated along ``dim`` in the
        axis's order; ``t`` itself on an axis of size 1."""
        g = self._group(axis)
        if g is None:
            return t
        t0 = time.perf_counter()
        host = self._stage(t, "all_gather")
        parts: List[torch.Tensor] = [torch.empty_like(host, device="cpu") for _ in range(self.mesh.shape[axis])]
        dist.all_gather([_as_bytes(p) for p in parts], _as_bytes(host), group=g)
        out = torch.cat(parts, dim).to(t.device)
        self._count(axis, "all_gather", host, t0)
        return out

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The sum of ``t`` over ``axis``'s group, this rank's block of it
        along ``dim`` (the axis's ranks' blocks in order); ``t`` itself on an
        axis of size 1."""
        g = self._group(axis)
        if g is None:
            return t
        t0 = time.perf_counter()
        host = self._stage(t, "reduce_scatter")
        parts = [p.contiguous() for p in host.chunk(self.mesh.shape[axis], dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=g)
        self._count(axis, "reduce_scatter", host, t0)
        return out.to(t.device)


class MetaTransport(Transport):
    """The transport's counts without its wire: every call on ``meta`` tensors
    over a mesh of this rank alone (``Mesh(shape, names, rank)``, no process
    group), adding to ``bytes[axis][op]`` what ``Transport`` adds, pinning no
    host memory and calling nothing of ``torch.distributed``.  An axis of size
    1 is the identity, as the real transport's."""

    def send(self, t: torch.Tensor, axis: str, step: int) -> None:
        self._neighbour(axis, step)
        self._count(axis, "send", t, time.perf_counter())

    def recv(self, shape: Sequence[int], dtype: torch.dtype, device, axis: str, step: int) -> torch.Tensor:
        self._neighbour(axis, step)
        return torch.empty(tuple(shape), dtype=dtype, device=device)

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        if self.mesh.shape[axis] == 1:
            return t
        self._count(axis, "all_reduce", t, time.perf_counter())
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        n = self.mesh.shape[axis]
        if n == 1:
            return t
        self._count(axis, "all_gather", t, time.perf_counter())
        shape = list(t.shape)
        shape[dim] *= n
        return torch.empty(shape, dtype=t.dtype, device=t.device)

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        n = self.mesh.shape[axis]
        if n == 1:
            return t
        self._count(axis, "reduce_scatter", t, time.perf_counter())
        shape = list(t.shape)
        shape[dim] //= n
        return torch.empty(shape, dtype=t.dtype, device=t.device)


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)
