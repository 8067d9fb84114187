"""The few calls that differ between the card and the CPU, on which the
benchmark's own tests drive a run at a small size (``run.main`` refuses a
machine with no card; the tests call the drivers directly)."""
from __future__ import annotations

import time
from typing import List

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Marks:
    """Points in a device's stream: CUDA events on the card, the host clock
    after a synchronisation elsewhere; ``ms(i, j)`` between two of them."""

    def __init__(self, device: torch.device, n: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.points: List = [torch.cuda.Event(enable_timing=True) if self.cuda else 0.0 for _ in range(n)]

    def mark(self, i: int) -> None:
        if self.cuda:
            self.points[i].record()
        else:
            self.points[i] = time.perf_counter()

    def ms(self, i: int, j: int) -> float:
        if self.cuda:
            return self.points[i].elapsed_time(self.points[j])
        return (self.points[j] - self.points[i]) * 1e3
