"""Checkpointing: a tree of tensors <-> npz, with an async writer thread; the
counterpart of ``repro/ckpt/checkpoint.py``, in its on-disk format, so that a
file written by either package loads in the other.

A checkpoint is one uncompressed ``np.savez`` archive, ``<dir>/step_<n>.npz``,
with a JSON manifest beside it (``step_<n>.npz.json``) and a ``latest``
pointer, each replaced atomically.  The archive's keys are ``"/"``-joined
paths, named as ``jax.tree_util.tree_flatten_with_path`` names them: a dict
key as itself, a list or tuple index as its number (``history/0``), a
NamedTuple field as ``.`` plus its name (``opt/.step``, ``opt/.mu/embed``).
numpy has no bf16: a bf16 tensor is stored as the reference's files hold jax's
bf16, two raw bytes an element (``|V2``), and restored from them.

The train loop hands a snapshot to ``AsyncCheckpointer.save``, which copies
every tensor to host memory before it returns (the port updates its parameters
and moments in place); a background thread serialises it.  Restore
(``load_pytree``) is synchronous.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_SEP = "/"
_BF16_NP = np.dtype("V2")  # how np.savez stores jax's bfloat16, and so how a bf16 leaf is stored here


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in the order jax flattens: dict keys sorted, sequences and
    NamedTuple fields in order; ``None`` is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), path + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    elif tree is not None:
        yield _SEP.join(path), tree


def _to_numpy(leaf: Any) -> np.ndarray:
    """A leaf as the array the archive holds: a tensor copied to host memory
    (bf16 as ``|V2``), so that a later in-place update of the live tensor
    cannot reach it; anything else through ``np.asarray``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        return t.view(torch.int16).numpy().view(_BF16_NP) if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _walk(tree)}


def _atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_pytree(path: str, tree: Any, metadata: Optional[Dict] = None) -> None:
    """Serialise ``tree`` to ``path`` crash-atomically: a reader (or a restore
    after a crash mid-write) sees the whole archive or nothing, never a
    truncated ``.npz``.  The temporary file is an open file object, not a
    path: ``np.savez`` appends ``.npz`` to a path, which would defeat the
    rename."""
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if metadata is not None:
        _atomic_write_text(path + ".json", json.dumps(metadata))


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return _BF16_NP if dtype == torch.bfloat16 else torch.empty((), dtype=dtype).numpy().dtype


def _restore(key: str, arr: np.ndarray, like: Any) -> Any:
    """``arr`` as a leaf of ``like``'s kind: a tensor of its dtype on its
    device, or a numpy array.  Raises on a shape or dtype that differs."""
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {tuple(arr.shape)} in the checkpoint, {tuple(like.shape)} expected")
    if isinstance(like, torch.Tensor):
        if arr.dtype != _numpy_dtype(like.dtype):
            raise ValueError(f"{key}: dtype {arr.dtype} in the checkpoint, {like.dtype} expected")
        if like.dtype == torch.bfloat16:
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(like.device)
        return torch.from_numpy(arr).to(like.device)
    if arr.dtype != np.dtype(like.dtype):
        raise ValueError(f"{key}: dtype {arr.dtype} in the checkpoint, {np.dtype(like.dtype)} expected")
    return arr


def _rebuild(like: Any, leaves: Iterator[Any]) -> Any:
    """``like``'s structure with its leaves taken in ``_walk``'s order."""
    if isinstance(like, dict):
        done = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: done[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, name), leaves) for name in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return None if like is None else next(leaves)


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (its leaves give shape, dtype
    and, for a tensor, the device).  A key ``like`` has and the archive lacks
    raises ``KeyError``."""
    with np.load(path) as z:
        leaves = [_restore(key, z[key], leaf) for key, leaf in _walk(like)]
    return _rebuild(like, iter(leaves))


class AsyncCheckpointer:
    """Background-thread checkpoint writer (``save`` returns once the snapshot
    is in host memory).  Up to two snapshots wait in its queue while a third is
    written, as in the reference: size host memory for three whole states.

    ``timings`` holds one dict a save: ``step``, ``bytes`` (the leaves'),
    ``snapshot_s`` (the host-blocking copy in ``save``), and once written
    ``write_started`` and ``write_ended`` (``time.perf_counter()``)."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self.timings: List[Dict[str, Any]] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, tree, meta, timing = item
                try:
                    timing["write_started"] = time.perf_counter()
                    path = os.path.join(self.dir, f"step_{step:08d}.npz")
                    save_pytree(path, tree, meta)
                    _atomic_write_text(os.path.join(self.dir, "latest"), os.path.basename(path))
                    self._gc()
                    timing["write_ended"] = time.perf_counter()
                except BaseException as e:  # surfaced on the next save, wait or close
                    self._err = e
                del tree
            finally:
                self._q.task_done()

    def _gc(self):
        ckpts = sorted(f for f in os.listdir(self.dir) if f.startswith("step_") and f.endswith(".npz"))
        for old in ckpts[: -self.keep]:
            os.remove(os.path.join(self.dir, old))
            j = os.path.join(self.dir, old + ".json")
            if os.path.exists(j):
                os.remove(j)

    def save(self, step: int, tree: Any, metadata: Optional[Dict] = None) -> None:
        """Copies every tensor of ``tree`` to host memory now (the live
        tensors are updated in place by the next steps) and queues the copy."""
        if self._err:
            raise self._err
        t0 = time.perf_counter()
        host = _flatten(tree)
        timing = {"step": step, "bytes": sum(a.nbytes for a in host.values()), "snapshot_s": time.perf_counter() - t0}
        self.timings.append(timing)
        self._q.put((step, host, metadata or {}, timing))

    def wait(self) -> None:
        """Blocks until every queued snapshot is durable (or failed):
        ``Queue.join`` waits for ``task_done``, that is for the write to end,
        not merely for the worker to take the item."""
        self._q.join()
        if self._err:
            raise self._err

    def close(self) -> None:
        """Drains, stops the worker thread and raises any writer error.  The
        sentinel is queued even when ``wait`` raises, so the thread never
        outlives the checkpointer."""
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join(timeout=30)

    def latest_path(self) -> Optional[str]:
        p = os.path.join(self.dir, "latest")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return os.path.join(self.dir, f.read().strip())
