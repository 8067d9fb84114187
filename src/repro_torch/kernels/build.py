"""Builds the CUDA kernels with ``nvcc`` and loads them with ``ctypes``.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` (one ``nvcc`` a source, all
started together) and linked into one shared library under ``build/`` at the
root of the checkout, at first use, from the sources beside this file and
nothing else.  The sources have a plain C interface and include none of
PyTorch's headers, which is what keeps the build at seconds.  A build that
fails raises; nothing here falls back to anything.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)

# argument types of the C entry points, in the order of their declarations
SIGNATURES = {
    "rmsnorm_launch": [_P, _P, _P, _L, _I, _F, _I, _I, _P],
    "rmsnorm_bwd_grid": [_L, _I, _I, _I, _IP, _IP],
    "rmsnorm_bwd_launch": [_P] * 6 + [_L, _I, _F, _I, _I, _I, _P],
    "flash_attention_launch": [_P] * 5 + [_I] * 6 + [_F, _I, _I] + [_L] * 9 + [_P],
    "flash_attention_bwd_launch": [_P] * 10 + [_I] * 6 + [_F, _I, _I] + [_L] * 15 + [_P],
    "decode_attention_launch": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _I] + [_L] * 8 + [_P],
    "wkv6_launch": [_P] * 7 + [_I] * 7 + [_L] * 12 + [_P],
    "wkv6_bwd_launch": [_P] * 14 + [_I] * 7 + [_L] * 15 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # of the build this process made, None if it found one
build_log: str = ""  # what nvcc and ptxas printed (registers, shared memory, spills)


def build_dir() -> Path:
    """``build/`` at the root of the checkout (src/repro_torch/kernels -> root)."""
    return CSRC.parents[3] / "build"


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are built on the machine with the card")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    global build_seconds, build_log
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = out.parent / f"{src.stem}.{out.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((obj, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for obj, cmd, p in procs:  # wait for every compiler before raising, so that none outlives us
        text, _ = p.communicate()
        logs.append(text)
        if p.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + text)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o, _, _ in procs)]
    r = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + " ".join(link) + "\n" + r.stdout)
    os.replace(tmp, out)  # another process building the same sources loses nothing
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs) + r.stdout


def load() -> ctypes.CDLL:
    """The kernels' library, built first if this checkout has not built these sources yet."""
    global _lib
    if _lib is not None:
        return _lib
    out = build_dir() / f"librepro_torch_kernels.{_digest()}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        _build(out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raises on a launch's return code (cudaGetLastError, or the wrapper's own negative codes)."""
    if code != 0:
        raise RuntimeError(f"{what}: launch refused with code {code}")
