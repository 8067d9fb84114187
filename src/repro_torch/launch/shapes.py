"""The assigned input shapes and the sharded ``meta`` leaves of the dry-run:
the port's counterpart of ``repro/launch/shapes.py``.

SHAPES (assignment sheet):
  train_4k     seq=4,096    global_batch=256   -> train step
  prefill_32k  seq=32,768   global_batch=32    -> prefill
  decode_32k   seq=32,768   global_batch=128   -> decode step (1 new token)
  long_500k    seq=524,288  global_batch=1     -> decode step, sub-quadratic

Policies (the reference's):
  * hubert (encoder-only): decode_32k / long_500k skipped; prefill_32k
    runs the encoder's forward (``Model.loss``).
  * long_500k: native for rwkv6 (O(1) state), zamba2 (Mamba2 + shared-attn
    KV) and deepseek-v2-lite (MLA's latent cache); the dense, VLM and MoE
    archs without MLA get a sliding-window variant (window=8192).

A leaf is a ``Sharded``: a ``meta`` tensor of the global shape and dtype, and
its spec fitted to the mesh by the placement plan's ``_fit_spec`` (``P()`` where
nothing fits), as the reference pairs a ``ShapeDtypeStruct`` with its
``NamedSharding``.  ``local_shape`` is the reference's ``shard_shape``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.models.modules import ModelConfig
from repro_torch.parallel.sharding import P, _fit_spec

SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": {"seq_len": 4_096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32_768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32_768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524_288, "global_batch": 1, "kind": "decode"},
}

LONG_WINDOW = 8_192  # sliding window for dense archs at 500k (beyond-paper)


class Sharded(NamedTuple):
    """A ``meta`` tensor of the global shape and dtype, and its fitted spec."""

    value: torch.Tensor
    spec: P

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.value.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype


def local_shape(shape: Tuple[int, ...], spec: P, mesh) -> Tuple[int, ...]:
    """The shape one device holds of ``shape`` under ``spec``: each dim
    divided by the sizes of the axes it is split over."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = 1
        for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            n *= mesh.shape[a]
        out.append(dim // n)
    return tuple(out)


def shape_supported(arch: str, shape: str) -> Tuple[bool, str]:
    cfg = get_config(arch)
    if cfg.family == "audio" and shape in ("decode_32k", "long_500k"):
        return False, "encoder-only: no autoregressive decode (DESIGN.md §4)"
    return True, ""


def config_for(arch: str, shape: str) -> ModelConfig:
    """Arch config with the per-shape policy applied."""
    cfg = get_config(arch)
    if shape == "long_500k" and cfg.family in ("dense", "vlm", "moe"):
        if cfg.mla is None:  # MLA's latent cache handles 500k natively
            cfg = dataclasses.replace(cfg, window=LONG_WINDOW)
    return cfg


def _sharded(shape: Tuple[int, ...], dtype: torch.dtype, mesh, spec: P) -> Sharded:
    fitted = _fit_spec(tuple(shape), spec, mesh)
    return Sharded(torch.empty(tuple(shape), dtype=dtype, device="meta"), fitted if fitted else P())


def batch_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def seq_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "model") if multi_pod else ("model",)


def batch_specs(cfg: ModelConfig, shape: str, mesh, *, multi_pod: bool, pipeline: bool = False) -> Dict[str, Sharded]:
    """The input batch's leaves (with their specs)."""
    s = SHAPES[shape]
    B, T = s["global_batch"], s["seq_len"]
    kind = s["kind"]
    # under pipeline-over-pod the batch dim is sharded by data only (each
    # pod sees the full batch at its stage); otherwise pods split the batch
    ba = ("data",) if (pipeline or not multi_pod) else ("pod", "data")
    bspec = P(ba if len(ba) > 1 else ba[0])

    out: Dict[str, Sharded] = {}
    if kind == "decode":
        out["tokens"] = _sharded((B,), torch.int32, mesh, bspec)
        out["pos"] = _sharded((B,), torch.int32, mesh, bspec)
        return out

    if cfg.family == "audio":
        out["embeds"] = _sharded((B, T, cfg.d_model), torch.bfloat16, mesh, P(bspec[0], None, None))
        out["labels"] = _sharded((B, T), torch.int32, mesh, P(bspec[0], None))
        out["mask"] = _sharded((B, T), torch.float32, mesh, P(bspec[0], None))
    elif cfg.family == "vlm" and kind == "train":
        out["embeds"] = _sharded((B, T, cfg.d_model), torch.bfloat16, mesh, P(bspec[0], None, None))
        out["positions"] = _sharded((3, B, T), torch.int32, mesh, P(None, bspec[0], None))
        out["labels"] = _sharded((B, T), torch.int32, mesh, P(bspec[0], None))
        out["mask"] = _sharded((B, T), torch.float32, mesh, P(bspec[0], None))
    else:
        out["tokens"] = _sharded((B, T), torch.int32, mesh, P(bspec[0], None))
    return out


def cache_specs(cfg: ModelConfig, shape: str, mesh, model, *, multi_pod: bool) -> Dict[str, Sharded]:
    """The KV/state cache's leaves (with their specs), by the model's
    ``cache_shape`` names.

    Batch dim (the first dim after the leading layer/group dims that
    equals global_batch) shards over the batch axes; when B == 1
    (long_500k) the sequence dim shards over (pod×)model instead.
    """
    s = SHAPES[shape]
    B, S = s["global_batch"], s["seq_len"]
    cache = model.cache_shape(B, S)
    ba = batch_axes(multi_pod)
    sa = seq_axes(multi_pod)
    ba_size = 1
    for a in ba:
        ba_size *= mesh.shape[a]

    def spec_for(shape_: Tuple[int, ...]) -> P:
        dims: list = [None] * len(shape_)
        placed_batch = None
        for i in range(1, len(shape_)):
            if shape_[i] == B and B % ba_size == 0 and B > 1:
                dims[i] = ba if len(ba) > 1 else ba[0]
                placed_batch = i
                break
        # shard the largest remaining dim (seq for KV caches, heads for
        # SSM states) over the model axis — and over pod too when the
        # batch could not take it (long_500k's B == 1)
        rem = sa if placed_batch is None else ("model",)
        cand = [i for i in range(1, len(shape_)) if i != placed_batch and shape_[i] > 1]
        if cand:
            longest = max(cand, key=lambda i: shape_[i])
            dims[longest] = rem if len(rem) > 1 else rem[0]
        return P(*dims)

    return {name: _sharded(tuple(sh), dt, mesh, spec_for(tuple(sh))) for name, (sh, dt) in cache.items()}
