"""Serving engine: KV-cache management, batched prefill/decode, and the
Splitwise-style prefill/decode split that BubbleTea builds on (paper §5).
Counterpart of ``repro/serving/engine.py``.

Roles:
  * ``ServingEngine`` owns the parameters (cast once to the activation dtype),
    runs batched ``prefill`` and ``decode_step``, applies greedy/temperature
    sampling, and tracks per-request TTFT/TBT.  Times are taken on the host
    clock after the device has finished.
  * ``SplitwiseCluster``: two engines sharing weights; the "prefill side"
    hands the KV cache to the "decode side" as a real copy on the device.

The engines run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention
from repro_torch.models.modules import ModelConfig
from repro_torch.models.transformer import Model, build_model


def zeros_cache(model: Model, batch: int, max_len: int, device) -> Dict[str, torch.Tensor]:
    """Concrete empty cache (pos arrays start at -1 = empty slot)."""
    cache = {}
    for name, (shape, dtype) in model.cache_shape(batch, max_len).items():
        fill = -1 if dtype == torch.int32 else 0
        cache[name] = torch.full(shape, fill, dtype=dtype, device=device)
    return cache


def _is_ring_leaf(x: torch.Tensor, ring: int) -> bool:
    # cache leaves are layer-stacked: attention rings are (L, B, S, ...)
    # with S = the slot ring; recurrent state has no slot dimension
    return x.dim() >= 3 and x.shape[2] == ring


def kv_cache_bytes_per_token(cache: Dict[str, torch.Tensor], ring: int) -> float:
    """Bytes of KV state one *valid* token occupies in ``cache``: the
    floating-point leaves with a ``ring`` slot dimension, at leaf bytes over
    ``batch × ring``.  The int32 ``pos`` ring is slot bookkeeping, not
    handed-off model state."""
    total = 0.0
    for x in cache.values():
        if x.is_floating_point() and _is_ring_leaf(x, ring):
            total += x.numel() * x.element_size() / (x.shape[1] * ring)
    return total


def kv_cache_state_bytes_per_seq(cache: Dict[str, torch.Tensor], ring: int) -> float:
    """Per-sequence bytes of recurrent state in ``cache`` (leaves without a
    ``ring`` slot dimension).  Zero for pure-attention caches."""
    total = 0.0
    for x in cache.values():
        if x.is_floating_point() and not _is_ring_leaf(x, ring):
            total += x.numel() * x.element_size() / x.shape[1]
    return total


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # (T,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    # filled during processing
    generated: Optional[List[int]] = None
    ttft_ms: float = 0.0
    tbt_ms: List[float] = dataclasses.field(default_factory=list)


class ServingEngine:
    """Batched serving over one model replica."""

    def __init__(self, cfg: ModelConfig, params: Any, max_batch: int, max_len: int, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        # no-op for leaves that are already cast (SplitwiseCluster shares one copy)
        self.params = self.model.cast_params(params)
        self.max_batch = max_batch
        self.max_len = max_len
        # recurrent families (mamba/rwkv/hybrid) scan every input token into
        # their state: pad slots cannot be masked by positions, so their
        # ragged batches must be served per request (see generate/serve)
        self._recurrent = cfg.rwkv is not None or cfg.family in ("ssm", "hybrid")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def prefill_batch(self, requests: List[Request]) -> Tuple[Any, torch.Tensor, torch.Tensor]:
        """Right-aligned batched prefill. Returns (cache, next_tokens, pos).

        Pad slots carry position -1: the masked ``sdpa`` and the decode kernel
        treat negative positions as empty, so a short prompt's output does not
        depend on its batch neighbours; each request then decodes from its own
        prompt length.  The flash kernel takes no positions, so a ragged batch
        is pinned to the masked plain ``sdpa``; that choice follows from the
        input alone (positions not dense)."""
        if len(requests) > self.max_batch:
            raise ValueError(f"{len(requests)} requests exceed max_batch {self.max_batch}")
        B = len(requests)
        T = max(len(r.prompt) for r in requests)
        toks = np.zeros((B, T), np.int32)
        pos2d = np.full((B, T), -1, np.int32)
        for i, r in enumerate(requests):
            n = len(r.prompt)
            toks[i, T - n:] = r.prompt  # right-align
            pos2d[i, T - n:] = np.arange(n)
        positions = torch.from_numpy(pos2d).to(self.device)
        if self.cfg.mrope_sections is not None:  # text tokens carry (t, t, t)
            positions = positions[None].expand(3, B, T)
        batch = {"tokens": torch.from_numpy(toks).to(self.device), "positions": positions}
        cache = zeros_cache(self.model, B, self.max_len, self.device)
        self._sync()
        t0 = time.perf_counter()
        if self._ragged(requests):
            with attention.force_impl("torch"):
                logits, cache = self.model.prefill(self.params, batch, cache)
        else:
            logits, cache = self.model.prefill(self.params, batch, cache)
        self._sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        nxt = self._sample(logits, requests)
        pos = torch.tensor([len(r.prompt) for r in requests], dtype=torch.int32, device=self.device)
        for r, tok in zip(requests, nxt.tolist()):  # one transfer for the whole batch
            r.ttft_ms = wall_ms
            r.generated = [tok]
        return cache, nxt, pos

    @torch.no_grad()
    def decode_batch(self, requests: List[Request], cache, tokens, pos, steps: int, step0: int = 1):
        """``step0`` is the sampling-step index of the first decode step (the
        prefill sample is step 0), threaded into ``_sample`` so each step
        draws from a distinct stream.  The cache is updated in place."""
        for k in range(steps):
            self._sync()
            t0 = time.perf_counter()
            logits, cache = self.model.decode_step(self.params, cache, tokens, pos)
            self._sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
            tokens = self._sample(logits, requests, step=step0 + k)
            pos = pos + 1
            for r, tok in zip(requests, tokens.tolist()):
                if len(r.generated) < r.max_new_tokens:
                    r.generated.append(tok)
                    r.tbt_ms.append(wall_ms)
        return cache, tokens, pos

    def _sample(self, logits: torch.Tensor, requests: List[Request], step: int = 0) -> torch.Tensor:
        temps = np.array([r.temperature for r in requests], np.float32)
        if (temps == 0).all():
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # seed = hash of the req-id *tuple* (order-sensitive, so two batches
        # whose ids share a sum still differ) with the sampling step folded in
        # (so each decode step draws from its own stream)
        seed = hash((hash(tuple(r.req_id for r in requests)) & 0x7FFFFFFF, step)) & 0x7FFFFFFF
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(seed)
        t = torch.from_numpy(temps).to(logits.device)
        probs = torch.softmax(logits / torch.clamp(t, min=1e-3)[:, None], dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)

    def _ragged(self, requests: List[Request]) -> bool:
        T = max(len(r.prompt) for r in requests)
        return any(len(r.prompt) != T for r in requests)

    def split_ragged_recurrent(self, requests: List[Request], serve_fn: Callable) -> bool:
        """Recurrent families scan pads into their state (positions can't
        mask them): serve such ragged batches per-request via ``serve_fn``.
        Returns True when the batch was handled that way."""
        if self._recurrent and self._ragged(requests):
            for r in requests:
                serve_fn([r])
            return True
        return False

    def generate(self, requests: List[Request]) -> List[Request]:
        if self.split_ragged_recurrent(requests, self.generate):
            return requests
        cache, tok, pos = self.prefill_batch(requests)
        steps = max(r.max_new_tokens for r in requests) - 1
        self.decode_batch(requests, cache, tok, pos, steps)
        return requests


class SplitwiseCluster:
    """Prefill on one engine, decode on another (KV handoff in between)."""

    def __init__(self, cfg: ModelConfig, params: Any, max_batch: int, max_len: int, device=None):
        self.prefill_engine = ServingEngine(cfg, params, max_batch, max_len, device)
        # the decode side shares the prefill side's cast weights
        self.decode_engine = ServingEngine(cfg, self.prefill_engine.params, max_batch, max_len, device)
        self.kv_bytes_moved = 0

    def serve(self, requests: List[Request]) -> List[Request]:
        if self.prefill_engine.split_ragged_recurrent(requests, self.serve):
            return requests
        cache, tok, pos = self.prefill_engine.prefill_batch(requests)
        # KV handoff (Splitwise): count only the *valid* slots; the ring is
        # B × max_len and mostly empty, and the latency model prices
        # kv_bytes_per_token × prompt_tokens.
        eng = self.prefill_engine
        ring = min(eng.max_len, eng.cfg.window) if eng.cfg.window else eng.max_len
        per_token = kv_cache_bytes_per_token(cache, ring)
        per_seq = kv_cache_state_bytes_per_seq(cache, ring)
        self.kv_bytes_moved += per_token * sum(min(len(r.prompt), ring) for r in requests) + per_seq * len(requests)
        cache = {name: x.clone() for name, x in cache.items()}  # the handoff: a copy on the device
        steps = max(r.max_new_tokens for r in requests) - 1
        self.decode_engine.decode_batch(requests, cache, tok, pos, steps)
        return requests
