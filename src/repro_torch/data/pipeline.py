"""Deterministic synthetic data pipeline: the port's own copy of
``repro/data/pipeline.py``, numpy throughout, so that its batches are bit-equal
to the reference's for the same seed.

Produces seeded, reproducible corpora for every model family:
  * LM tokens  — Zipf-distributed ids with short-range structure (a
    Markov-ish blend so the loss actually decreases during training);
  * audio      — frame embeddings + k-means-style cluster labels (hubert);
  * vlm        — interleaved "text+patch" embeddings + 3-row M-RoPE
    position ids (qwen2-vl; the vision frontend is stubbed per the
    assignment carve-out).

``make_batches`` yields *global* numpy arrays, seeded by (seed, step) — the
same recipe a real tfds/grain loader would follow, without file I/O; the
launcher moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.modules import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch_size: int = 8
    seq_len: int = 128
    zipf_a: float = 1.2
    structure: float = 0.7  # P(copy a recent token) — gives learnable signal


def _lm_tokens(rng: np.random.Generator, cfg: DataConfig, vocab: int) -> np.ndarray:
    B, T = cfg.batch_size, cfg.seq_len
    base = rng.zipf(cfg.zipf_a, size=(B, T)).astype(np.int64) % vocab
    out = base.copy()
    # structured channel: with prob `structure`, token t repeats token t-k
    # for a per-sequence lag k — n-gram signal a model can learn quickly.
    lags = rng.integers(1, 8, size=(B, 1))
    copy_mask = rng.random((B, T)) < cfg.structure
    idx = np.maximum(np.arange(T)[None, :] - lags, 0)
    out = np.where(copy_mask, np.take_along_axis(out, idx, axis=1), out)
    return out.astype(np.int32)


def make_batches(
    model_cfg: ModelConfig, data_cfg: DataConfig, num_steps: Optional[int] = None
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield batches keyed per family (see ``models/transformer.py``)."""
    step = 0
    B, T = data_cfg.batch_size, data_cfg.seq_len
    while num_steps is None or step < num_steps:
        rng = np.random.default_rng((data_cfg.seed, step))
        if model_cfg.family == "audio":
            feats = rng.standard_normal((B, T, model_cfg.d_model)).astype(np.float32)
            # cluster labels correlated with features => learnable
            proj = np.random.default_rng(data_cfg.seed).standard_normal(
                (model_cfg.d_model, model_cfg.vocab_size)
            )
            labels = np.argmax(feats @ proj, axis=-1).astype(np.int32)
            mask = np.ones((B, T), np.float32)
            yield {"embeds": feats * 0.05, "labels": labels, "mask": mask}
        elif model_cfg.family == "vlm":
            tokens = _lm_tokens(rng, data_cfg, model_cfg.vocab_size)
            # stubbed frontend: first `n_img` positions are "image patches"
            n_img = T // 4
            emb_rng = np.random.default_rng((data_cfg.seed, step, 1))
            embeds = emb_rng.standard_normal((B, T, model_cfg.d_model)).astype(np.float32) * 0.02
            # M-RoPE ids: patches get (t0, h, w); text gets (t, t, t)
            side = max(1, int(np.sqrt(n_img)))
            tpos = np.arange(T)[None].repeat(B, 0)
            hpos = tpos.copy()
            wpos = tpos.copy()
            hh, ww = np.divmod(np.arange(n_img), side)
            hpos[:, :n_img] = hh[None]
            wpos[:, :n_img] = ww[None]
            tpos[:, :n_img] = 0
            positions = np.stack([tpos, hpos, wpos]).astype(np.int32)
            mask = np.ones((B, T), np.float32)
            mask[:, :n_img] = 0.0  # no LM loss on image patches
            yield {
                "embeds": embeds,
                "positions": positions,
                "labels": np.roll(tokens, -1, axis=1).astype(np.int32),
                "mask": mask,
            }
        else:
            tokens = _lm_tokens(rng, data_cfg, model_cfg.vocab_size)
            yield {"tokens": tokens}
        step += 1


def input_batch_for(model_cfg: ModelConfig, batch_size: int, seq_len: int, seed: int = 0):
    """One concrete batch (smoke tests / examples)."""
    it = make_batches(model_cfg, DataConfig(seed=seed, batch_size=batch_size, seq_len=seq_len))
    return next(it)
