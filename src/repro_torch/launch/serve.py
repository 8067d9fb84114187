"""Serving launcher: batched prefill/decode with the Splitwise-style split
(paper §5).  Counterpart of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-a --full \\
      --requests 8 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-34b --full --layers 60
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --full --splitwise

Runs on the card; ``--device cpu`` runs the plain PyTorch path on the CPU.  On
the card the weights are made directly in the activation dtype (``Model.init``
with ``dtype``: the same bits as the f32 weights cast, without holding them,
each layer-stacked leaf drawn one layer at a time), which is what lets the
14-16B MoE models and DeepSeek-Coder 33B (66.68 GB) fit one H100.
``--layers`` cuts the depth: Granite-34B-Code's 88 layers are 94.50 GB, 60 of
them 64.81 GB (for Zamba2 it must stay a whole number of its groups of 6).  The audio encoder (HuBERT-XLarge) does not decode: it is
refused here; its entry points are ``Model.loss`` and ``Model.prefill``
without a cache.  The last line is the reference's analytic TTFT of the
paper's A100 testbed (``core/bubbletea.py``'s ``PrefillLatencyModel``), not
a measurement of the device the run used.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.bubbletea import InferenceModelSpec, PrefillLatencyModel
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.serving.engine import Request, ServingEngine, SplitwiseCluster


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-a")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--splitwise", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' must be asked for")
    ap.add_argument("--full", action="store_true", help="the full-size config instead of the smoke config")
    ap.add_argument("--layers", type=int, default=None, help="serve this many of the config's layers")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    if not cfg.causal:
        raise ValueError(f"{cfg.name}: an encoder does not decode; call Model.loss or Model.prefill(..., cache=None)")
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    device = resolve_device(args.device)
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = model.init(gen, dtype=cfg.dtype)
    rng = np.random.default_rng(args.seed)

    reqs = [
        Request(
            i,
            rng.integers(0, cfg.vocab_size, size=rng.integers(4, args.prompt_len)).astype(np.int32),
            max_new_tokens=args.max_new,
        )
        for i in range(args.requests)
    ]

    if args.splitwise:
        cluster = SplitwiseCluster(cfg, params, args.batch, args.max_len, device)
        serve = cluster.serve
    else:
        engine = ServingEngine(cfg, params, args.batch, args.max_len, device)
        serve = engine.generate

    done = []
    t0 = time.perf_counter()
    for i in range(0, len(reqs), args.batch):
        done += serve(reqs[i : i + args.batch])
    wall_s = time.perf_counter() - t0

    ttfts = [r.ttft_ms for r in done]
    tbts = [t for r in done for t in r.tbt_ms]
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[serve] arch={cfg.name} device={where} requests={len(done)} wall={wall_s:.2f}s")
    print(f"  TTFT ms: p50={np.percentile(ttfts,50):.1f} p99={np.percentile(ttfts,99):.1f}")
    if tbts:
        print(f"  TBT  ms: p50={np.percentile(tbts,50):.1f} p99={np.percentile(tbts,99):.1f}")
    if args.splitwise:
        print(f"  KV bytes moved: {cluster.kv_bytes_moved/1e6:.2f} MB")
    # the reference's analytic TTFT model (paper Fig 14) of the paper's A100
    # testbed: a simulated number, not a measurement of this device
    lm = PrefillLatencyModel(InferenceModelSpec("llama3-8b", 8e9))
    print(f"  [model] A100 TTFT(512, PP=1)={lm.ttft_ms(512,1):.0f}ms "
          f"(8192, PP=8)={lm.ttft_ms(8192,8):.0f}ms")
    return done


if __name__ == "__main__":
    main()
