"""Quickstart: train a small GPT on synthetic data, checkpoint it, and
serve it with the batched engine — the whole substrate in one file.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the train steps go through the RMSNorm and flash attention
kernels and their backward kernels, and the served requests through the
flash kernel's prefill, the decode kernel's steps and RMSNorm's kernel.
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import AsyncCheckpointer, load_pytree
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state, make_train_step
from repro_torch.serving.engine import Request, ServingEngine


def main(steps: int = 150, device=None, params=None):
    """Trains from ``params`` (the smoke GPT-A's, converted; updated in place)
    or from parameters made from seed 0 on ``device``.  Returns every step's
    loss and the served requests."""
    device = resolve_device(device)
    cfg = get_smoke_config("gpt_a")
    model = build_model(cfg)
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M")

    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = model.init(gen)
    opt_cfg = OptimizerConfig(peak_lr=3e-3, warmup_steps=10, total_steps=steps)
    step_fn = make_train_step(model.loss, opt_cfg)
    opt_state = init_opt_state(params)

    losses = []
    for i, batch in enumerate(
        make_batches(cfg, DataConfig(batch_size=8, seq_len=128), num_steps=steps)
    ):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if i % 25 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  lr {float(m['lr']):.2e}")

    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer(d)
        ck.save(steps, {"params": params})
        ck.close()
        restored = load_pytree(ck.latest_path(), {"params": params})["params"]
        print("checkpoint round-trip: ok")

    engine = ServingEngine(cfg, restored, max_batch=4, max_len=256, device=device)
    reqs = [
        Request(i, np.arange(5 + 3 * i, dtype=np.int32) % cfg.vocab_size, max_new_tokens=8)
        for i in range(4)
    ]
    done = engine.generate(reqs)
    for r in done:
        print(f"req {r.req_id}: ttft={r.ttft_ms:.0f}ms  tokens={r.generated}")
    return {"losses": losses, "requests": done}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the CUDA device; 'cpu' must be asked for")
    main(device=ap.parse_args().device)
