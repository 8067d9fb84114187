"""End-to-end script: train a ~100M-parameter GPT for a few hundred steps
on synthetic data with checkpointing — the training-kind deliverable (b).

On the card the steps go through the RMSNorm and flash attention kernels and
their backward kernels; ``--device cpu`` runs the plain path on the CPU
(tens of minutes there; pass --steps to shorten).

  PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 200
"""
import argparse
import time

import torch

from repro_torch.ckpt.checkpoint import AsyncCheckpointer
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.device import resolve_device
from repro_torch.models.modules import ModelConfig
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizer import OptimizerConfig, init_opt_state, make_train_step

# ~100M params: 12 x (4*512^2 attn + 3*512*2048 GLU) + 2 * 32768*512 emb/head
CFG_100M = ModelConfig(
    name="gpt-100m",
    family="dense",
    num_layers=12,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=32768,
    ffn_activation="swiglu",
    remat="none",
    source="quickstart-scale GPT (deliverable b)",
)


def main(argv=None, device=None, params=None):
    """Trains ``CFG_100M`` from ``params`` (converted; updated in place) or
    from parameters made from seed 0 on ``device`` (``--device``).  Returns
    every step's loss and the last checkpoint's path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_100m_ckpt")
    ap.add_argument("--device", default=device, help="default: the CUDA device; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = build_model(CFG_100M)
    print(f"params: {CFG_100M.param_count()/1e6:.1f}M  steps: {args.steps}")
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        params = model.init(gen)
    opt_cfg = OptimizerConfig(peak_lr=6e-4, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(model.loss, opt_cfg)
    opt_state = init_opt_state(params)
    ck = AsyncCheckpointer(args.ckpt_dir, keep=2)

    t0 = time.time()
    first = last = None
    losses = []
    for i, b in enumerate(
        make_batches(CFG_100M, DataConfig(batch_size=args.batch, seq_len=args.seq),
                     num_steps=args.steps)
    ):
        params, opt_state, m = step_fn(
            params, opt_state, {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        )
        loss = float(m["loss"])
        losses.append(loss)
        first = first if first is not None else loss
        last = loss
        if i % 20 == 0 or i == args.steps - 1:
            tok_s = (i + 1) * args.batch * args.seq / (time.time() - t0)
            print(f"step {i:4d}  loss {loss:.4f}  tok/s {tok_s:,.0f}", flush=True)
        if i and i % 100 == 0:
            ck.save(i, {"params": params}, {"loss": loss})
    ck.save(args.steps, {"params": params}, {"loss": last})
    ck.close()
    print(f"done: loss {first:.3f} -> {last:.3f}; checkpoint at {ck.latest_path()}")
    assert last < first, "training did not reduce the loss"
    return {"losses": losses, "checkpoint": ck.latest_path()}


if __name__ == "__main__":
    main()
