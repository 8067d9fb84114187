#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card and ``nvcc``; takes no arguments.  It builds the
port's CUDA kernels from ``src/repro_torch/kernels/csrc`` (the four forward
kernels and the backward kernels of RMSNorm, attention and WKV-6), holds each of them
against its plain PyTorch version on the card, runs the port's copy of the
paper's simulator on the host (fig 9's grid, fig 13's BubbleTea scenario and
a traced run, whose times are the paper's A100 testbed model, not the
card's), serves two models at full
width with random weights from a seed through ``ServingEngine.generate`` and
``SplitwiseCluster.serve`` (GPT-A, 24 layers x 4096 x 16384, vocabulary 50304:
RMSNorm, flash and decode attention kernels; then RWKV-6 7B, 32 layers x 4096 x
14336, vocabulary 65536: RMSNorm and WKV-6 kernels), trains GPT-A at full
width with 8 of its 24 layers for 8 steps through
``repro_torch.launch.train.train`` (RMSNorm and attention forward and backward
kernels), trains HuBERT-XLarge (48 x 1280) and Zamba2-2.7B (54 layers) at full
width and depth the same way, checkpointing HuBERT's train state and holding
its restore and a run resumed from it against the live run, trains RWKV-6 7B
at full width with 8 of its 32 layers (RMSNorm and WKV-6 forward and
backward kernels), and then serves
the MoE family at full width and depth with its weights made directly in bf16
(Qwen1.5-MoE-A2.7B, 24 layers x 2048, 60 experts top-4, vocabulary 151936:
RMSNorm, flash and decode attention kernels; then
DeepSeek-V2-Lite, 27 layers x 2048, MLA, 64 experts top-6, vocabulary 102400:
RMSNorm kernel, MLA plain as in the reference), and then the rest of the
transformer stack at full width, weights made directly in bf16, one model at
a time: DeepSeek-Coder 33B (62 x 7168, 56/8 heads), Granite-34B-Code (60 of
its 88 layers x 6144, 48/1 heads), Nemotron-4 15B (32 x 6144, 48/8 heads,
squared ReLU) and Qwen2-VL 7B (28 x 3584, 28/4 heads, M-RoPE; also one
pipeline batch of image-patch embeddings, which the model pins to the masked
plain attention) served as above (RMSNorm, flash and decode attention
kernels), and HuBERT-XLarge's bidirectional encoder (48 x 1280, 16 heads of
80) through ``Model.loss`` and ``Model.prefill`` on 4 x 1024 frames (RMSNorm
kernel, flash kernel non-causal at head size 80), and last Zamba2-2.7B at full
width and depth (54 layers x 2560: 9 groups of 5 Mamba2 layers and the shared
attention block, 32 heads of 80, vocabulary 32000; RMSNorm kernel for every
norm and Mamba2's gated norm, flash kernel causal and decode kernel at head
size 80 in the shared block).  Between the training and the MoE phases it
runs the distributed phases, ranks as ``gloo`` processes that share the card,
in two spawns (one of four ranks, one of two), each rank running its spawn's
runs in turn, each run with its own deadline.  It trains through the
cross-pod pipeline (``repro_torch.parallel.pipeline``) GPT-A at full width
with 2 of its 24 layers on meshes (pod, data, model) of (2, 2, 1) and (2, 1,
2) (one trained step a run), and on (2, 1, 2) RWKV-6 7B (2 of 32 layers), DeepSeek-V2-Lite (2 of 27)
and Zamba2-2.7B (3 of its 9 groups), each held against gradient accumulation
over the same chunks; on (2, 2, 1) the same ranks then run GPT-A FSDP over
``data`` inside the stages (the reference's fsdp plan: each stage's blocks
gathered once a step, their gradients reduce-scattered once), held bit for bit
against the call without FSDP and against its trained state; on (2, 1, 2)
each model is tensor-parallel over ``model`` inside the stages (GPT-A's and
Zamba2's attention at 16 of 32 heads, RWKV-6's K4 at 32 of 64 heads,
DeepSeek-V2-Lite's 32 of 64 experts and 8 of 16 MLA heads, its calls pinned
to the control's routes), held against the replicated call on the same mesh,
which is held against accumulation; the GPT-A (2, 1, 2) run saves its whole
state at the end (rank 0 gathers the stages' blocks), and the file, cut back
into stages and blocks in the parent, must hash as every rank's own state.
The same four ranks then train GPT-A with 2 layers tensor-parallel on (data,
model) = (2, 2), and FSDP over ``data`` on top (the reference's fsdp plan:
each rank its ``data`` block of its ``model`` shard, layers gathered inside
remat, gradients reduce-scattered), held against the tensor-parallel call and
state; and DeepSeek-V2-Lite at full width with 2 of its 27 layers
tensor-parallel on (2, 2), its experts split over ``model`` (32 of 64 a
rank), MLA by heads (8 of 16) and its shared expert on its matrices' first
dims, held against each rank's replicated call on the same mesh, whose routes
it replays.  Two ranks then train GPT-A with 2 layers data-parallel (step 0
held against accumulation, the replicas bit-equal after), and RWKV-6 7B (2 of
its 32 layers, by heads: K4 and its backward at 32 of 64 heads a rank) and
Zamba2-2.7B (6 of its 54 layers, as the reference's plan places it: w_z and
w_x on d, conv_x on its taps, the shared block at 16 of 32 heads) and the
pure Mamba2 stack at Zamba2-2.7B's widths (6 layers, by heads: 40 of 80 a
rank) tensor-parallel on (data, model) = (1, 2), each held against each
rank's replicated call; and RWKV-6 7B (2 of 32 layers) under FSDP over
``data`` on (2, 1) at the plan's threshold of ``w0``'s own bytes (``w0``
split on its layer axis, 12 other leaves on their own dims), held against
each rank's replicated call, its state gathered whole to rank 0
(``gather_train_state``), held against the replicated run's and cut back
into every rank's live blocks bit for bit; and it runs the five examples of ``repro_torch.examples``
through their mains (``whatif``, ``bubbletea_serve``, ``quickstart``,
``train_100m``, ``geo_train`` on eight ranks), each's launches counted.  For each path it checks by
the kernels' launch counters that it really went through the kernels, and
compares the kernel path's logits, or loss and gradients, with the plain
path's.  Seventeen of its steps are also held against the port's dry-run
(``repro_torch.launch.dryrun``), predicted on ``meta`` from the config alone
in a background process: argument bytes, launches and transport bytes
exactly, the peak within max(3 %, 256 MiB); phase ``dryrun`` adds three
full-size combinations of the dry-run's launcher, run on the host.

Every phase prints one JSON line (the train phase also the launcher's step
lines), with its peak device memory.  Any failure raises, so the exit code is not 0 and the last line is
not printed.  The last line of a good run is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": <name>, "count": 1}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import obs  # noqa: E402
from repro_torch.ckpt.checkpoint import _walk, load_pytree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import expected_shapes, flatten  # noqa: E402
from repro_torch.convert import tree_map as convert_tree_map  # noqa: E402
from repro_torch.core import bubbletea, simulator  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batches  # noqa: E402
from repro_torch.examples import bubbletea_serve, geo_train, quickstart, train_100m, whatif  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.kernels import wkv6 as wkv_mod  # noqa: E402
from repro_torch.kernels._check import rows_aligned  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import TIMEOUT, Mesh, make_mesh  # noqa: E402
from repro_torch.launch.train import optimizer_config, train  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import ssm as ssm_lib  # noqa: E402
from repro_torch.models.transformer import build_model, build_pipeline_parts  # noqa: E402
from repro_torch.optim.optimizer import (  # noqa: E402
    OptState,
    accumulated_value_and_grad,
    adamw_update,
    gradients,
    init_opt_state,
    make_train_step,
)
from repro_torch.parallel.data_parallel import DataParallelLoss  # noqa: E402
from repro_torch.parallel.pipeline import (  # noqa: E402
    PipelineLoss,
    gather_train_state,
    make_pipeline_loss,
    padded_num_layers,
    stack_length,
    stage_layer_range,
    stage_params,
)
from repro_torch.parallel.sharding import P, local_block, shard_params  # noqa: E402
from repro_torch.parallel.tensor_parallel import is_split, model_plan, split_paths  # noqa: E402
from repro_torch.parallel.transport import MetaTransport  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    Request,
    ServingEngine,
    SplitwiseCluster,
    _is_ring_leaf,
    kv_cache_bytes_per_token,
    kv_cache_state_bytes_per_seq,
    zeros_cache,
)

# Published peaks of one H100 SXM at its full power limit (NVIDIA's data sheet):
# the one definition the kernels' cost formulas and the dry-run read
HBM_BYTES_PER_S, BF16_FLOPS, F32_FLOPS = kcost.HBM_BYTES_PER_S, kcost.BF16_FLOPS, kcost.F32_FLOPS

# Kernel and plain version both keep f32 inside and start from the same inputs,
# so they differ by the order of their sums and by a few ulp of expf/rsqrtf
# (f32: 2e-5), and after the one rounding of the output to bf16 by at most an
# ulp or two of bf16 at the outputs' size (bf16: 2e-2).  Both are the
# tolerances the reference's own kernel tests use, as atol and rtol together.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# WKV-6: the kernel runs the sequential recurrence, the plain version the
# chunked form, which rescales by exp(+-cumulative log decay) within a chunk;
# in f32 they part by more than a few ulp.  2e-4 is the reference's own
# tolerance for its kernel against the sequential oracle; bf16 outputs add one
# rounding.  The final state is f32 in both and is held at 2e-4.
WKV_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}

# GPT-A logits under random weights are O(1..8); one bf16 ulp there is up to
# 0.03, and 24 layers of bf16 activations let the two paths' rounding part ways
# by a few ulps, no more.
PARITY_TOL = 0.25
# RWKV-6 7B does not allow that reasoning in bf16: a one-ulp difference
# anywhere is carried by the recurrence along the 512 tokens and grows through
# the 32 layers to O(1) in the logits.  Two plain paths that differ only in the
# order of their sums (chunks of 128 and of 64) part by 1.98 at logits of 6, and
# the kernel path by 1.92 (experiments/torch_rwkv_parity.py on an H100).  So
# the bf16 kernel path is held against that control: it may part from the plain
# path by at most twice what the control parts by, plus GPT-A's 0.25 (logits)
# or 0.05 of the largest entry (wkv state).  The comparison that finds a fault
# is made in f32 on the same weights, where a rounding is 2**-24: there the two
# paths part by 9.0e-4 on the logits and 1.7e-4 of the last layer's largest
# state entry (the same script), held at 1e-2 and 2e-3.
RWKV_F32_TOL = {"logits": 1e-2, "state_rel": 2e-3}
RWKV_BF16_SLACK = {"logits": PARITY_TOL, "state_rel": 0.05}
RWKV_STATE_BYTES = 34_078_720  # a sequence: wkv 32 x 64 x 64 x 64 f32, two shifts 32 x 4096 bf16

# The backward kernels against their plain versions and against autograd
# through the plain forward: f32 sums over up to 2048 rows (dscale) or 512 x G
# terms (dk, dv) in another order, hence 1e-4; bf16 one rounding of each output.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the log-sum-exp is f32 whatever the inputs: the forward's sums in another order
LSE_TOL = {torch.float32: 2e-5}

# Training: GPT-A at full width, its depth cut so that f32 parameters,
# gradients and two f32 moments fit on one card
TRAIN_LAYERS = 8
TRAIN_REDUCED = {"num_layers": "24 -> 8", "why": "83.9 GB of f32 parameters, gradients and moments at full depth"}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 512
# Not the launcher's default 3e-3: at this width it diverges.  Adam's first
# steps move every weight by about lr whatever its gradient's size, so a block
# of fan-in 16384 changes its output by about lr x 16384 of its own size, and
# 8 such blocks turn the residual stream round: one step at 1e-5 takes the
# same batch's loss from 11.57 to 20.5, on the plain path as on the kernel
# path.  3e-6 is the largest of experiments/torch_train.py's sweep (3e-3 ...
# 1e-6) whose 8 losses all stay below step 0's.
TRAIN_LR = 3e-6


def train_owed(norms: int, attns: int, wkvs: int = 0, remat: bool = True) -> dict:
    """Kernel launches a train step owes with remat="full", counted from the
    code: ``norms``, ``attns`` and ``wkvs`` are the RMSNorms, attentions and
    WKV-6 recurrences of one forward inside the rematerialised blocks, each of
    which runs twice (the loss, then the recomputation in the backward; once
    with ``remat`` False, the configs' remat="none"); the final norm, outside
    them, once; the backward launches once for each of those, and K4's
    backward takes its chunked route every time (bf16 at head size 64, T of at
    least its threshold).  The decode kernel is not on the path."""
    k = 2 if remat else 1
    return {"rmsnorm": k * norms + 1, "rmsnorm_bwd": norms + 1, "flash_attention": k * attns,
            "flash_attention_bwd": attns, "decode_attention": 0, "wkv6": k * wkvs, "wkv6_bwd": wkvs,
            "wkv6_bwd_chunk": wkvs, "sdpa_masked_calls": 0}


# GPT-A: two norms and one attention a block
TRAIN_LAUNCHES_PER_STEP = train_owed(2 * TRAIN_LAYERS, TRAIN_LAYERS)
# One step's loss and gradients, kernel path against plain path on the same
# weights and batch.  bf16 at 8 layers: the two paths round their bf16
# activations alike but sum in other orders, and 8 layers of backward carry
# that into every leaf.  f32 at 2 layers: only the order of f32 sums differs.
TRAIN_PARITY_TOL = {"bf16": {"loss_rel": 1e-2, "grad_rel": 5e-2}, "f32": {"loss_rel": 1e-4, "grad_rel": 1e-3}}

# HuBERT-XLarge (48 x 1280, 16 heads of 80, non-causal) and Zamba2-2.7B (54
# layers: 9 groups of 5 Mamba2 layers and the shared block, 32 heads of 80,
# causal) trained at full width and full depth, 8 steps of 4 x seq, f32
# parameters and moments, bf16 activations, remat="full", nothing cut.
# HuBERT: 48 blocks of two norms and one attention (193 / 97 / 96 / 48 a step).
# Zamba2: a group owes two norms a Mamba2 layer (``ln`` and the gated norm over
# d_inner 5120) and the shared block's two norms and one attention (217 / 109
# / 18 / 9 a step).  Mamba2's SSD trains through autograd of the plain torch.
HUBERT_TRAIN_SEQ, HYBRID_TRAIN_SEQ = 1024, 512
HUBERT_TRAIN_OWED = train_owed(2 * 48, 48)
HYBRID_TRAIN_OWED = train_owed(9 * (2 * 5 + 2), 9)
# The learning rates: the largest of experiments/torch_train.py's sweep (3e-3
# ... 1e-6, --arch hubert_xlarge --seq 1024 and --arch zamba2_2p7b) whose 8
# losses all stay below step 0's, as GPT-A's was chosen.  HuBERT: 3e-3 and 1e-3
# diverge (step 3 at 1e-3 reads 10.0 from 6.50), 1e-4 rises at step 1 (6.54)
# and falls after, 1e-5 falls at every step (6.496 -> 6.279).  Zamba2: 3e-3 ...
# 1e-4 jump at steps 1-2 (18.7, 16.5, 13.7 from 10.99), 1e-5 falls at every
# step (10.99 -> 9.52).  Measured on one NVIDIA H100 80GB HBM3, 700 W.
HUBERT_TRAIN_LR = 1e-5
HYBRID_TRAIN_LR = 1e-5
# Zamba2's bf16 gradients against the plain path: GPT-A's bf16 tolerances
# first; a miss of grad_rel is held leaf by leaf against the control of its
# serving parity (HYBRID_CONTROL: the plain path with the SSD in chunks of 64),
# each leaf at twice the control's gap on that leaf plus GPT-A's 5e-2, and never
# above HYBRID_GRAD_CAP: a zeroed or doubled gradient reads 1.0 and a halved one
# 0.5, so a limit near 1 would let a wrong backward pass.  The control's
# readings are reported beside the result.
HYBRID_GRAD_SLACK = TRAIN_PARITY_TOL["bf16"]["grad_rel"]
HYBRID_GRAD_CAP = 0.4

# RWKV-6 7B trained at full width (32 x 4096, d_ff 14336, vocabulary 65536, 64
# WKV heads of 64) with 8 of its 32 layers, 8 steps of 4 x 512, f32 parameters
# and moments, bf16 activations, remat="full": a block owes two norms and one
# WKV-6 recurrence, each forward twice (33 / 17 norms, 16 WKV-6 forward and 8
# backward launches a step, all 8 on K4 bwd's chunked route).  Its f32 comparison at 2 layers is held at
# TRAIN_PARITY_TOL; its bf16 one at 8 layers as Zamba2's, leaf by leaf against
# the control of its serving parity (the plain path with the WKV in chunks of
# 64 against the config's 128) where GPT-A's 5e-2 misses.
RWKV_TRAIN_LAYERS = 8
RWKV_TRAIN_REDUCED = {"num_layers": "32 -> 8", "why": "7,534,153,728 parameters at 32 layers: 120.5 GB of f32 "
                      "parameters, gradients and moments; 2,286,191,616 at 8: 36.6 GB"}
RWKV_TRAIN_OWED = train_owed(2 * RWKV_TRAIN_LAYERS, 0, wkvs=RWKV_TRAIN_LAYERS)
# the largest of experiments/torch_train.py --arch rwkv6_7b's sweep (3e-3 ... 1e-6)
# whose 8 losses all stay below step 0's: 3e-3 and 1e-3 jump (24.5 and 16.5 from
# 11.91), 1e-4 falls to 9.26 (NVIDIA H100 80GB HBM3, 700 W)
RWKV_TRAIN_LR = 1e-4
RWKV_CONTROL = "plain_chunk64"

# The checkpoint on the card: HuBERT's train phase saves {"params", "opt"}
# (f32 parameters and two f32 moments, 12 B x 945,008,640 = 11.34 GB a save)
# at loop index 4 and after step 7, into a directory .gitignore lists, removed
# at the end of the phase.  The 105.9 GB of host memory and 80.2 GB of free
# disk measured on a one-H100 machine hold both
# saves with room; Zamba2's 24.6 GB a save would too, HuBERT's is the smaller.
CKPT_EVERY = 4
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "local", "chip_smoke_ckpt")

# The MoE family (Qwen1.5-MoE-A2.7B: K1, K2, K3; DeepSeek-V2-Lite: K1, MLA
# plain).  Top-k routing turns a rounding into a jump: one bf16 ulp can decide
# a near-tie of two gates the other way, and the reference's pairing of gate
# weights with expert-sorted slots (ROADMAP Queue 3 (e)), which the port
# mirrors, then moves the weights of the rest of that sequence's slots.  So:
# - the comparison that finds a fault is made in f32, at full width and
#   MOE_F32_LAYERS layers, with the plain path routed as the kernel path routed
#   ("pinned": the two differ only in their continuous arithmetic, which is
#   where the kernels are).  A rounding is 2**-24 there; through 4 layers of
#   sums of at most 2048 terms the logits (O(1) under random weights) part by
#   about 1e-5, held at 1e-3 (RWKV-6's f32 held 1e-2 over a 32-layer
#   recurrence);
# - in bf16 at full depth the pinned plain path is held within GPT-A's
#   PARITY_TOL (GPT-A's reasoning: the same roundings, other orders of sums).
#   Unpinned, the logit gaps and the share of routes that agree are reported
#   and held to nothing: ``experiments/torch_moe_parity.py`` shows plain paths
#   with no kernel (the sums in another order; P rounded to bf16 before P·V,
#   as the flash kernel rounds it) parting from the plain path by up to 1.73
#   and losing about 40 % of their routes by the last layer, so an unpinned gap
#   measures the routing's amplification, not the kernels.  The routing is the
#   same torch code on every path, and a broken kernel fails the pinned
#   comparisons.
MOE_F32_LAYERS = 4
MOE_F32_TOL = {"logits": 1e-3}
MOE_REDUCED = {"num_layers": "24 -> 4 (qwen2-moe-a2.7b), 27 -> 4 (deepseek-v2-lite-16b), the f32 comparison only",
               "why": "57.3 and 64.8 GB of f32 parameters at full depth; served and compared in bf16 at full depth"}
# bf16 ring bytes a token: GPT-A 24 x 2 x 32 x 128 x 2, Qwen 24 x 2 x 16 x 128 x 2,
# DeepSeek's latent 27 x 576 x 2; RWKV-6 keeps a state a sequence instead
KV_BYTES_PER_TOKEN = {"gpt-a": 393_216, "rwkv6-7b": 0, "qwen2-moe-a2.7b": 196_608, "deepseek-v2-lite-16b": 31_104,
                      # L x 2 x Hkv x 128 x 2: DeepSeek-Coder 62 x 8, Granite 60 (of 88) x 1, Nemotron 32 x 8, Qwen2-VL 28 x 4
                      "deepseek-coder-33b": 253_952, "granite-34b": 30_720, "nemotron-4-15b": 131_072,
                      "qwen2-vl-7b": 57_344,
                      # Zamba2-2.7B: 9 shared-block invocations x 2 x 32 x 80 x 2
                      "zamba2-2.7b": 92_160}

# Zamba2-2.7B (K1, K2 and K3 at head size 80): a forward owes 2 x 45 norms in the
# Mamba2 layers (``ln`` and the gated norm), 2 x 9 in the shared block and the
# final one; a dense prefill 9 flash launches, a decode step 9 decode launches.
HYBRID_OWED = {"rmsnorm": 109, "flash_attention": 9, "decode_attention": 9}
# its recurrent state a sequence: 45 Mamba2 layers of ssm 80 x 64 x 64 f32 and
# the two convolutions' last 3 inputs (5120 + 128 channels) in bf16
ZAMBA_STATE_BYTES = 60_399_360
# f32 activations on the f32 weights at full depth (8.2 GB fit the card): only
# the order of f32 sums differs, as in the other decoders' f32 comparisons
HYBRID_F32_TOL = {"logits": 1e-3}
# In bf16 Zamba2's 45 Mamba2 layers amplify a rounding as RWKV-6's recurrence
# does: the plain path with the SSD scan in chunks of 64 instead of 128 (f32
# sums in another order, no kernel anywhere) parts from the plain path by more
# than GPT-A's 0.25 at logits of about 4 (experiments/torch_moe_parity.py
# --arch zamba2-2.7b on an H100 shows it and other orders).  So the bf16 kernel
# path is held as RWKV-6's is, against that control: at most twice what the
# control parts by, plus RWKV_BF16_SLACK (logits, and the last Mamba2 layer's
# ssm state over its largest entry); the f32 comparison finds a fault.
HYBRID_CONTROL = "plain_chunk64"

# The rest of the transformer stack: the dense decoders DeepSeek-Coder 33B,
# Granite-34B-Code and Nemotron-4 15B and the VLM Qwen2-VL 7B (K1, K2, K3 at
# groups 7, 48 and 6), weights made directly in bf16, layer by layer; HuBERT-
# XLarge's encoder (K1, and K2 non-causal at head size 80).  Granite does not
# fit one card at its 88 layers (94.50 GB of bf16 parameters, 530,055,098 a
# layer): 60 of them are 64.81 GB.  Every other model runs at full depth.
STACK_DECODERS = (("deepseek_coder_33b", "serve_coder", None), ("granite_34b", "serve_granite", 60),
                  ("nemotron_4_15b", "serve_nemotron", None), ("qwen2_vl_7b", "serve_vl", None))
# the comparison that finds a fault, made in f32 at full width (GPT-A's reasoning
# for the f32 MoE comparison: only the order of f32 sums differs, through a few
# layers of sums of at most d_ff terms; logits O(1) under random weights)
STACK_F32_LAYERS = 2
STACK_F32_TOL = {"logits": 1e-3}
STACK_REDUCED = {"granite-34b": "88 -> 60 layers: 94.50 GB of bf16 parameters at 88, 64.81 GB at 60",
                 "f32 comparison": f"{STACK_F32_LAYERS} layers at full width: the bf16 weights fill the card"}
INIT_PEAK_LIMIT = 70e9  # bytes while DeepSeek-Coder's 66.68 GB of bf16 weights are made
# HuBERT-XLarge: the pipeline's audio batch of 4 x 1024 frames through Model.loss
# and Model.prefill(cache=None), the kernel path against the plain path: bf16
# as GPT-A's parity (logits) and its training parity (the loss, a mean over
# 4096 frames); f32 at full depth, where only the order of f32 sums differs
HUBERT_BATCH, HUBERT_FRAMES = 4, 1024
HUBERT_TOL = {"bf16": {"loss_rel": 1e-2, "logits": PARITY_TOL}, "f32": {"loss_rel": 1e-4, "logits": 1e-3}}

SPIN_CYCLES = 20_000_000  # about 10 ms of the card's clock: see time_ms
MAX_LEN = 1024
MAX_NEW = 16
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# phase 1 and 2
# ---------------------------------------------------------------------------


def phase_env() -> str:
    nvcc = subprocess.run([build.find_nvcc(), "--version"], check=True, capture_output=True, text=True, timeout=60)
    smi = nvidia_smi_line()
    emit({
        "phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-2:], "gpu": smi,
        "capability": list(torch.cuda.get_device_capability(0)),
    })
    return smi


def ptxas_summary(log: str) -> dict:
    """{"kernel<dtype,sizes>": "N registers; spills"} from what ``ptxas -v`` printed."""
    out, fn = {}, "?"
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"(?<=\d)([a-z_]+(?:\d[a-z_]+)?\d*_kernel)I(.+?)EEv", ln)
            sizes = "".join("," + d for d in re.findall(r"L[ib](\d+)E?", m.group(2))) if m else ""
            # the element type: a template argument, or the parameters where the template takes only sizes
            typed = "" if not m else ln[m.end():] if m.group(2).startswith("L") else m.group(2)
            # no type where the kernel takes its arguments in a struct (the attention backward's)
            dtype = "bf16" if "bfloat16" in typed else "" if "Args" in typed else "f32"
            fn = f"{m.group(1)}<{(dtype + sizes).lstrip(',')}>" if m else ln.split("'")[1]
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln:
            out[fn] = ln.split(":", 1)[-1].strip()
        elif "Used" in ln and "registers" in ln:
            out[fn] = (ln.split("Used", 1)[1].split(",")[0].strip() + "; " + out.get(fn, "no spills")).strip()
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load()
    emit({
        "phase": "build", "seconds": round(time.perf_counter() - t0, 2),
        "nvcc_seconds": None if build.build_seconds is None else round(build.build_seconds, 2),
        "sources": sorted(p.name for p in build.CSRC.glob("*.cu")), "ptxas": ptxas_summary(build.build_log),
    })


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version, on the card
# ---------------------------------------------------------------------------


class Checker:
    """Collects the largest absolute difference a kernel showed, per dtype."""

    def __init__(self):
        self.max_err = {}
        self.cases = {}

    def check(self, name: str, case: str, got: torch.Tensor, want: torch.Tensor, tols=TOL) -> None:
        torch.cuda.synchronize()
        tol = tols[got.dtype]
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {case}: {got.shape} {got.dtype} against {want.shape} {want.dtype}")
        g, w = got.float(), want.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name} {case}: the kernel's output is not finite")
        err = (g - w).abs()
        key = (name, str(got.dtype).replace("torch.", ""))
        self.max_err[key] = max(self.max_err.get(key, 0.0), err.max().item())
        self.cases[key] = self.cases.get(key, 0) + 1
        if not (err <= tol + tol * w.abs()).all():
            raise AssertionError(f"{name} {case} {got.dtype}: max abs difference {err.max().item():.3e} exceeds atol=rtol={tol}")


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def check_rmsnorm(ck: Checker, gen) -> None:
    # the last seven walk the register kernel's one-wave grid (one row, a wave
    # and a few rows more, blocks with one row more than others) and give it
    # rows it leaves to the shared-memory kernel (d not a whole number of
    # 16-byte pieces, d past the register tile)
    shapes = [(512, 128), (3, 256, 64), (2, 4, 128, 256), (777, 100), (777, 4096), (64, 8192),
              (4, 512, 4096), (3, 512, 4096), (1, 300, 4096), (4, 1, 4096), (3, 1, 4096), (1, 1, 4096),
              (1, 4096), (131, 4096), (133, 4096), (2049, 4096), (5000, 1024), (37, 4100), (3, 8192),
              (4, 512, 2048), (4, 1, 2048),  # the MoE family's d_model: a prefill's rows and a decode step's
              # the rest of the transformer stack: DeepSeek-Coder's 7168 and Granite's and Nemotron's 6144
              # (past the register kernel's 4096: the shared-memory kernel), Qwen2-VL's 3584 (448 chunks of
              # 16 bytes in bf16, 3.5 a thread: the register kernel masks the last), HuBERT's 1280 frames
              (4, 512, 7168), (4, 1, 7168), (4, 512, 6144), (4, 1, 6144), (4, 512, 3584), (4, 1, 3584),
              (4, 1024, 1280), (3, 1280),
              # Zamba2-2.7B: d_model 2560, and its gated norm's rows of d_inner 5120 (past the register kernel)
              (4, 512, 2560), (4, 1, 2560), (4, 512, 5120), (4, 1, 5120),
              # a pipelined microbatch's data shard: GPT-A's and RWKV-6's 1 or 2 rows of 512, Zamba2's 1,
              # DeepSeek-V2-Lite's 2
              (1, 512, 4096), (2, 512, 4096), (1, 512, 2560), (1, 512, 5120), (2, 512, 2048)]
    for dtype in TOL:
        for shape in shapes:
            x = randn(gen, shape, dtype)
            sc = randn(gen, shape[-1:], torch.float32)
            ck.check("rmsnorm", f"{shape}", kops.rmsnorm(x, sc), rms_mod.rmsnorm_plain(x, sc))
        # a scale that starts off a 16-byte boundary takes the shared-memory kernel
        x = randn(gen, (9, 4096), dtype)
        sc = randn(gen, (4097,), torch.float32)[1:]
        ck.check("rmsnorm", "scale off 16 bytes", kops.rmsnorm(x, sc), rms_mod.rmsnorm_plain(x, sc))


def check_flash(ck: Checker, gen) -> None:
    # (B, T, S, Hq, Hkv, D); the last three hit the tensor-core kernel's edges:
    # exactly one tile, fewer rows than a warp's 16, many tiles with a ragged
    # last one and a group of 4
    shapes = [(2, 128, 128, 4, 4, 64), (2, 128, 128, 8, 2, 64), (2, 128, 128, 6, 1, 32),
              (2, 300, 300, 4, 2, 64), (1, 70, 300, 4, 2, 128), (1, 300, 70, 6, 3, 32),
              (4, 512, 512, 32, 32, 128), (1, 300, 300, 32, 32, 128),
              (2, 64, 64, 8, 8, 128), (2, 17, 17, 8, 8, 128), (1, 1000, 1000, 4, 1, 128),
              (4, 512, 512, 16, 16, 128),  # Qwen1.5-MoE's prefill: 16 heads of 128
              # the decoders' groups: DeepSeek-Coder 56/8 and Qwen2-VL 28/4 (7), Granite 48/1 (MQA, 48),
              # Nemotron 48/8 (6); then head size 80 (HuBERT-XLarge 16/16 over 1024 frames), ragged
              (4, 512, 512, 56, 8, 128), (4, 512, 512, 48, 1, 128), (4, 512, 512, 48, 8, 128),
              (4, 512, 512, 28, 4, 128), (4, 1024, 1024, 16, 16, 80), (1, 300, 300, 16, 16, 80),
              (2, 17, 17, 4, 4, 80), (1, 70, 300, 4, 2, 80), (1, 300, 70, 6, 3, 80),
              (4, 512, 512, 32, 32, 80),  # Zamba2-2.7B's shared block: a prefill of 4 x 512, 32 heads of 80
              (4, 512, 512, 16, 16, 80),  # its tensor-parallel rank's 16 heads (phase train_tp_recurrent)
              (1, 512, 512, 16, 16, 80)]  # the same rank's microbatch in the pipeline's stages
    for dtype in TOL:
        for B, T, S, Hq, Hkv, D in shapes:
            for causal in (True, False):
                q = randn(gen, (B, T, Hq, D), dtype)
                k = randn(gen, (B, S, Hkv, D), dtype)
                v = randn(gen, (B, S, Hkv, D), dtype)
                ck.check("flash_attention", f"{(B, T, S, Hq, Hkv, D)} causal={causal}",
                         kops.flash_attention(q, k, v, causal=causal),
                         fa_mod.flash_attention_plain(q, k, v, causal=causal))
        # inputs that are views: heads-first storage read through strides, and a slice in time
        q = randn(gen, (2, 4, 200, 64), dtype).transpose(1, 2)
        k = randn(gen, (2, 2, 200, 64), dtype).transpose(1, 2)
        v = randn(gen, (2, 260, 2, 64), dtype)[:, -200:]
        ck.check("flash_attention", "strided views", kops.flash_attention(q, k, v, causal=True),
                 fa_mod.flash_attention_plain(q, k, v, causal=True))
        q = randn(gen, (2, 4, 200, 80), dtype).transpose(1, 2)
        k = randn(gen, (2, 4, 200, 80), dtype).transpose(1, 2)
        v = randn(gen, (2, 260, 4, 80), dtype)[:, -200:]
        ck.check("flash_attention", "strided views D 80", kops.flash_attention(q, k, v, causal=False),
                 fa_mod.flash_attention_plain(q, k, v, causal=False))


def autograd_plain(fn, inputs, dout):
    """torch.autograd of the plain forward ``fn`` at ``inputs`` against ``dout``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        return torch.autograd.grad(fn(*leaves), leaves, dout)


def rmsnorm_bwd_wave(d: int, dtype: torch.dtype) -> int:
    """Rows of d the backward's register kernel takes in one wave of its grid:
    the most rows for which ``bwd_grid`` gives every row its own block."""
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if rms_mod.bwd_grid(mid, d, dtype, 1)[0] == mid else (lo, mid - 1)
    return lo


def rmsnorm_bwd_plan(n: int, d: int, dtype: torch.dtype, vec: int = 1) -> dict:
    """The backward's first kernel for n rows of d, its grid and the bytes of
    dscale partials it writes (and the reduction reads back)."""
    blocks, threads = rms_mod.bwd_grid(n, d, dtype, vec)
    t = "bf16" if dtype == torch.bfloat16 else "f32"
    name = f"rmsnorm_bwd_reg_kernel<{t},{threads}>" if threads else f"rmsnorm_bwd_kernel<{t}>"
    return {"kernel": name, "blocks": blocks, "threads": threads, "partial_bytes": blocks * d * 4}


def check_rmsnorm_bwd(ck: Checker, gen) -> None:
    # GPT-A's training rows and a decode step's (4 rows), a wave and a few
    # rows more, rows that are not a whole number of 16-byte chunks (100 and
    # 4100 in bf16, 4097 in both), a long row, and a scale off 16 bytes; then
    # the register kernel's edges: rows just below, at and one past its wave
    # at d 4096, Minitron-4B's 3072 (the last chunk of every thread empty), and
    # 2048 and 1024 (64 and 32 threads in bf16); then the rows HuBERT-XLarge
    # and Zamba2-2.7B train at: 4 x 1024 frames of 1280, 4 x 512 of 2560, and
    # Zamba2's gated norm over 5120 (``rmsnorm_bwd_kernel``: past 4096); last
    # the rows of a pipelined microbatch's data shard (GPT-A 512 or 1024,
    # Zamba2 512, DeepSeek-V2-Lite 1024 of 2048)
    shapes = [(2048, 4096), (4, 4096), (4, 512, 4096), (1, 4096), (2049, 4096), (777, 100), (37, 4100),
              (33, 4097), (64, 8192), (5000, 1024), (2048, 3072), (777, 2048), (1000, 1024), (3, 1024),
              (4096, 1280), (2048, 2560), (2048, 5120), (512, 4096), (1024, 4096), (512, 2560), (512, 5120),
              (1024, 2048)]
    for dtype in BWD_TOL:
        wave = rmsnorm_bwd_wave(4096, dtype)
        edges = [(wave - 1, 4096), (wave, 4096), (wave + 1, 4096)]
        cases = [(randn(gen, sh, dtype), randn(gen, sh[-1:], torch.float32), f"{sh}") for sh in shapes + edges]
        cases.append((randn(gen, (9, 4096), dtype), randn(gen, (4097,), torch.float32)[1:], "scale off 16 bytes"))
        for x, sc, label in cases:
            dy = randn(gen, x.shape, dtype)
            d = x.shape[-1]
            dx, dscale = rms_mod.rmsnorm_bwd_rows(x.reshape(-1, d), sc, dy.reshape(-1, d))
            want_dx, want_dscale = rms_mod.rmsnorm_bwd_plain(x, sc, dy)
            ck.check("rmsnorm_bwd", f"{label} dx", dx.reshape(x.shape), want_dx, BWD_TOL)
            ck.check("rmsnorm_bwd.dscale", f"{label} dscale {dtype}", dscale, want_dscale, BWD_TOL)
            ag_dx, ag_dscale = autograd_plain(rms_mod.rmsnorm_plain, (x, sc), dy)
            ck.check("rmsnorm_bwd", f"{label} dx against autograd", dx.reshape(x.shape), ag_dx, BWD_TOL)
            ck.check("rmsnorm_bwd.dscale", f"{label} dscale against autograd {dtype}", dscale, ag_dscale, BWD_TOL)
        # the two kernels' results do not depend on the run: no float atomics
        x, sc, _ = cases[0]
        dy = randn(gen, x.shape, dtype)
        a, b = rms_mod.rmsnorm_bwd_rows(x, sc, dy), rms_mod.rmsnorm_bwd_rows(x, sc, dy)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError("rmsnorm_bwd: two runs on the same inputs differ")
        # through the Function, as the model calls it
        xg, scg = x.clone().requires_grad_(True), sc.clone().requires_grad_(True)
        with torch.enable_grad():
            gx, gs = torch.autograd.grad(kops.rmsnorm(xg, scg), (xg, scg), dy)
        ck.check("rmsnorm_bwd", "RMSNormFn dx", gx, a[0], BWD_TOL)
        ck.check("rmsnorm_bwd.dscale", f"RMSNormFn dscale {dtype}", gs, a[1], BWD_TOL)
    check_rmsnorm_bwd_grid()


def check_rmsnorm_bwd_grid() -> None:
    """The dry-run's grid of the backward (``bwd_grid_at``: csrc's arithmetic
    on ``BWD_BLOCKS_PER_SM``) is the card's (``bwd_grid``) at this card's SMs,
    for every kernel and block size the backward takes, at rows below, at and
    past a wave."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases, wrong, per_sm = 0, [], {}
    for dtype in (torch.bfloat16, torch.float32):
        for d in (512, 1024, 2048, 2560, 4096, 5120):
            for vec in (0, 1):
                for n in (1, 4, 511, 512, 2048, 2049, 4096, 10**6):
                    card, meta = rms_mod.bwd_grid(n, d, dtype, vec), rms_mod.bwd_grid_at(n, d, dtype, vec, sms)
                    cases += 1
                    if card != meta:
                        wrong.append({"n": n, "d": d, "dtype": str(dtype), "vec": vec, "card": card, "meta": meta})
                key = f"{dtype}, {rms_mod.bwd_threads(d, dtype, vec)}"
                per_sm[key] = -(-rms_mod.bwd_grid(sms * 64, d, dtype, vec)[0] // sms)  # a wave's blocks an SM
    emit({"check": "rmsnorm_bwd_grid", "sms": sms, "cases": cases, "card_blocks_per_sm": per_sm, "wrong": wrong})
    if wrong:
        raise AssertionError(f"rmsnorm_bwd: the dry-run's grid is not the card's: {wrong[:8]}")


def check_flash_bwd(ck: Checker, gen) -> None:
    # (B, T, S, Hq, Hkv, D, causal): GPT-A's training shape, MHA and GQA
    # (Minitron-4B's 24/8, the smoke's 4/2), ragged T = S (77, 300, 512), T != S
    # (full, both ways) and D 32, 64 and 128; then head size 80: HuBERT-XLarge's
    # encoder (4 x 1024 frames, 16 heads, non-causal), a ragged causal group of
    # 3 and a T != S, and Zamba2-2.7B's shared block (4 x 512, 32 heads, causal);
    # then a pipelined microbatch's data shard: GPT-A's 1 or 2 rows, Zamba2's 1;
    # last a tensor-parallel GPT-A rank's 16 of the 32 heads (phase train_tp), a
    # tensor-parallel Zamba2 rank's 16 of the 32 heads of 80 (phase train_tp_recurrent)
    # and its microbatch of one row in the pipeline's stages
    cases = [(4, 512, 512, 32, 32, 128, True), (2, 77, 77, 4, 2, 64, True), (2, 77, 77, 4, 2, 64, False),
             (1, 300, 300, 24, 8, 128, True), (1, 300, 300, 24, 8, 128, False), (2, 512, 512, 4, 2, 64, True),
             (1, 512, 512, 8, 8, 128, False), (1, 70, 300, 4, 2, 128, False), (1, 300, 70, 6, 3, 64, False),
             (2, 128, 128, 6, 1, 32, True), (2, 17, 17, 8, 8, 128, True),
             (4, 1024, 1024, 16, 16, 80, False), (2, 200, 200, 6, 2, 80, True), (1, 150, 260, 4, 4, 80, False),
             (4, 512, 512, 32, 32, 80, True),
             (1, 512, 512, 32, 32, 128, True), (2, 512, 512, 32, 32, 128, True), (1, 512, 512, 32, 32, 80, True),
             (4, 512, 512, 16, 16, 128, True), (4, 512, 512, 16, 16, 80, True), (1, 512, 512, 16, 16, 80, True)]
    for dtype in BWD_TOL:
        for B, T, S, Hq, Hkv, D, causal in cases:
            q, do = randn(gen, (B, T, Hq, D), dtype), randn(gen, (B, T, Hq, D), dtype)
            k, v = randn(gen, (B, S, Hkv, D), dtype), randn(gen, (B, S, Hkv, D), dtype)
            flash_bwd_case(ck, f"{(B, T, S, Hq, Hkv, D)} causal={causal}", q, k, v, do, causal)
        # every output tile has one owner and nothing is added with atomics: two runs give the same bits
        for B, T, S, Hq, Hkv, D, causal in (cases[0], cases[11], cases[12]):
            q, do = randn(gen, (B, T, Hq, D), dtype), randn(gen, (B, T, Hq, D), dtype)
            k, v = randn(gen, (B, S, Hkv, D), dtype), randn(gen, (B, S, Hkv, D), dtype)
            o, lse = fa_mod.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
            runs = [fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal) for _ in range(2)]
            if not all(torch.equal(x, y) for x, y in zip(*runs)):
                raise AssertionError(f"flash_attention_bwd {(B, T, S, Hq, Hkv, D)} {dtype}: two runs differ")
        # views: heads-first storage read through strides, a slice in time, a strided dO
        q = randn(gen, (2, 4, 200, 64), dtype).transpose(1, 2)
        k = randn(gen, (2, 2, 200, 64), dtype).transpose(1, 2)
        v = randn(gen, (2, 260, 2, 64), dtype)[:, -200:]
        do = randn(gen, (2, 4, 200, 64), dtype).transpose(1, 2)
        flash_bwd_case(ck, "strided views", q, k, v, do, True)


def flash_bwd_case(ck: Checker, case: str, q, k, v, do, causal: bool) -> None:
    """The LSE-writing forward against the plain forward; the backward kernels
    against the plain backward on the same q, k, v, o, lse and dO, and against
    autograd through the plain forward; then the Function, as the model calls it."""
    o, lse = fa_mod.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    o_p, lse_p = fa_mod.flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    ck.check("flash_attention", f"{case} with lse", o, o_p)
    ck.check("flash_attention.lse", f"{case} {q.dtype}", lse, lse_p, LSE_TOL)
    grads = fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
    want = fa_mod.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    ag = autograd_plain(lambda a, b, c: fa_mod.flash_attention_plain(a, b, c, causal=causal), (q, k, v), do)
    for name, got, w, a in zip(("dq", "dk", "dv"), grads, want, ag):
        ck.check("flash_attention_bwd", f"{case} {name}", got, w, BWD_TOL)
        ck.check("flash_attention_bwd", f"{case} {name} against autograd", got, a, BWD_TOL)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        fn_grads = torch.autograd.grad(kops.flash_attention(*leaves, causal=causal), leaves, do)
    for name, got, w in zip(("dq", "dk", "dv"), fn_grads, grads):
        ck.check("flash_attention_bwd", f"{case} FlashAttentionFn {name}", got, w, BWD_TOL)


def ring_positions(gen, B: int, S: int, kind: str):
    """kv_pos (B, S) and q_pos (B, 1), int32, on the card."""
    ar = torch.arange(S, device="cuda", dtype=torch.int32)[None].expand(B, S)
    if kind == "tail-empty":  # the reference's sweep: the last 37 slots empty, three more in the future
        return torch.where(ar < S - 37, ar, -1).contiguous(), torch.full((B, 1), S - 40, device="cuda", dtype=torch.int32)
    if kind == "shuffled":  # a ring that has wrapped: positions in any slot order, some slots empty
        perm = torch.stack([torch.randperm(S, generator=gen, device="cuda") for _ in range(B)]).to(torch.int32)
        kv = torch.where(perm % 7 == 3, -1, perm + 100)
        return kv.contiguous(), torch.full((B, 1), 100 + (2 * S) // 3, device="cuda", dtype=torch.int32)
    if kind == "no-valid":  # row 0 all empty, row 1 all in the future, the rest ordinary
        kv = ar.clone()
        kv[0] = -1
        qp = torch.full((B, 1), S // 2, device="cuda", dtype=torch.int32)
        if B > 1:
            kv[1] = ar[1] + 10_000
        return kv.contiguous(), qp
    if kind == "one-valid":  # slot 0 alone holds a position: every other tile of the ring is skipped
        kv = torch.where(ar == 0, ar, -1)
        return kv.contiguous(), torch.full((B, 1), S // 2, device="cuda", dtype=torch.int32)
    if kind == "full":  # every slot filled, the query at the newest (with a window: a band at the end)
        return ar.contiguous(), torch.full((B, 1), S - 1, device="cuda", dtype=torch.int32)
    if kind == "gaps":  # whole empty tiles in the middle: tiles 2-5 and 9-12 of 64 slots
        tile = ar // 64
        kv = torch.where(((tile >= 2) & (tile < 6)) | ((tile >= 9) & (tile < 13)), -1, ar)
        return kv.contiguous(), torch.full((B, 1), S - 1, device="cuda", dtype=torch.int32)
    raise ValueError(kind)


def check_decode(ck: Checker, gen) -> None:
    # (B, S, Hq, Hkv, D, window, positions); the last five skip whole tiles,
    # and the two of 4096 slots give the slices of split_plan several tiles
    cases = [(3, 256, 4, 4, 64, None, "tail-empty"), (3, 256, 8, 2, 64, 128, "tail-empty"),
             (3, 256, 4, 1, 32, 64, "tail-empty"), (3, 1000, 8, 2, 64, None, "tail-empty"),
             (3, 1000, 6, 1, 128, 300, "shuffled"), (2, 256, 4, 4, 64, None, "shuffled"),
             (3, 256, 4, 2, 64, None, "no-valid"), (3, 1000, 32, 32, 128, None, "no-valid"),
             (4, 1024, 32, 32, 128, None, "tail-empty"), (1, 1024, 32, 32, 128, None, "shuffled"),
             (3, 1024, 32, 32, 128, None, "tail-empty"),
             (2, 4096, 32, 32, 128, None, "tail-empty"), (2, 4096, 32, 4, 128, None, "shuffled"),
             (3, 1024, 32, 32, 128, None, "one-valid"), (2, 1024, 32, 32, 128, 300, "full"),
             (2, 1024, 8, 2, 64, None, "gaps"), (4, 1024, 16, 16, 128, None, "tail-empty"),  # Qwen1.5-MoE
             # the decoders' groups: 7 (DeepSeek-Coder, Qwen2-VL: one head of the block's 8 idle), 48
             # (Granite: six blocks a kv head), 6 (Nemotron), with windows over a wrapped and a full ring
             (4, 1024, 56, 8, 128, None, "tail-empty"), (4, 1024, 48, 1, 128, None, "tail-empty"),
             (4, 1024, 48, 8, 128, None, "shuffled"), (4, 1024, 28, 4, 128, None, "tail-empty"),
             (4, 1024, 56, 8, 128, 300, "full"), (2, 1024, 48, 1, 128, 200, "shuffled"),
             (3, 1024, 28, 4, 128, 64, "shuffled"),
             # head size 80 (Zamba2-2.7B's shared block, 32/32): its step, a ring of 4096 whose slices
             # get several tiles, a ragged shuffled ring, a window over a full ring, the kinds with no,
             # one and gapped valid slots, and groups of 2, 4 and 8 (the reference takes any group)
             (4, 1024, 32, 32, 80, None, "tail-empty"), (2, 4096, 32, 32, 80, None, "tail-empty"),
             (3, 1000, 32, 32, 80, None, "shuffled"), (2, 1024, 32, 32, 80, 300, "full"),
             (3, 1024, 32, 32, 80, None, "no-valid"), (3, 1024, 32, 32, 80, None, "one-valid"),
             (2, 1024, 32, 32, 80, None, "gaps"), (2, 1024, 8, 4, 80, None, "tail-empty"),
             (2, 1024, 16, 4, 80, None, "shuffled"), (2, 1000, 16, 2, 80, 300, "shuffled")]
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, Hq, Hkv, D, window, kind in cases:
        if S == 4096 and dec_mod.split_plan(B, Hkv, S, sm_count)[1] < 2:
            raise AssertionError(f"decode_attention {(B, S, Hq, Hkv, D)}: the plan gives its slices one tile")
    for dtype in TOL:
        for B, S, Hq, Hkv, D, window, kind in cases:
            q = randn(gen, (B, 1, Hq, D), dtype)
            k = randn(gen, (B, S, Hkv, D), dtype)
            v = randn(gen, (B, S, Hkv, D), dtype)
            kv_pos, q_pos = ring_positions(gen, B, S, kind)
            ck.check("decode_attention", f"{(B, S, Hq, Hkv, D)} window={window} {kind}",
                     kops.decode_attention(q, k, v, q_pos, kv_pos, window=window),
                     dec_mod.decode_attention_plain(q, k, v, q_pos, kv_pos, window=window))
    # a head size without a template raises on the card: there is no fall-back
    q, k = randn(gen, (2, 1, 4, 48), torch.bfloat16), randn(gen, (2, 256, 4, 48), torch.bfloat16)
    kv_pos, q_pos = ring_positions(gen, 2, 256, "full")
    try:
        kops.decode_attention(q, k, k, q_pos, kv_pos)
    except ValueError as e:
        if "head size 48" not in str(e):
            raise
    else:
        raise AssertionError("decode_attention took head size 48")


def wkv_inputs(gen, B, T, H, D, dtype, state: bool):
    """The reference test's distributions (tests/test_kernels.py): r, k, v ~
    N(0, 0.25) in ``dtype``, logw = -exp(N(0, 0.25) - 2) and u ~ N(0, 0.01) in
    f32; a state ~ N(0, 0.25) or zeros."""
    r, k, v = (randn(gen, (B, T, H, D), torch.float32).mul_(0.5).to(dtype) for _ in range(3))
    logw = -torch.exp(randn(gen, (B, T, H, D), torch.float32) * 0.5 - 2.0)
    u = randn(gen, (H, D), torch.float32) * 0.1
    S0 = randn(gen, (B, H, D, D), torch.float32) * 0.5 if state else torch.zeros((B, H, D, D), device="cuda")
    return r, k, v, logw, u, S0


def wkv6_sequential(r, k, v, logw, u, S0):
    """The recurrence one step at a time in f32 torch: (y in r's dtype, final state)."""
    S = S0.float().clone()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = r[:, t].float(), k[:, t].float(), v[:, t].float()
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhd,bhde->bhe", rt, S + u[None, :, :, None] * kv))
        S = S * torch.exp(logw[:, t])[..., None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), S


def check_wkv6(ck: Checker, gen) -> None:
    # (B, T, H, D): the reference's sweep, ragged T, the full-width prefill and
    # decode step; then T on both sides of the chunked kernel's CHUNKED_T_MIN and
    # of its chunks of 64 (bf16 at D 64 takes it, f32 the sequential kernel)
    t_min = wkv_mod.CHUNKED_T_MIN
    shapes = [(2, 128, 2, 64), (2, 96, 4, 32), (2, 128, 1, 64),
              (2, 1, 2, 64), (2, 31, 2, 64), (3, 100, 2, 32), (1, 300, 3, 64),
              (4, 512, 64, 64), (4, 1, 64, 64), (4, 512, 32, 64),  # the last a tensor-parallel rank's 32 heads
              (2, 512, 32, 64),  # and its microbatch in the pipeline's stages
              (2, t_min - 1, 2, 64), (2, t_min, 2, 64), (2, 63, 2, 64), (2, 64, 2, 64), (2, 65, 2, 64),
              (2, 129, 2, 64), (2, 300, 2, 64)]
    for dtype in WKV_TOL:
        for B, T, H, D in shapes:
            for state in (False, True):
                r, k, v, logw, u, S0 = wkv_inputs(gen, B, T, H, D, dtype, state)
                case = f"{(B, T, H, D)} S0={'random' if state else 'zero'}"
                y_p, S_p = wkv_mod.wkv6_plain(r, k, v, logw, u, S0)
                S = S0.clone()
                y = kops.wkv6(r, k, v, logw, u, S)
                ck.check("wkv6", case, y, y_p, WKV_TOL)
                ck.check("wkv6.state", f"{case} {dtype}", S, S_p, WKV_TOL)
        # inputs that are views: heads-first storage read through strides, logw a
        # slice in time; then logw rows off 16 bytes (the sequential kernel)
        B, T, H, D = 2, 70, 3, 64
        r, k, v, _, u, S0 = wkv_inputs(gen, B, T, H, D, dtype, True)
        r = r.transpose(1, 2).contiguous().transpose(1, 2)
        logw = -torch.exp(randn(gen, (B, T + 9, H, D), torch.float32) * 0.5 - 2.0)[:, 9:]
        odd = -torch.exp(randn(gen, (B, T, H, D + 1), torch.float32) * 0.5 - 2.0)[..., 1:]
        for label, lw in (("strided views", logw), ("rows off 16 bytes", odd)):
            y_p, S_p = wkv_mod.wkv6_plain(r, k, v, lw, u, S0)
            S = S0.clone()
            ck.check("wkv6", label, kops.wkv6(r, k, v, lw, u, S), y_p, WKV_TOL)
            ck.check("wkv6.state", f"{label} {dtype}", S, S_p, WKV_TOL)
        # strong decay, about -7 a step and -470 a chunk: exp(-L) of the chunked
        # plain form overflows, so the kernel is held against the recurrence
        for B, T, H, D in ((2, 129, 2, 64), (1, 300, 3, 64)):
            r, k, v, _, u, S0 = wkv_inputs(gen, B, T, H, D, dtype, True)
            logw = -torch.exp(randn(gen, (B, T, H, D), torch.float32) * 0.5 + 2.0)
            y_s, S_s = wkv6_sequential(r, k, v, logw, u, S0)
            S = S0.clone()
            case = f"{(B, T, H, D)} strong decay"
            ck.check("wkv6", case, kops.wkv6(r, k, v, logw, u, S), y_s, WKV_TOL)
            ck.check("wkv6.state", f"{case} {dtype}", S, S_s, WKV_TOL)


@contextlib.contextmanager
def bwd_route(chunked: bool):
    """K4's backward forced onto one route through its threshold: the chunked
    route wherever it takes the input (bf16, head size 64, rows aligned), or
    the sequential passes everywhere."""
    t_min = wkv_mod.CHUNKED_BWD_T_MIN
    wkv_mod.CHUNKED_BWD_T_MIN = 1 if chunked else 1 << 30
    try:
        yield
    finally:
        wkv_mod.CHUNKED_BWD_T_MIN = t_min


BWD_ROUTES = (("chunked", True), ("sequential", False))


def check_wkv6_bwd(ck: Checker, gen) -> None:
    """K4's backward (``wkv6_bwd_cuda``, from a zero state) against
    ``wkv6_bwd_plain`` on the same inputs and dy, each case on both routes
    (forced through the threshold; f32 and head size 32 have only the
    sequential one): the reference's sweep, ragged T around the chunks of 64
    and the threshold, RWKV-6 7B's training shape (4 x 512, 64 heads of 64)
    and a tensor-parallel rank's (32 heads),
    strided views; then strong decay against autograd through the recurrence
    (``wkv6_sequential``), where the chunked plain form overflows; two runs bit
    for bit; the threshold's own choice on both sides of it; and ``WKV6Fn``
    through ``ops.wkv6``, as the model calls it.  dr, dk, dv in the inputs'
    type under "wkv6_bwd", dlogw and du (f32 whatever the inputs) under
    "wkv6_bwd.f32"."""
    t_min = wkv_mod.CHUNKED_BWD_T_MIN
    shapes = [(2, 128, 2, 64), (2, 96, 4, 32), (2, 128, 1, 64),
              (2, 1, 2, 64), (2, 31, 2, 64), (2, 63, 2, 64), (2, 64, 2, 64), (2, 65, 2, 64), (2, 129, 2, 64),
              (2, max(t_min - 1, 1), 2, 64), (2, t_min, 2, 64), (1, 300, 3, 64), (3, 100, 2, 32), (4, 512, 64, 64),
              # a tensor-parallel RWKV-6 rank's 32 of the 64 heads: the plain step's, a microbatch in the stages
              (4, 512, 32, 64), (2, 512, 32, 64)]

    def hold(case, got, want):
        for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
            key = "wkv6_bwd" if name in ("dr", "dk", "dv") else "wkv6_bwd.f32"
            ck.check(key, f"{case} {name}", g, w, WKV_TOL)

    def routed(case, chunked, *args):
        """wkv6_bwd_cuda(*args) on the forced route, which must be the one it took."""
        before = wkv_mod.bwd_chunk_launches
        r = args[0]
        with bwd_route(chunked):
            got = wkv_mod.wkv6_bwd_cuda(*args)
            takes = wkv_mod.bwd_chunked(r.dtype, r.shape[1], r.shape[3],
                                        all(rows_aligned(t) for t in args[:4] + args[5:]))
        if (wkv_mod.bwd_chunk_launches - before) != int(takes):
            raise AssertionError(f"wkv6_bwd {case}: forced {'chunked' if chunked else 'sequential'}, took the other route")
        return got

    for dtype in WKV_TOL:
        routes = BWD_ROUTES if dtype == torch.bfloat16 else BWD_ROUTES[1:]
        for B, T, H, D in shapes:
            r, k, v, logw, u, _ = wkv_inputs(gen, B, T, H, D, dtype, False)
            dy = randn(gen, (B, T, H, D), dtype)
            want = wkv_mod.wkv6_bwd_plain(r, k, v, logw, u, dy, chunk=64)
            for label, chunked in (routes if D == 64 else BWD_ROUTES[1:]):
                case = f"{(B, T, H, D)} {dtype} {label}"
                hold(case, routed(case, chunked, r, k, v, logw, u, dy), want)
        # views: heads-first storage read through strides, logw a slice in time, dy heads-first
        B, T, H, D = 2, 70, 3, 64
        r, k, v, _, u, _ = wkv_inputs(gen, B, T, H, D, dtype, False)
        r = r.transpose(1, 2).contiguous().transpose(1, 2)
        logw = -torch.exp(randn(gen, (B, T + 9, H, D), torch.float32) * 0.5 - 2.0)[:, 9:]
        dy = randn(gen, (B, H, T, D), dtype).transpose(1, 2)
        want = wkv_mod.wkv6_bwd_plain(r, k, v, logw, u, dy)
        for label, chunked in routes:
            case = f"strided views {dtype} {label}"
            hold(case, routed(case, chunked, r, k, v, logw, u, dy), want)
        # strong decay, about -7 a step: exp(-L) of the chunked plain form overflows
        for B, T, H, D in ((2, 129, 2, 64), (1, 300, 3, 64)):
            r, k, v, _, u, S0 = wkv_inputs(gen, B, T, H, D, dtype, False)
            logw = -torch.exp(randn(gen, (B, T, H, D), torch.float32) * 0.5 + 2.0)
            dy = randn(gen, (B, T, H, D), dtype)
            want = autograd_plain(lambda a, b, c, w, uu: wkv6_sequential(a, b, c, w, uu, S0)[0], (r, k, v, logw, u), dy)
            for label, chunked in routes:
                case = f"{(B, T, H, D)} strong decay {dtype} {label}"
                hold(case, routed(case, chunked, r, k, v, logw, u, dy), want)
        # no atomics: two runs give the same bits, on each route
        r, k, v, logw, u, _ = wkv_inputs(gen, 4, 512, 64, 64, dtype, False)
        dy = randn(gen, r.shape, dtype)
        for label, chunked in routes:
            a, b = routed(label, chunked, r, k, v, logw, u, dy), routed(label, chunked, r, k, v, logw, u, dy)
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"wkv6_bwd {dtype} {label}: two runs on the same inputs differ")
        # the threshold's own choice: T below it the sequential passes, from it on the chunked route
        for T in (max(t_min - 1, 1), t_min):
            rr, kk, vv, ww, uu, _ = wkv_inputs(gen, 2, T, 2, 64, dtype, False)
            before = wkv_mod.bwd_chunk_launches
            wkv_mod.wkv6_bwd_cuda(rr, kk, vv, ww, uu, randn(gen, rr.shape, dtype))
            chunked = wkv_mod.bwd_chunk_launches - before
            if chunked != int(dtype == torch.bfloat16 and T >= t_min):
                raise AssertionError(f"wkv6_bwd {dtype} T={T}: threshold {t_min}, chunked launches {chunked}")
        # then the Function, as the model calls it (the training shape: the chunked route in bf16)
        leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u)]
        with torch.enable_grad():
            y = kops.wkv6(*leaves)
            got = torch.autograd.grad(y, leaves, dy)
        ck.check("wkv6", f"WKV6Fn forward {dtype}", y.detach(), kops.wkv6(r, k, v, logw, u), WKV_TOL)
        hold(f"WKV6Fn {dtype}", got, wkv_mod.wkv6_bwd_cuda(r, k, v, logw, u, dy))


def time_ms(fn, arg_sets, iters: int = 20, reps: int = 7) -> float:
    """Device time of one call: median over ``reps`` rounds of the mean of
    ``iters`` calls between two CUDA events, after a warm-up.  Each round first
    parks the card on a spin kernel of about 10 ms, so that the host has queued
    every call before the first one starts and the events bracket the card's
    work, not the host's launch rate.  The calls walk round ``arg_sets``, whose
    tensors together exceed the L2 cache, so every call finds its inputs in
    device memory, as a layer of the model finds them."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernel_times_ms(fn, arg_sets, iters: int = 20) -> dict:
    """{kernel name: device ms a launch} of the kernels ``fn`` launches, from
    torch.profiler's device time over ``iters`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / iters / 1e3 for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def measure_kernels(gen) -> dict:
    """Times at GPT-A's full-width shapes (bf16): kernel, plain version, the one
    library call that computes the same function, and the card's bound."""
    import torch.nn.functional as F  # timed here as a yardstick; the port never calls it

    dt = torch.bfloat16
    out = {}

    # K1: the prefill's rows, 4 x 512 tokens of d_model 4096; ("decode_") a
    # decode step's 4 rows, which the model hands over warm from the op before;
    # ("moe_") the MoE family's prefill rows, d_model 2048
    for label, N, d, nsets in (("", 4 * 512, 4096, 6), ("decode_", 4, 4096, 8), ("moe_", 4 * 512, 2048, 6)):
        sets = [(randn(gen, (N, d), dt), randn(gen, (d,), torch.float32)) for _ in range(nsets)]
        row = {
            "shape": f"x ({N},{d}) bf16",
            "ms": time_ms(lambda x, s: kops.rmsnorm(x, s), sets),
            "plain_ms": time_ms(lambda x, s: rms_mod.rmsnorm_plain(x, s), sets),
            "library_ms": time_ms(lambda x, s: F.rms_norm(x, (d,), s.to(x.dtype), 1e-6), sets),
            **kcost.bound(rms_mod.fwd_cost(N, d, dt)),
        }
        if label:
            out["rmsnorm"].update({label + key: val for key, val in row.items()})
        else:
            out["rmsnorm"] = row

    # K2: one layer's causal prefill, 4 prompts of 512 tokens, 32 heads of 128;
    # ("long_") one prompt at GPT-A's context of 4096 tokens; ("moe_")
    # Qwen1.5-MoE's prefill, 16 heads of 128
    D = 128
    for label, B, T, H in (("", 4, 512, 32), ("long_", 1, 4096, 32), ("moe_", 4, 512, 16)):
        sets = [tuple(randn(gen, (B, T, H, D), dt) for _ in range(3)) for _ in range(2)]
        row = {
            "shape": f"q,k,v ({B},{T},{H},{D}) bf16 causal",
            "ms": time_ms(lambda q, k, v: kops.flash_attention(q, k, v, causal=True), sets, iters=5),
            "plain_ms": time_ms(lambda q, k, v: fa_mod.flash_attention_plain(q, k, v, causal=True), sets, iters=5),
            "library_ms": time_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True).transpose(1, 2),
                sets, iters=5),
            **kcost.bound(fa_mod.fwd_cost(B, T, T, H, H, D, True, dt)),
        }
        if label:
            out["flash_attention"].update({label + key: val for key, val in row.items()})
        else:
            # the forward as training calls it, writing the log-sum-exp beside o
            row["lse_ms"] = time_ms(lambda q, k, v: fa_mod.flash_attention_cuda(q, k, v, causal=True, return_lse=True),
                                    sets, iters=5)
            out["flash_attention"] = row

    # K3: one layer's decode step, 4 sequences 520 tokens into a ring of 1024;
    # ("full_") the ring full; ("long_") GPT-A's context of 4096 slots, 4000
    # filled; ("moe_") Qwen1.5-MoE's step, 16 heads of 128, 520 of 1024 filled
    D = 128
    for label, B, S, filled, H, nsets in (("", 4, MAX_LEN, 520, 32, 4), ("full_", 4, MAX_LEN, MAX_LEN, 32, 4),
                                          ("long_", 4, 4096, 4000, 32, 2), ("moe_", 4, MAX_LEN, 520, 16, 8)):
        ar = torch.arange(S, device="cuda", dtype=torch.int32)[None].expand(B, S)
        kv_pos = torch.where(ar < filled, ar, -1).contiguous()
        q_pos = torch.full((B, 1), filled - 1, device="cuda", dtype=torch.int32)
        sets = [(randn(gen, (B, 1, H, D), dt), randn(gen, (B, S, H, D), dt), randn(gen, (B, S, H, D), dt), q_pos,
                 kv_pos) for _ in range(nsets)]
        valid = int(((kv_pos >= 0) & (kv_pos <= q_pos)).sum().item())
        mask = ((kv_pos >= 0) & (kv_pos <= q_pos))[:, None, None, :]
        row = {
            "shape": f"q ({B},1,{H},{D}), k,v ({B},{S},{H},{D}) bf16, {filled} of {S} slots valid",
            "ms": time_ms(lambda q, k, v, qp, kp: kops.decode_attention(q, k, v, qp, kp), sets),
            "plain_ms": time_ms(lambda q, k, v, qp, kp: dec_mod.decode_attention_plain(q, k, v, qp, kp), sets),
            "library_ms": time_ms(
                lambda q, k, v, qp, kp: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask).transpose(1, 2),
                sets),
            # what this run's data needs: K and V of the valid slots only, every position, q and o
            **kcost.bound(dec_mod.cost_of(B, S, H, H, D, valid, dt)),
        }
        if label:
            out["decode_attention"].update({label + key: val for key, val in row.items()})
        else:
            out["decode_attention"] = row

    # K4: one layer of RWKV-6 7B, a prefill of 4 x 512 tokens (the chunked
    # kernel on the tensor cores) and a decode step of 4 (the sequential
    # kernel), 64 heads of 64, bf16 r, k, v, the state carried in place; ("tp_")
    # a tensor-parallel rank's 32 of the 64 heads at 4 x 512 (phase
    # train_tp_recurrent).  No single PyTorch call computes this recurrence,
    # so there is no library time.
    D = 64
    for label, T, H, nsets in (("", 512, 64, 2), ("decode_", 1, 64, 8), ("tp_", 512, 32, 4)):
        B = 4
        sets = [wkv_inputs(gen, B, T, H, D, dt, True) for _ in range(nsets)]
        # r, k, v and y in bf16, logw f32, u, and the state read once and written once
        seq_flops = wkv_mod.sequential_flops(B, T, H, D)
        chunked = wkv_mod.fwd_chunked(dt, T, D, True)
        row = {
            "shape": f"r,k,v ({B},{T},{H},{D}) bf16, state ({B},{H},{D},{D}) f32",
            "kernel": "wkv6_chunk_kernel (tensor cores)" if chunked else "wkv6_kernel (sequential, CUDA cores)",
            "ms": time_ms(lambda r, k, v, w, u, S: kops.wkv6(r, k, v, w, u, S), sets),
            "plain_ms": time_ms(lambda r, k, v, w, u, S: wkv_mod.wkv6_plain(r, k, v, w, u, S, chunk=128), sets),
            "library_ms": None,
            **kcost.bound(wkv_mod.fwd_cost(B, T, H, D, dt, True)),
            "sequential_flops": seq_flops, "sequential_operations_ms": seq_flops / F32_FLOPS * 1e3,
        }
        if label:
            out["wkv6"].update({label + key: val for key, val in row.items()})
        else:
            out["wkv6"] = row
    out["wkv6"]["chunked_t_min"] = wkv_mod.CHUNKED_T_MIN
    out.update(measure_backward(gen))
    measure_stack(gen, out)
    return out


def timed_row(shape: str, kernel, plain, library, sets, cost, iters: int = 20) -> dict:
    """One row of times (kernel, plain version, library call) at ``sets``
    beside the card's bound for ``cost``, the kernel module's (bytes,
    operations, rate) of one call."""
    return {"shape": shape, "ms": time_ms(kernel, sets, iters), "plain_ms": time_ms(plain, sets, iters),
            "library_ms": time_ms(library, sets, iters), **kcost.bound(cost)}


def measure_stack(gen, out: dict) -> None:
    """Times at the rest of the transformer stack's full-width shapes (bf16),
    added to ``out``'s rows under a prefix a model (``coder_``: DeepSeek-Coder
    33B, ``granite_``, ``nemotron_``, ``vl_``: Qwen2-VL 7B, ``hubert_``,
    ``zamba_``: Zamba2-2.7B, ``zamba_gated_``: its Mamba2 gated norm over
    d_inner, ``zamba_tp_``: its tensor-parallel rank's 16 of 32 heads): K1 at a
    prefill's 4 x 512 rows (HuBERT: 4 x 1024 frames), K2 at one layer's
    prefill (HuBERT non-causal, Zamba2 causal, at head size 80),
    K3 at one layer's decode step, 520 of 1024 slots valid (Zamba2 at head
    size 80).  The library calls take the group as it is (``enable_gqa``)."""
    import torch.nn.functional as F  # timed here as a yardstick; the port never calls it

    def add(name, label, row):
        out[name].update({label + key: val for key, val in row.items()})

    dt = torch.bfloat16
    for label, N, d in (("coder_", 2048, 7168), ("granite_", 2048, 6144), ("vl_", 2048, 3584), ("hubert_", 4096, 1280),
                        ("zamba_", 2048, 2560), ("zamba_gated_", 2048, 5120)):
        sets = [(randn(gen, (N, d), dt), randn(gen, (d,), torch.float32)) for _ in range(6)]
        add("rmsnorm", label, timed_row(
            f"x ({N},{d}) bf16", lambda x, s: kops.rmsnorm(x, s), lambda x, s: rms_mod.rmsnorm_plain(x, s),
            lambda x, s: F.rms_norm(x, (x.shape[-1],), s.to(x.dtype), 1e-6), sets, rms_mod.fwd_cost(N, d, dt)))

    for label, B, T, Hq, Hkv, D, causal in (("coder_", 4, 512, 56, 8, 128, True), ("granite_", 4, 512, 48, 1, 128, True),
                                            ("nemotron_", 4, 512, 48, 8, 128, True), ("vl_", 4, 512, 28, 4, 128, True),
                                            ("hubert_", 4, 1024, 16, 16, 80, False),
                                            ("zamba_", 4, 512, 32, 32, 80, True),
                                            ("zamba_tp_", 4, 512, 16, 16, 80, True)):
        sets = [(randn(gen, (B, T, Hq, D), dt), randn(gen, (B, T, Hkv, D), dt), randn(gen, (B, T, Hkv, D), dt))
                for _ in range(2)]
        add("flash_attention", label, timed_row(
            f"q ({B},{T},{Hq},{D}), k,v ({B},{T},{Hkv},{D}) bf16 {'causal' if causal else 'non-causal'}",
            lambda q, k, v: kops.flash_attention(q, k, v, causal=causal),
            lambda q, k, v: fa_mod.flash_attention_plain(q, k, v, causal=causal),
            lambda q, k, v: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                           is_causal=causal, enable_gqa=True).transpose(1, 2),
            sets, fa_mod.fwd_cost(B, T, T, Hq, Hkv, D, causal, dt), iters=5))

    B, S, filled = 4, MAX_LEN, 520
    ar = torch.arange(S, device="cuda", dtype=torch.int32)[None].expand(B, S)
    kv_pos = torch.where(ar < filled, ar, -1).contiguous()
    q_pos = torch.full((B, 1), filled - 1, device="cuda", dtype=torch.int32)
    mask = ((kv_pos >= 0) & (kv_pos <= q_pos))[:, None, None, :]
    valid = int(mask.sum().item())
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    for label, Hq, Hkv, D in (("coder_", 56, 8, 128), ("granite_", 48, 1, 128), ("nemotron_", 48, 8, 128),
                              ("vl_", 28, 4, 128), ("zamba_", 32, 32, 80)):
        sets = [(randn(gen, (B, 1, Hq, D), dt), randn(gen, (B, S, Hkv, D), dt), randn(gen, (B, S, Hkv, D), dt))
                for _ in range(8)]
        G = Hq // Hkv
        nsplit, per = dec_mod.split_plan(B, Hkv, S, sm_count)
        add("decode_attention", label, {**timed_row(
            f"q ({B},1,{Hq},{D}), k,v ({B},{S},{Hkv},{D}) bf16, {filled} of {S} slots valid",
            lambda q, k, v: kops.decode_attention(q, k, v, q_pos, kv_pos),
            lambda q, k, v: dec_mod.decode_attention_plain(q, k, v, q_pos, kv_pos),
            lambda q, k, v: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                           attn_mask=mask, enable_gqa=True).transpose(1, 2),
            sets, dec_mod.cost_of(B, S, Hq, Hkv, D, valid, dt)),
            # split_plan sizes its one wave by B x Hkv alone; a group past 8 takes ceil(G / 8) blocks a kv head
            "plan_slices": nsplit, "plan_tiles_per_slice": per,
            "partial_blocks": nsplit * B * Hkv * (-(-G // 8) if G > 4 else 1),
            "one_wave_blocks": sm_count * dec_mod.BLOCKS_PER_SM})


def measure_backward(gen) -> dict:
    """Times of the backward kernels at GPT-A's training shapes (bf16), K1's
    also at the rows HuBERT-XLarge and Zamba2-2.7B train at, K2's also at a 4K
    context, HuBERT's and Zamba2's shapes: kernel (and its kernels apart),
    plain backward, the library's backward on a graph built beforehand, and
    the card's bound."""
    # K1 backward: the rows of a 4 x 512 batch, d_model 4096; ("hubert_") 4 x
    # 1024 frames of 1280; ("zamba_") 4 x 512 of 2560 and ("zamba_gated_")
    # Zamba2's gated norm over d_inner 5120
    out = {"rmsnorm_bwd": rmsnorm_bwd_row(gen, TRAIN_BATCH * TRAIN_SEQ, 4096)}
    for label, N, d in (("hubert_", 4096, 1280), ("zamba_", 2048, 2560), ("zamba_gated_", 2048, 5120)):
        out["rmsnorm_bwd"].update({label + key: val for key, val in rmsnorm_bwd_row(gen, N, d).items()})

    # K2 backward: one layer's causal training attention, 4 x 512 tokens, 32 heads of 128;
    # ("long_") a 4K context, one sequence; ("hubert_") HuBERT-XLarge's encoder, non-causal,
    # heads of 80; ("zamba_") Zamba2-2.7B's shared block, causal, heads of 80; ("tp_") a
    # tensor-parallel GPT-A rank's 16 of the 32 heads (phase train_tp); ("zamba_tp_") a
    # tensor-parallel Zamba2 rank's 16 of the 32 heads of 80 (phase train_tp_recurrent)
    out["flash_attention_bwd"] = flash_bwd_row(gen, TRAIN_BATCH, TRAIN_SEQ, 32, 128, True)
    for label, B, T, H, D, causal in (("long_", 1, 4096, 32, 128, True), ("hubert_", 4, 1024, 16, 80, False),
                                      ("zamba_", 4, 512, 32, 80, True), ("tp_", 4, 512, 16, 128, True),
                                      ("zamba_tp_", 4, 512, 16, 80, True)):
        out["flash_attention_bwd"].update({label + key: val for key, val in
                                           flash_bwd_row(gen, B, T, H, D, causal, iters=3).items()})
    # K4 backward: RWKV-6 7B's 64 heads; ("tp_") a tensor-parallel rank's 32 (phase train_tp_recurrent)
    out["wkv6_bwd"] = wkv6_bwd_row(gen, TRAIN_BATCH, TRAIN_SEQ, 64, 64)
    out["wkv6_bwd"].update({"tp_" + key: val for key, val in wkv6_bwd_row(gen, TRAIN_BATCH, TRAIN_SEQ, 32, 64).items()})
    return out


def rmsnorm_bwd_row(gen, N: int, d: int) -> dict:
    """K1's backward at x, dy (N, d) bf16: the kernels (and the two apart, the
    profiler's device time a launch), the plain backward, the library's
    backward on a graph built beforehand, and the card's bound."""
    import torch.nn.functional as F  # timed here as a yardstick; the port never calls it

    dt = torch.bfloat16
    sets = [(randn(gen, (N, d), dt), randn(gen, (d,), torch.float32), randn(gen, (N, d), dt)) for _ in range(4)]
    lib_sets = []
    for x, sc, dy in sets:
        xg, wg = x.clone().requires_grad_(True), sc.to(dt).requires_grad_(True)
        with torch.enable_grad():
            lib_sets.append((F.rms_norm(xg, (d,), wg, 1e-6), xg, wg, dy))
    grid = rmsnorm_bwd_plan(N, d, dt)
    split = kernel_times_ms(lambda x, s, g: rms_mod.rmsnorm_bwd_rows(x, s, g), sets)
    row = {
        "shape": f"x, dy ({N},{d}) bf16",
        "ms": time_ms(lambda x, s, g: rms_mod.rmsnorm_bwd_rows(x, s, g), sets),
        "plain_ms": time_ms(lambda x, s, g: rms_mod.rmsnorm_bwd_plain(x, s, g), sets),
        "library_ms": time_ms(lambda y, xg, wg, g: torch.autograd.grad(y, (xg, wg), g, retain_graph=True), lib_sets),
        "library": "F.rms_norm backward, bf16 weight",
        **kcost.bound(rms_mod.bwd_cost(N, d, dt)),
        # the two kernels apart (the profiler's device time a launch) and the
        # partials the first writes and the second reads back
        "rows_kernel": grid["kernel"], "grid_blocks": grid["blocks"], "grid_threads": grid["threads"],
        "partial_bytes": grid["partial_bytes"],
        "rows_kernel_ms": sum(t for k, t in split.items() if "reduce" not in k),
        "reduce_kernel_ms": sum(t for k, t in split.items() if "reduce" in k),
        "f32_rows_kernel": rmsnorm_bwd_plan(N, d, torch.float32)["kernel"],
    }
    del lib_sets
    return row


def flash_bwd_row(gen, B: int, T: int, H: int, D: int, causal: bool, iters: int = 5) -> dict:
    """K2's backward at q, k, v, o, dO (B, T, H, D) bf16: the kernels, each of
    them apart (the profiler's device time a launch), the plain backward, the
    library's backward on a graph built beforehand, and the card's bound."""
    import torch.nn.functional as F  # timed here as a yardstick; the port never calls it

    dt = torch.bfloat16
    sets, lib_sets = [], []
    for _ in range(2):
        q, k, v, do = (randn(gen, (B, T, H, D), dt) for _ in range(4))
        o, lse = fa_mod.flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
        sets.append((q, k, v, o, lse, do))
        leaves = [t.transpose(1, 2).clone().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            lib_sets.append((F.scaled_dot_product_attention(*leaves, is_causal=causal), *leaves, do.transpose(1, 2)))

    def kernel(q, k, v, o, lse, do):
        return fa_mod.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)

    split = kernel_times_ms(kernel, sets, iters=iters)
    row = {
        "shape": f"q,k,v,o,dO ({B},{T},{H},{D}) bf16 {'causal' if causal else 'non-causal'}",
        "kernels": "flash_bwd_rowsum_kernel, then flash_bwd_wg_dkdv_kernel and flash_bwd_wg_dq_kernel "
                   "(bf16: wgmma, TMA ring, dependent launches)",
        "ms": time_ms(kernel, sets, iters=iters),
        "plain_ms": time_ms(lambda q, k, v, o, lse, do: fa_mod.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                                                         causal=causal),
                            sets, iters=iters),
        "library_ms": time_ms(lambda y, a, b, c, g: torch.autograd.grad(y, (a, b, c), g, retain_graph=True),
                              lib_sets, iters=iters),
        "library": "F.scaled_dot_product_attention backward",
        **kcost.bound(fa_mod.bwd_cost(B, T, T, H, H, D, causal, dt)),
        # the three kernels apart: the profiler's device time a launch
        "rowsum_kernel_ms": sum(t for name, t in split.items() if "rowsum" in name),
        "dkdv_kernel_ms": sum(t for name, t in split.items() if "dkdv" in name),
        "dq_kernel_ms": sum(t for name, t in split.items() if "_dq_" in name),
    }
    del sets, lib_sets
    return row


def wkv6_bwd_row(gen, B: int, T: int, H: int, D: int) -> dict:
    """K4's backward at r, k, v, dy (B, T, H, D) bf16, the chunked route
    training takes: its launch whole and its kernels apart (the profiler's
    device time a launch); the sequential passes forced through the
    threshold in the same run, whole and pass by pass; the f32 launch (the
    sequential passes); the plain backward on the config's chunks of 128; and
    the card's bounds.  No single PyTorch call computes these gradients: no
    library time."""
    sets = []
    for _ in range(2):
        r, k, v, logw, u, _ = wkv_inputs(gen, B, T, H, D, torch.bfloat16, False)
        dy = randn(gen, (B, T, H, D), torch.bfloat16)
        sets.append((r, k, v, logw, u, dy))
    r, k, v, logw, u, _ = wkv_inputs(gen, B, T, H, D, torch.float32, False)
    sets32 = [(r, k, v, logw, u, randn(gen, (B, T, H, D), torch.float32))]
    # r, k, v, dy read and dr, dk, dv written in bf16, logw read and dlogw written in f32; u read, du written
    nbytes, flops, _ = wkv_mod.bwd_cost(B, T, H, D, torch.bfloat16)
    ws_bytes = 2 * B * H * -(-T // 64) * D * D * 4  # the S_prev workspace, written once and read once
    seq_flops = wkv_mod.bwd_flops(B, T, H, D)
    if not wkv_mod.bwd_chunked(torch.bfloat16, T, D, True):
        raise AssertionError(f"wkv6_bwd_row: ({B}, {T}, {H}, {D}) bf16 does not take the chunked route")
    split = kernel_times_ms(wkv_mod.wkv6_bwd_cuda, sets, iters=10)
    with bwd_route(False):
        seq_split = kernel_times_ms(wkv_mod.wkv6_bwd_cuda, sets, iters=10)
    row = {
        "shape": f"r,k,v,dy ({B},{T},{H},{D}) bf16, logw f32, from a zero state",
        "kernels": "chunked route (bf16, D 64, T >= CHUNKED_BWD_T_MIN): wkv6_bwd_state_kernel, wkv6_bwd_chunk_kernel, "
                   "wkv6_du_kernel; sequential passes (f32, D 32, shorter T): wkv6_bwd_kernel<T,D,false> (A), "
                   "wkv6_bwd_kernel<T,D,true> (B), wkv6_bwd_dv_kernel<T,D> (C), wkv6_du_kernel",
        "chunked_bwd_t_min": wkv_mod.CHUNKED_BWD_T_MIN,
        "ms": time_ms(wkv_mod.wkv6_bwd_cuda, sets),
        "f32_ms": time_ms(wkv_mod.wkv6_bwd_cuda, sets32),
        "plain_ms": time_ms(lambda *a: wkv_mod.wkv6_bwd_plain(*a, chunk=128), sets),
        "library_ms": None, "library": "none: no single PyTorch call computes this recurrence's gradients",
        **kcost.bound(wkv_mod.bwd_cost(B, T, H, D, torch.bfloat16)),
        # the restated bound of the chunked route: its workspace's bytes beside the inputs' and outputs'
        "workspace_bytes": ws_bytes,
        "bound_with_workspace_ms": max((nbytes + ws_bytes) / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3,
        "state_kernel_ms": sum(t for name, t in split.items() if "wkv6_bwd_state_kernel" in name),
        "chunk_kernel_ms": sum(t for name, t in split.items() if "wkv6_bwd_chunk_kernel" in name),
        "du_kernel_ms": sum(t for name, t in split.items() if "wkv6_du_kernel" in name),
        # the sequential passes, forced in the same run, and their bound (f32 operations)
        "sequential_bound_ms": seq_flops / F32_FLOPS * 1e3, "sequential_flops": seq_flops,
        "pass_a_ms": sum(t for name, t in seq_split.items() if "wkv6_bwd_kernel" in name and "false" in name),
        "pass_b_ms": sum(t for name, t in seq_split.items() if "wkv6_bwd_kernel" in name and "true" in name),
        "pass_c_ms": sum(t for name, t in seq_split.items() if "wkv6_bwd_dv_kernel" in name),
    }
    with bwd_route(False):
        row["sequential_ms"] = time_ms(wkv_mod.wkv6_bwd_cuda, sets)
    del sets, sets32
    return row


KERNELS = [
    # name, wrapper module, CUDA source, the TPU kernel it replaces
    ("rmsnorm", rms_mod, "src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:35"),
    ("flash_attention", fa_mod, "src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:104"),
    ("decode_attention", dec_mod, "src/repro_torch/kernels/csrc/decode_attention.cu", "src/repro/kernels/decode_attention.py:96"),
    ("wkv6", wkv_mod, "src/repro_torch/kernels/csrc/wkv6.cu", "src/repro/kernels/wkv6.py:85"),
    # the backward of K1 and K2: the TPU kernels have none, XLA derives it for the reference
    ("rmsnorm_bwd", rms_mod, "src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:35"),
    ("flash_attention_bwd", fa_mod, "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
     "src/repro/kernels/flash_attention.py:104"),
    # the backward of K4: the TPU kernel has none, XLA derives it for the reference
    ("wkv6_bwd", wkv_mod, "src/repro_torch/kernels/csrc/wkv6.cu", "src/repro/kernels/wkv6.py:85"),
]
# K4's backward: like K4, the kernels (the sequential passes, or the chunked route
# with its operands in bf16 parts) and the plain version (the chunked form, which
# rescales by exp(+-cumulative log decay)) sum in other orders
TOLS = {"wkv6": WKV_TOL, "rmsnorm_bwd": BWD_TOL, "flash_attention_bwd": BWD_TOL, "wkv6_bwd": WKV_TOL}


def phase_kernels() -> list:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    ck = Checker()
    check_rmsnorm(ck, gen)
    check_flash(ck, gen)
    check_decode(ck, gen)
    check_wkv6(ck, gen)
    check_rmsnorm_bwd(ck, gen)
    check_flash_bwd(ck, gen)
    check_wkv6_bwd(ck, gen)
    timed = measure_kernels(gen)
    rows = []
    for name, _, source, replaces in KERNELS:
        errs = {dt: ck.max_err[(name, dt)] for dt in ("float32", "bfloat16")}
        tols = TOLS.get(name, TOL)
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": errs["bfloat16"], "max_err": errs["bfloat16"], "tol": tols[torch.bfloat16],
            "max_abs_err_f32": errs["float32"], "tol_f32": tols[torch.float32],
            "cases": ck.cases[(name, "float32")] + ck.cases[(name, "bfloat16")],
            **timed[name],
        })
        if name == "wkv6":
            rows[-1]["max_abs_err_state"] = ck.max_err[("wkv6.state", "float32")]
        if name == "flash_attention":
            rows[-1]["max_abs_err_lse_f32"] = ck.max_err[("flash_attention.lse", "float32")]
        if name == "rmsnorm_bwd":
            rows[-1]["max_abs_err_dscale_f32"] = ck.max_err[("rmsnorm_bwd.dscale", "float32")]  # f32 for both dtypes
        if name == "wkv6_bwd":  # f32 for both dtypes
            rows[-1]["max_abs_err_dlogw_du_f32"] = ck.max_err[("wkv6_bwd.f32", "float32")]
    emit({"phase": "kernels", "tolerance": "atol = rtol = tol against the plain version on the same inputs",
          "timing": "device time between CUDA events, calls queued behind a spin kernel, warm-up, median of 7 rounds, inputs cold in L2", "kernels": rows})
    return rows


# ---------------------------------------------------------------------------
# phase simulate: the port's copy of Atlas's and BubbleTea's simulator, on the
# host; every time in it is the paper's A100 testbed model, not this card's
# ---------------------------------------------------------------------------

# benchmarks/paper_figs.py's model dimensions (the paper's §3 GPT-A and GPT-B)
SIM_GPT_A = dict(hidden=4096, seq_len=4096, micro_batch=1, layers_per_stage=1, layer_params=412e6)
SIM_GPT_B = dict(hidden=8192, seq_len=6144, micro_batch=1, layers_per_stage=1, layer_params=1.2e9)
SIM_NOTE = "simulated: the paper's A100 testbed model, not this card"


def sim_testbed(model: dict, M: int):
    """The paper's §6.1 testbed: 12 GPUs as 3 DP x 4 PP over 3 DCs."""
    return simulator.testbed_spec(**model, num_stages=4, microbatches=M, stage_dc=[0, 0, 1, 2])


def fig9_speedups() -> dict:
    """Fig 9: each single-TCP baseline's iteration time over Atlas's (multi-TCP,
    3 pipelines), every schedule held by the invariant checker."""
    out = {}
    for name, model in (("gpt_a", SIM_GPT_A), ("gpt_b", SIM_GPT_B)):
        for M in (4, 16):
            spec = sim_testbed(model, M)
            for lat in (10, 20, 30, 40):
                atlas = simulator.simulate(spec, simulator.GeoTopology(lat, True), policy="atlas", n_pipelines=3,
                                           validate=True).iteration_ms
                for policy in ("gpipe", "megatron", "varuna"):
                    base = simulator.simulate(spec, simulator.GeoTopology(lat, False), policy=policy,
                                              validate=True).iteration_ms
                    out[f"{policy}_over_atlas_{name}_M{M}@{lat}ms"] = base / atlas
    return out


def fig13_bubbletea() -> dict:
    """Fig 13: Atlas's bubbles on the testbed (GPT-B, M 16, 40 ms), then
    BubbleTea's controller placing prefills from a seeded arrival stream."""
    res = simulator.simulate(sim_testbed(SIM_GPT_B, 16), simulator.GeoTopology(40.0, True), policy="atlas",
                             n_pipelines=3, validate=True)
    lm = bubbletea.PrefillLatencyModel(bubbletea.InferenceModelSpec("llama3-8b", 8e9))
    ctrl = bubbletea.BubbleTeaController([list(res.bubbles[g]) for g in sorted(res.bubbles)], lm)
    mix = bubbletea.PromptMix(lengths=(128, 256, 512, 1024, 2048), weights=(0.3, 0.25, 0.2, 0.15, 0.1))
    requests = bubbletea.ArrivalProcess(rate_per_s=1000.0, horizon_ms=res.iteration_ms, seed=SEED).generate(mix)
    for req in requests:
        ctrl.submit(req)
    busy = sum(iv.end - iv.start for ivs in res.busy.values() for iv in ivs)
    total = res.iteration_ms * len(res.busy)
    return {"utilization_atlas": res.utilization,
            "utilization_with_bubbletea": bubbletea.utilization_with_prefills(busy, total, ctrl),
            "requests": len(requests), "placements": len(ctrl.placements), "rejected": len(ctrl.rejected)}


def traced_simulation() -> dict:
    """One traced run; the second witness re-derives its accounting from the spans."""
    tracer = obs.RecordingTracer()
    simulator.simulate(sim_testbed(SIM_GPT_A, 16), simulator.GeoTopology(40.0, True), policy="atlas",
                       n_pipelines=3, validate=True, tracer=tracer, trace_label="smoke")
    return {"windows_verified": obs.verify_trace(tracer), "events": tracer.n_events}


def phase_simulate() -> None:
    """Fig 9's grid, fig 13's scenario and a traced run through the port's
    copy of ``core/`` and ``obs/``.  An ``InvariantViolation`` or a
    ``TraceMismatch`` raises from inside; a non-finite value, a baseline
    faster than Atlas or a BubbleTea that placed nothing raises here."""
    t0 = time.perf_counter()
    speedups = fig9_speedups()
    fig13 = fig13_bubbletea()
    traced = traced_simulation()
    values = list(speedups.values()) + [fig13["utilization_atlas"], fig13["utilization_with_bubbletea"]]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"simulate: non-finite values {values}")
    if min(speedups.values()) <= 1.0:
        raise AssertionError(f"simulate: a baseline beat Atlas {speedups}")
    if fig13["placements"] < 1 or not fig13["utilization_with_bubbletea"] > fig13["utilization_atlas"]:
        raise AssertionError(f"simulate: BubbleTea filled no bubble {fig13}")
    if traced["windows_verified"] < 1:
        raise AssertionError(f"simulate: the trace verified nothing {traced}")
    emit({"phase": "simulate", "note": SIM_NOTE, "fig9_speedup": speedups,
          "fig9_speedup_min": min(speedups.values()), "fig9_speedup_max": max(speedups.values()),
          "fig13": fig13, "trace": traced, "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# phases 4 and 6: a model at full width through the serving entry points
# ---------------------------------------------------------------------------


def reset_counters() -> None:
    rms_mod.launches = 0
    rms_mod.bwd_launches = 0
    fa_mod.launches = 0
    fa_mod.bwd_launches = 0
    dec_mod.launches = 0
    wkv_mod.launches = 0
    wkv_mod.bwd_launches = 0
    wkv_mod.bwd_chunk_launches = 0
    attention.sdpa_masked_calls = 0


def read_counters() -> dict:
    return {"rmsnorm": rms_mod.launches, "flash_attention": fa_mod.launches,
            "decode_attention": dec_mod.launches, "wkv6": wkv_mod.launches,
            "rmsnorm_bwd": rms_mod.bwd_launches, "flash_attention_bwd": fa_mod.bwd_launches,
            "wkv6_bwd": wkv_mod.bwd_launches, "wkv6_bwd_chunk": wkv_mod.bwd_chunk_launches,
            "sdpa_masked_calls": attention.sdpa_masked_calls}


def make_requests(rng, cfg, lengths, first_id: int):
    return [Request(first_id + i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), max_new_tokens=MAX_NEW)
            for i, n in enumerate(lengths)]


def check_generated(cfg, reqs) -> None:
    for r in reqs:
        if len(r.generated) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in r.generated):
            raise AssertionError(f"request {r.req_id}: generated {r.generated}")
        if not (r.ttft_ms > 0 and len(r.tbt_ms) == MAX_NEW - 1):
            raise AssertionError(f"request {r.req_id}: ttft {r.ttft_ms} tbt {len(r.tbt_ms)}")


def attention_layers(cfg) -> int:
    """The attention calls of one forward: every layer of a transformer, none
    in RWKV-6 or the Mamba2 stack, one a group in the hybrid (its shared block)."""
    if cfg.rwkv is not None or cfg.family == "ssm":
        return 0
    return cfg.num_layers // cfg.attn_period if cfg.family == "hybrid" else cfg.num_layers


def state_bytes_per_seq(model, batch: int) -> float:
    """``kv_cache_state_bytes_per_seq`` of an empty cache of ``batch`` rows (on
    the meta device: nothing is allocated), as the split counts it after a
    prefill of ``batch`` requests."""
    meta = {n: torch.empty(shape, dtype=dt, device="meta") for n, (shape, dt) in model.cache_shape(batch, MAX_LEN).items()}
    return kv_cache_state_bytes_per_seq(meta, MAX_LEN)


def phase_serve(phase: str, cfg, model, params) -> dict:
    """Five traffic shapes through ``ServingEngine.generate`` and
    ``SplitwiseCluster.serve``, counted from zero; raises unless the counters
    show exactly the launches the path owes, splitwise gives the monolithic
    engine's token ids on the uniform and the ragged batch, the cache holds
    the bytes a token it should and the handoff moved what the engine's own
    count gives at each batch it served.  Then a prefill and a decode step are
    traced (``profile_serving``)."""
    L = cfg.num_layers
    A = attention_layers(cfg)
    recurrent = cfg.rwkv is not None or cfg.family in ("ssm", "hybrid")
    init_peak_bytes = torch.cuda.max_memory_allocated()  # parameters made and cast
    n_params = sum(t.numel() for t in flatten(params).values())
    engine = ServingEngine(cfg, params, max_batch=4, max_len=MAX_LEN)
    cluster = SplitwiseCluster(cfg, params, max_batch=4, max_len=MAX_LEN)
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 512)).astype(np.int32)

    def first_batch(first_id):
        return [Request(first_id + i, p.copy(), max_new_tokens=MAX_NEW) for i, p in enumerate(prompts)]

    # untimed warm-up, so that the first request pays no one-time set-up of the libraries
    engine.generate(make_requests(rng, cfg, [64, 64], 900))

    runs = [("batch 4 x 512", first_batch(0), engine.generate, False),
            ("single 300", make_requests(rng, cfg, [300], 10), engine.generate, False),
            ("ragged 200/350/512", make_requests(rng, cfg, [200, 350, 512], 20), engine.generate, True),
            ("splitwise 4 x 512", first_batch(30), cluster.serve, False)]
    runs.append(("splitwise ragged 200/350/512", [Request(40 + i, r.prompt.copy(), max_new_tokens=MAX_NEW)
                                                   for i, r in enumerate(runs[2][1])], cluster.serve, True))
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    report, prefills, masked_prefills, steps = [], 0, 0, 0
    for label, reqs, serve, ragged in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(reqs)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        check_generated(cfg, reqs)
        # a recurrent model serves a ragged batch one request at a time; the
        # dense decoder prefills it at once through the masked plain sdpa
        n = len(reqs) if (ragged and recurrent) else 1
        prefills += n
        masked_prefills += int(ragged and not recurrent)
        steps += n * (MAX_NEW - 1)
        tbt = [t for r in reqs for t in r.tbt_ms]
        report.append({
            "run": label, "requests": len(reqs), "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
            "ttft_ms": reqs[0].ttft_ms, "tbt_ms_p50": float(np.percentile(tbt, 50)),
            "tbt_ms_p99": float(np.percentile(tbt, 99)), "wall_s": wall_s,
            "tokens_per_s": len(reqs) * MAX_NEW / wall_s,
        })
    counters = read_counters()
    peak_bytes = torch.cuda.max_memory_allocated()

    forwards = prefills + steps
    if cfg.rwkv is not None:
        want = {"rmsnorm": (2 * L + 1) * forwards, "wkv6": L * forwards, "flash_attention": 0,
                "decode_attention": 0, "sdpa_masked_calls": 0}
    elif cfg.mla is not None:  # MLA is plain torch, as the reference computes it: no attention kernel, no sdpa
        want = {"rmsnorm": (2 * L + 1) * forwards, "flash_attention": 0, "decode_attention": 0,
                "sdpa_masked_calls": 0, "wkv6": 0}
    else:
        want = {"flash_attention": A * (prefills - masked_prefills), "decode_attention": A * steps,
                "rmsnorm": (2 * L + 1) * forwards, "sdpa_masked_calls": A * masked_prefills, "wkv6": 0}
    want.update(rmsnorm_bwd=0, flash_attention_bwd=0, wkv6_bwd=0, wkv6_bwd_chunk=0)  # serving computes no gradients
    if counters != want:
        raise AssertionError(f"{cfg.name}: launch counters {counters}, expected {want} ({prefills} prefills, {steps} steps)")
    for mono, split in ((runs[0], runs[3]), (runs[2], runs[4])):
        if [r.generated for r in mono[1]] != [r.generated for r in split[1]]:
            raise AssertionError(f"{cfg.name}: SplitwiseCluster ({split[0]}) and the monolithic engine ({mono[0]}) "
                                 "disagree on the token ids")
    empty = zeros_cache(model, 1, MAX_LEN, "cuda")
    per_token = kv_cache_bytes_per_token(empty, MAX_LEN)
    per_seq = kv_cache_state_bytes_per_seq(empty, MAX_LEN)
    # the state a sequence truly holds: the floating leaves without a ring of a cache of one row
    true_state = sum(x.numel() * x.element_size() for x in empty.values()
                     if x.is_floating_point() and not _is_ring_leaf(x, MAX_LEN))
    if cfg.rwkv is not None and per_seq != RWKV_STATE_BYTES:
        raise AssertionError(f"{cfg.name}: {per_seq} bytes of state a sequence, expected {RWKV_STATE_BYTES}")
    if cfg.family == "hybrid" and true_state != ZAMBA_STATE_BYTES:
        raise AssertionError(f"{cfg.name}: {true_state} bytes of state a sequence, expected {ZAMBA_STATE_BYTES}")
    if per_token != KV_BYTES_PER_TOKEN[cfg.name]:
        raise AssertionError(f"{cfg.name}: {per_token} KV bytes a token, expected {KV_BYTES_PER_TOKEN[cfg.name]}")
    # each prefill the split made: a recurrent model's ragged batch one request at a
    # time, any other batch at once, its state counted at the batch it was served in
    handoffs = [[r] for _, reqs, serve, ragged in runs if serve == cluster.serve and ragged and recurrent for r in reqs]
    handoffs += [reqs for _, reqs, serve, ragged in runs if serve == cluster.serve and not (ragged and recurrent)]
    moved = sum(per_token * sum(len(r.prompt) for r in reqs) + state_bytes_per_seq(model, len(reqs)) * len(reqs)
                for reqs in handoffs)
    if cluster.kv_bytes_moved != moved:
        raise AssertionError(f"{cfg.name}: kv_bytes_moved {cluster.kv_bytes_moved}, expected {moved}")
    profile = profile_serving(engine, first_batch(50))

    emit({"phase": phase, "model": cfg.name, "layers": L, "d_model": cfg.d_model, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "params": cfg.param_count(), "params_counted": n_params,
          "max_len": MAX_LEN, "max_new_tokens": MAX_NEW, "prefills": prefills, "steps": steps,
          "runs": report, "peak_memory_bytes": peak_bytes, "init_peak_memory_bytes": init_peak_bytes,
          "kv_bytes_moved": cluster.kv_bytes_moved, "kv_bytes_per_token": per_token,
          "state_bytes_per_seq": per_seq, "state_bytes_per_seq_by_batch": {b: state_bytes_per_seq(model, b) for b in (1, 2, 4)},
          "state_bytes_per_seq_true": true_state, "counters": counters, "profile": profile})
    return {"counters": counters, "prompts": prompts, "engine": engine}


# the profiler's names of the kernels of K1 to K4, whose calls and device time are summed apart
KERNEL_NAMES = {"rmsnorm": ("rmsnorm_reg_kernel", "rmsnorm_kernel"), "flash_attention": ("flash_mma_kernel", "flash_kernel"),
                "decode_attention": ("decode_partial_kernel", "decode_merge_kernel"),
                "wkv6": ("wkv6_chunk_kernel", "wkv6_kernel")}


def serving_ranges(cfg) -> dict:
    """The layers ``traced`` marks as ranges when ``cfg`` serves: name -> (module, function)."""
    return {"moe_apply": (moe_lib, "moe_apply"), "mamba2_apply": (ssm_lib, "mamba2_apply"),
            "attention": (attention, "mla_apply" if cfg.mla is not None else "gqa_apply")}


def traced(fn, ranges=None, top: int = 10, pick=()) -> dict:
    """Runs ``fn`` once to warm up, once untraced for the host's wall time and
    once under torch.profiler (tracing slows the host down), each of
    ``ranges`` (name -> (module, function)) marked as a range there; times in
    ms.  Gives the card's busy time (the sum of the kernels' device times),
    the idle share, the launches, the device time under each range, the
    kernels of KERNEL_NAMES and the ``top`` kernels; with ``pick``
    (substrings of kernel names), also ``picked``: the calls and device time
    of each substring's kernels, wherever they rank."""
    from torch.profiler import ProfilerActivity, profile, record_function

    ranges = ranges or {}
    originals = {name: getattr(mod, fn_name) for name, (mod, fn_name) in ranges.items()}

    def ranged(name, inner):
        def call(*args, **kwargs):
            with record_function(name):
                return inner(*args, **kwargs)
        return call

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for name, (mod, fn_name) in ranges.items():
        setattr(mod, fn_name, ranged(name, originals[name]))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for name, (mod, fn_name) in ranges.items():
            setattr(mod, fn_name, originals[name])
    events = prof.key_averages()
    # the ranges appear twice: as host ops, whose device time is their kernels', and as device
    # annotations spanning the card's timeline from their first kernel to their last; only kernels are summed
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in ranges),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3

    def picked(subs):
        chosen = [e for e in kernels if any(x in e.key for x in subs)]
        return {"calls": sum(e.count for e in chosen), "device_ms": sum(e.self_device_time_total for e in chosen) / 1e3}

    out = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1 - busy_ms / wall_ms) if busy_ms else None,
        "kernel_launches": sum(e.count for e in kernels),
        "ranges_device_ms": {e.key: e.device_time_total / 1e3 for e in events
                             if e.key in ranges and e.device_type == torch.autograd.DeviceType.CPU},
        **{f"{name}_kernels": picked(subs) for name, subs in KERNEL_NAMES.items()},
        "top_kernels": [{"name": e.key[:90], "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels[:top]],
    }
    if pick:
        out["picked"] = {p: picked((p,)) for p in pick}
    return out


@torch.no_grad()
def profile_serving(engine, requests) -> dict:
    """The prefill of ``requests`` and one decode step after it, through
    ``traced`` with the layers of ``serving_ranges`` marked.  A step also
    gives the bytes of the weights it must read (every expert of an MoE
    model: the dispatch is the reference's dense emulation) over the card's
    memory rate.  Called after the counters are read: its launches count in
    no path."""
    model, params = engine.model, engine.params
    B, T = len(requests), max(len(r.prompt) for r in requests)
    batch = {"tokens": torch.from_numpy(np.stack([r.prompt for r in requests])).to("cuda")}
    cache, tok, pos = engine.prefill_batch(requests)
    ranges = serving_ranges(model.cfg)
    prefill = traced(lambda: model.prefill(params, batch, zeros_cache(model, B, MAX_LEN, "cuda")), ranges)
    step = traced(lambda: model.decode_step(params, cache, tok, pos), ranges)  # the same slot, rewritten
    weight_bytes = sum(t.numel() * t.element_size() for path, t in flatten(params).items() if path != "embed")
    step.update(weights_read_bytes=weight_bytes, weights_read_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3)
    return {"batch": B, "prompt_tokens": T, "prefill": prefill, "decode_step": step}


# ---------------------------------------------------------------------------
# phases 5 and 7: the kernel path against the plain path, same weights, on the card
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_path(wkv_chunk=None):
    """Masked plain sdpa for every attention, the plain RMSNorm for every norm
    and the plain chunked WKV-6 for every recurrence, in chunks of
    ``wkv_chunk`` (None: the config's)."""
    kernel_rmsnorm, kernel_wkv6 = kops.rmsnorm, kops.wkv6

    def wkv6_plain_op(r, k, v, logw, u, state=None, *, chunk=64):
        y, S = wkv_mod.wkv6_plain(r, k, v, logw, u, state, chunk=wkv_chunk or chunk)
        if state is not None:
            state.copy_(S)  # in place, as the kernel writes it
        return y

    kops.rmsnorm = lambda x, scale, *, eps=1e-6: rms_mod.rmsnorm_plain(x, scale, eps)
    kops.wkv6 = wkv6_plain_op
    try:
        with attention.force_impl("torch"):
            yield
    finally:
        kops.rmsnorm, kops.wkv6 = kernel_rmsnorm, kernel_wkv6


@contextlib.contextmanager
def route_log(replay=None):
    """Records the top-k expert ids of every ``moe_apply`` call into the
    yielded list.  With ``replay`` (such a list of another path), each call is
    routed to the replayed ids instead, weighted by this path's own gates
    there: the two paths then differ only in their continuous arithmetic."""
    log, top_k = [], moe_lib.top_k

    def recorded(gates, k):
        if replay is None:
            values, ids = top_k(gates, k)
        else:
            ids = replay[len(log)]
            values = gates.gather(-1, ids)
        log.append(ids)
        return values, ids

    moe_lib.top_k = recorded
    try:
        yield log
    finally:
        moe_lib.top_k = top_k


def route_agreement(a: list, b: list) -> float:
    """Share of (call, token) routes whose top-k expert sets agree."""
    same = [(x.sort(-1).values == y.sort(-1).values).all(-1).reshape(-1) for x, y in zip(a, b, strict=True)]
    return torch.cat(same).float().mean().item()


@torch.no_grad()
def run_paths(model, params, tokens, paths) -> dict:
    """For each path: the prefill's logits and cache, and the logits of one
    decode step from a copy of the kernel path's cache; for each stage, the
    routes of the MoE layers (none in a model without them).  A path whose
    name ends in "_pinned" takes the kernel path's routes."""
    B, T = tokens.shape
    out = {}
    for name, ctx in paths.items():
        replay = out["kernel"]["routes_prefill"] if name.endswith("_pinned") else None
        with ctx(), route_log(replay) as log:
            logits, cache = model.prefill(params, {"tokens": tokens}, zeros_cache(model, B, MAX_LEN, "cuda"))
        out[name] = {"prefill": logits, "cache": cache, "routes_prefill": log}
    nxt = out["kernel"]["prefill"].argmax(-1).to(torch.int32)
    pos = torch.full((B,), T, dtype=torch.int32, device="cuda")
    for name, ctx in paths.items():
        replay = out["kernel"]["routes_decode_step"] if name.endswith("_pinned") else None
        with ctx(), route_log(replay) as log:
            cache = {n: x.clone() for n, x in out["kernel"]["cache"].items()}
            out[name]["decode_step"], _ = model.decode_step(params, cache, nxt, pos)
        out[name]["routes_decode_step"] = log
    torch.cuda.synchronize()
    for name in ("prefill", "decode_step"):
        a = out["kernel"][name]
        if a.shape != (B, model.cfg.vocab_size) or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: logits {tuple(a.shape)} not finite or misshapen")
    return out


def gaps(a: dict, b: dict) -> dict:
    """How far two paths' outputs part: logits (absolute), wkv state (over its largest entry)."""
    out = {f"{n}_max_abs_diff": (a[n] - b[n]).abs().max().item() for n in ("prefill", "decode_step")}
    out.update({f"{n}_token_agreement": (a[n].argmax(-1) == b[n].argmax(-1)).float().mean().item()
                for n in ("prefill", "decode_step")})
    for leaf, key in (("wkv", "wkv_state_rel_diff"), ("mamba/ssm", "ssm_state_rel_diff")):
        if leaf in a["cache"]:
            S_a, S_b = a["cache"][leaf], b["cache"][leaf]
            out[key] = ((S_a - S_b).abs().max() / S_b.abs().max()).item()
    if a["routes_prefill"]:
        out["route_agreement"] = route_agreement(a["routes_prefill"] + a["routes_decode_step"],
                                                 b["routes_prefill"] + b["routes_decode_step"])
    return out


PATHS = {"kernel": contextlib.nullcontext, "plain": plain_path}
# the control: the plain path with another order of the recurrence's sums
RWKV_PATHS = {**PATHS, "plain_chunk64": lambda: plain_path(wkv_chunk=64)}
# the MoE models: the plain path also routed as the kernel path routed (see MOE_F32_LAYERS)
MOE_PATHS = {**PATHS, "plain_pinned": plain_path}


def phase_serve_parity(phase: str, cfg, model, params, prompts, extra=None, control=None) -> None:
    """GPT-A, the rest of the dense stack and the hybrid: the kernel path
    against the plain path in bf16, logits within PARITY_TOL; with ``control``
    ((name, context): the plain path with the recurrence's sums in another
    order) within twice what that parts by plus RWKV_BF16_SLACK instead, as
    RWKV-6's; ``extra`` joins the printed line."""
    torch.cuda.reset_peak_memory_stats()
    paths = PATHS if control is None else {**PATHS, control[0]: control[1]}
    out = run_paths(model, params, torch.from_numpy(prompts).to("cuda"), paths)
    k, p = out["kernel"], out["plain"]
    result = {"phase": phase, "model": cfg.name, "layers": cfg.num_layers, "tol": PARITY_TOL,
              "logit_abs_max": k["prefill"].abs().max().item(), **gaps(k, p), **(extra or {})}
    ring = "attn/" if cfg.family == "hybrid" else ""  # the hybrid's cache names its shared block's ring so
    valid = k["cache"][ring + "pos"] >= 0
    B, T = prompts.shape
    result["cache_k_max_abs_diff"] = (k["cache"][ring + "k"].float() - p["cache"][ring + "k"].float())[valid].abs().max().item()
    result["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    c = None if control is None else gaps(out[control[0]], p)
    if c is not None:
        result.update({"control": c, "slack": RWKV_BF16_SLACK,
                       "rule": f"kernel <= 2 x {control[0]} + slack: the recurrence amplifies bf16 roundings"})
    emit(result)  # before the checks, so that a failed run shows its gaps
    for name in ("prefill", "decode_step"):
        key = f"{name}_max_abs_diff"
        bound = PARITY_TOL if c is None else 2 * c[key] + PARITY_TOL
        if not result[key] <= bound:
            raise AssertionError(f"{name}: kernel path and plain path differ by {result[key]} > {bound}")
    if c is not None:
        key = "ssm_state_rel_diff"
        if not result[key] <= 2 * c[key] + RWKV_BF16_SLACK["state_rel"]:
            raise AssertionError(f"{key}: kernel path and plain path part by {result[key]}, the control by {c[key]}")
    if not torch.equal(k["cache"][ring + "pos"], p["cache"][ring + "pos"]) or int(valid.sum()) != attention_layers(cfg) * B * T:
        raise AssertionError("the two paths left different positions in the cache")


def rwkv_parity_f32(cfg, params32) -> dict:
    """RWKV-6: the kernel path against the plain path with f32 activations, on
    the f32 weights before they are cast; within RWKV_F32_TOL."""
    model = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    tokens = torch.from_numpy(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (4, 512))).to("cuda")
    out = run_paths(model, model.cast_params(params32), tokens, RWKV_PATHS)  # cast_params shares f32 leaves
    result = {"kernel": gaps(out["kernel"], out["plain"]), "control": gaps(out["plain_chunk64"], out["plain"]),
              "logit_abs_max": out["kernel"]["prefill"].abs().max().item(), "tol": RWKV_F32_TOL}
    g = result["kernel"]
    for key, tol in (("prefill_max_abs_diff", RWKV_F32_TOL["logits"]), ("decode_step_max_abs_diff", RWKV_F32_TOL["logits"]),
                     ("wkv_state_rel_diff", RWKV_F32_TOL["state_rel"])):
        if not g[key] <= tol:
            raise AssertionError(f"f32 {key}: kernel path and plain path part by {g[key]} > {tol}")
    return result


def phase_serve_rwkv_parity(phase: str, cfg, model, params, prompts, f32: dict) -> None:
    """RWKV-6 in bf16: the kernel path may part from the plain path by at most
    twice what the control parts by, plus RWKV_BF16_SLACK; ``f32`` holds the
    f32 comparison made before the weights were cast."""
    out = run_paths(model, params, torch.from_numpy(prompts).to("cuda"), RWKV_PATHS)
    if not torch.isfinite(out["kernel"]["cache"]["wkv"]).all():
        raise AssertionError("the kernel path's wkv state is not finite")
    g, c = gaps(out["kernel"], out["plain"]), gaps(out["plain_chunk64"], out["plain"])
    for key, slack in (("prefill_max_abs_diff", RWKV_BF16_SLACK["logits"]),
                       ("decode_step_max_abs_diff", RWKV_BF16_SLACK["logits"]),
                       ("wkv_state_rel_diff", RWKV_BF16_SLACK["state_rel"])):
        if not g[key] <= 2 * c[key] + slack:
            raise AssertionError(f"bf16 {key}: kernel path and plain path part by {g[key]}, the control by {c[key]}")
    emit({"phase": phase, "model": cfg.name, "logit_abs_max": out["kernel"]["prefill"].abs().max().item(),
          "bf16": {"kernel": g, "control": c, "rule": "kernel <= 2 x control + slack", "slack": RWKV_BF16_SLACK},
          "f32": f32})


def moe_parity_f32(arch: str) -> dict:
    """The kernel path against the plain path with f32 activations and f32
    weights, full width, MOE_F32_LAYERS layers: pinned within
    MOE_F32_TOL["logits"]; unpinned reported.  Everything it made is released."""
    cfg = dataclasses.replace(get_config(arch), num_layers=MOE_F32_LAYERS, dtype=torch.float32)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = model.init(gen)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (4, 512))).to("cuda")
    out = run_paths(model, params, tokens, MOE_PATHS)
    k = out["kernel"]
    result = {"layers": cfg.num_layers, "logit_abs_max": k["prefill"].abs().max().item(), "tol": MOE_F32_TOL,
              "pinned": gaps(k, out["plain_pinned"]), "free": gaps(k, out["plain"])}
    del out, k, params
    release()
    for stage in ("prefill", "decode_step"):
        if not result["pinned"][f"{stage}_max_abs_diff"] <= MOE_F32_TOL["logits"]:
            raise AssertionError(f"{arch} f32 {stage}: pinned kernel and plain paths part by "
                                 f"{result['pinned'][f'{stage}_max_abs_diff']} > {MOE_F32_TOL['logits']}: {result}")
    return result


def phase_serve_moe_parity(phase: str, cfg, model, params, prompts, f32: dict) -> None:
    """The MoE models in bf16 at full depth, the rules above MOE_F32_LAYERS:
    pinned within PARITY_TOL, unpinned reported;
    ``f32`` holds the f32 comparison made before the bf16 weights were built."""
    out = run_paths(model, params, torch.from_numpy(prompts).to("cuda"), MOE_PATHS)
    k = out["kernel"]
    pinned = gaps(k, out["plain_pinned"])
    emit({"phase": phase, "model": cfg.name, "layers": cfg.num_layers, "logit_abs_max": k["prefill"].abs().max().item(),
          "bf16": {"pinned": pinned, "tol_pinned": PARITY_TOL, "unpinned": gaps(k, out["plain"]),
                   "rule": "pinned <= PARITY_TOL; unpinned gaps and route agreement reported"},
          "f32": f32, "reduced": MOE_REDUCED})
    for stage in ("prefill", "decode_step"):
        key = f"{stage}_max_abs_diff"
        if not pinned[key] <= PARITY_TOL:
            raise AssertionError(f"bf16 {stage}: pinned kernel and plain paths part by {pinned[key]} > {PARITY_TOL}")


def serve_moe_model(arch: str, phase: str) -> dict:
    """The f32 comparison at MOE_F32_LAYERS layers, then ``arch`` at full
    width and depth with its weights made directly in bf16 (the same bits as
    the f32 weights cast, never holding them): served, and held against the
    plain path.  Returns the serving path's counters; everything it made is
    released when it returns."""
    f32 = moe_parity_f32(arch)
    cfg = get_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(gen, dtype=cfg.dtype)
    served = phase_serve(phase, cfg, model, params)
    phase_serve_moe_parity(phase + "_parity", cfg, model, served["engine"].params, served["prompts"], f32)
    return served["counters"]


# ---------------------------------------------------------------------------
# the rest of the transformer stack: four decoders served, HuBERT's encoder
# ---------------------------------------------------------------------------


def stack_parity_f32(cfg) -> dict:
    """The kernel path against the plain path with f32 activations and f32
    weights, at ``cfg``'s full width and STACK_F32_LAYERS layers, within
    STACK_F32_TOL.  Everything it made is released."""
    cfg = dataclasses.replace(cfg, num_layers=STACK_F32_LAYERS, dtype=torch.float32)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = model.init(gen)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (4, 512))).to("cuda")
    out = run_paths(model, params, tokens, PATHS)
    result = {"layers": cfg.num_layers, "logit_abs_max": out["kernel"]["prefill"].abs().max().item(),
              "tol": STACK_F32_TOL, **gaps(out["kernel"], out["plain"])}
    del out, params
    release()
    for stage in ("prefill", "decode_step"):
        if not result[f"{stage}_max_abs_diff"] <= STACK_F32_TOL["logits"]:
            raise AssertionError(f"{cfg.name} f32 {stage}: kernel and plain paths part by "
                                 f"{result[f'{stage}_max_abs_diff']} > {STACK_F32_TOL['logits']}")
    return result


def counters_owed(L: int, forwards: int, flash: int = 0, decode: int = 0, masked: int = 0) -> dict:
    """The launch counters of ``forwards`` forwards of an L-layer transformer:
    two norms a block and the final one each, ``flash``, ``decode`` and
    ``masked`` attention calls in all, no backward, no WKV-6."""
    return {"rmsnorm": (2 * L + 1) * forwards, "flash_attention": flash, "decode_attention": decode,
            "sdpa_masked_calls": masked, "wkv6": 0, "rmsnorm_bwd": 0, "flash_attention_bwd": 0, "wkv6_bwd": 0,
            "wkv6_bwd_chunk": 0}


@torch.no_grad()
def phase_vlm_batch(phase: str, cfg, model, params) -> dict:
    """One pipeline VLM batch (embeds and three position rows that differ:
    image patches at temporal position 0) through ``Model.prefill(...,
    cache=None)``, counted from zero: the model pins it to the masked plain
    sdpa (L calls, no flash launch); its last-token logits within PARITY_TOL
    of the plain path's.  No decode follows such a prefill (ROADMAP Queue 3
    (f): its patches would share ring slot 0).  Returns the counters."""
    L = cfg.num_layers
    raw = next(make_batches(cfg, DataConfig(seed=SEED, batch_size=4, seq_len=512)))
    batch = {k: torch.from_numpy(raw[k]).to("cuda") for k in ("embeds", "positions")}
    pos = batch["positions"]
    if pos.shape != (3, 4, 512) or torch.equal(pos[0], pos[1]) or torch.equal(pos[1], pos[2]):
        raise AssertionError(f"{cfg.name}: the VLM batch's position rows do not differ")
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    logits, _ = model.prefill(params, batch, None)
    counters = read_counters()
    want = counters_owed(L, 1, masked=L)
    if counters != want:
        raise AssertionError(f"{cfg.name} VLM batch: launch counters {counters}, expected {want}")
    with plain_path():
        plain, _ = model.prefill(params, batch, None)
    torch.cuda.synchronize()
    if logits.shape != (4, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError(f"{cfg.name} VLM batch: logits {tuple(logits.shape)} not finite or misshapen")
    gap = (logits - plain).abs().max().item()
    emit({"phase": phase, "model": cfg.name, "batch": "make_batches(vlm, seed 0): 4 x 512, 128 image patches",
          "counters": counters, "logit_abs_max": logits.abs().max().item(), "prefill_max_abs_diff": gap,
          "token_agreement": (logits.argmax(-1) == plain.argmax(-1)).float().mean().item(), "tol": PARITY_TOL,
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if not gap <= PARITY_TOL:
        raise AssertionError(f"{cfg.name} VLM batch: kernel and plain paths part by {gap} > {PARITY_TOL}")
    return counters


def serve_stack_model(arch: str, phase: str, layers) -> dict:
    """The f32 comparison at STACK_F32_LAYERS layers, then ``arch`` at full
    width (``layers`` of its depth, None for all) with its weights made
    directly in bf16: served, held against the plain path, and for the VLM
    one pipeline batch of embeddings.  Returns {path: counters}; everything it
    made is released when it returns."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    f32 = stack_parity_f32(cfg)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(gen, dtype=cfg.dtype)
    if torch.cuda.max_memory_allocated() > INIT_PEAK_LIMIT:
        raise AssertionError(f"{cfg.name}: {torch.cuda.max_memory_allocated()} bytes while the weights were made")
    served = phase_serve(phase, cfg, model, params)
    reduced = STACK_REDUCED if cfg.name in STACK_REDUCED else {"f32 comparison": STACK_REDUCED["f32 comparison"]}
    phase_serve_parity(phase + "_parity", cfg, model, served["engine"].params, served["prompts"],
                       {"f32": f32, "reduced": reduced})
    counts = {cfg.name: served["counters"]}
    if cfg.family == "vlm":
        counts[cfg.name + " (VLM batch)"] = phase_vlm_batch(phase + "_vlm_batch", cfg, model, served["engine"].params)
    return counts


def hubert_run(cfg, batch) -> dict:
    """HuBERT-XLarge at ``cfg.dtype`` (weights made in it): ``Model.loss`` and
    ``Model.prefill(..., cache=None)`` under no_grad on ``batch``, counted from
    zero, each owing L flash launches (non-causal, head size 80) and 2L + 1
    norms; then both on the plain path.  Releases what it made."""
    L = cfg.num_layers
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(gen, dtype=cfg.dtype)
    inputs = {"embeds": batch["embeds"]}
    with torch.no_grad():
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss(params, batch)
        torch.cuda.synchronize()
        loss_ms = (time.perf_counter() - t0) * 1e3
        after_loss = read_counters()
        logits, _ = model.prefill(params, inputs, None)
        counters = read_counters()
        for got, n in ((after_loss, 1), (counters, 2)):
            want = counters_owed(L, n, flash=n * L)
            if got != want:
                raise AssertionError(f"{cfg.name} {cfg.dtype}: launch counters {got}, expected {want}")
        with plain_path():
            loss_p, _ = model.loss(params, batch)
            logits_p, _ = model.prefill(params, inputs, None)
        torch.cuda.synchronize()
        if not (torch.isfinite(loss) and logits.shape == (batch["embeds"].shape[0], cfg.vocab_size)
                and torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: loss {loss} or logits {tuple(logits.shape)} not finite or misshapen")
        out = {"dtype": str(cfg.dtype).replace("torch.", ""), "loss_kernel": loss.item(), "loss_plain": loss_p.item(),
               "loss_rel_diff": abs(loss.item() - loss_p.item()) / abs(loss_p.item()),
               "logit_abs_max": logits.abs().max().item(), "prefill_max_abs_diff": (logits - logits_p).abs().max().item(),
               "loss_ms": loss_ms, "counters": counters, "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        if cfg.dtype == torch.bfloat16:
            out["profile_prefill"] = traced(lambda: model.prefill(params, inputs, None),
                                            {"attention": (attention, "gqa_apply")})
    del params
    release()
    return out


def encode_hubert() -> dict:
    """HuBERT-XLarge's encoder at full width and depth (48 x 1280, 16 heads
    of 80) on the pipeline's audio batch of 4 x 1024 frames: in f32 and in bf16
    (``hubert_run``), each within HUBERT_TOL of its plain path.  Returns the
    bf16 run's counters."""
    cfg = get_config("hubert_xlarge")
    raw = next(make_batches(cfg, DataConfig(seed=SEED, batch_size=HUBERT_BATCH, seq_len=HUBERT_FRAMES)))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in raw.items()}
    runs = {key: hubert_run(dataclasses.replace(cfg, dtype=dt), batch)
            for key, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    emit({"phase": "encode_hubert", "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "heads": cfg.num_heads, "head_dim": cfg.head_dim, "causal": cfg.causal, "params": cfg.param_count(),
          "batch": f"make_batches(audio, seed 0): {HUBERT_BATCH} x {HUBERT_FRAMES} frames", "tol": HUBERT_TOL,
          **runs})
    for key, r in runs.items():
        tol = HUBERT_TOL[key]
        if not (r["loss_rel_diff"] <= tol["loss_rel"] and r["prefill_max_abs_diff"] <= tol["logits"]):
            raise AssertionError(f"encode_hubert {key}: loss {r['loss_rel_diff']} (tol {tol['loss_rel']}), "
                                 f"logits {r['prefill_max_abs_diff']} (tol {tol['logits']})")
    return {cfg.name: runs["bf16"]["counters"]}


# ---------------------------------------------------------------------------
# Zamba2-2.7B: Mamba2 and the hybrid stack at full width and depth
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def ssd_chunk(model, chunk: int):
    """The plain path with the Mamba2 scan in chunks of ``chunk``: the same
    arithmetic with its sums in another order, the control of a recurrence."""
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
    try:
        with plain_path():
            yield
    finally:
        model.cfg = cfg


def serve_hybrid() -> dict:
    """Zamba2-2.7B at full width and all 54 layers, weights made in f32 from
    the seed (reported beside ``param_count``): the kernel path against the
    plain path with f32 activations on them, within HYBRID_F32_TOL; then the
    weights cast to bf16, served (``phase_serve``, whose counters must show
    HYBRID_OWED a forward, prefill and step) and held against the plain path
    in bf16 against the plain path with the scan in chunks of 64
    (HYBRID_CONTROL).  Returns {path: counters}; everything it made is
    released when it returns."""
    cfg = get_config("zamba2_2p7b")
    owed = {"rmsnorm": 2 * cfg.num_layers + 1, "flash_attention": attention_layers(cfg),
            "decode_attention": attention_layers(cfg)}
    if owed != HYBRID_OWED:
        raise AssertionError(f"{cfg.name}: a forward owes {owed}, expected {HYBRID_OWED}")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params32 = model.init(gen)
    n_params = sum(t.numel() for t in flatten(params32).values())
    f32_bytes = sum(t.numel() * t.element_size() for t in flatten(params32).values())
    model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
    tokens = torch.from_numpy(np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, (4, 512))).to("cuda")
    out = run_paths(model32, model32.cast_params(params32), tokens, PATHS)  # cast_params shares f32 leaves
    f32 = {"layers": cfg.num_layers, "logit_abs_max": out["kernel"]["prefill"].abs().max().item(),
           "tol": HYBRID_F32_TOL, "params_counted": n_params, "f32_weight_bytes": f32_bytes,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(), **gaps(out["kernel"], out["plain"])}
    del out
    for stage in ("prefill", "decode_step"):
        if not f32[f"{stage}_max_abs_diff"] <= HYBRID_F32_TOL["logits"]:
            raise AssertionError(f"{cfg.name} f32 {stage}: kernel and plain paths part by {f32[f'{stage}_max_abs_diff']}")
    params = model.cast_params(params32)
    del params32
    release()
    served = phase_serve("serve_hybrid", cfg, model, params)  # counters exactly HYBRID_OWED a forward, prefill, step
    phase_serve_parity("serve_hybrid_parity", cfg, model, served["engine"].params, served["prompts"],
                       {"f32": f32, "control_path": "plain path, the Mamba2 scan in chunks of 64 (the config's: 128)"},
                       control=(HYBRID_CONTROL, lambda: ssd_chunk(model, 64)))
    return {cfg.name: served["counters"]}


# ---------------------------------------------------------------------------
# phases 8 and 9: GPT-A trained at full width, depth cut, on the card; then
# HuBERT-XLarge (its state checkpointed and restored) and Zamba2-2.7B at full
# width and depth
# ---------------------------------------------------------------------------


def train_config(layers: int, dtype: torch.dtype, arch: str = "gpt_a"):
    """``arch`` (GPT-A unless named) at full width with ``layers`` of its
    layers; the config's remat="full"."""
    return dataclasses.replace(get_config(arch), num_layers=layers, dtype=dtype)


def run_train(phase: str, cfg, *, seq: int, lr: float, owed: dict, log_every: int, extra: dict,
              ckpt_dir=None) -> dict:
    """TRAIN_STEPS steps of ``cfg`` (bf16 activations, f32 parameters and
    moments) on TRAIN_BATCH x ``seq`` of ``make_batches(seed 0)`` through
    ``launch.train.train`` (with ``ckpt_dir``, saving every CKPT_EVERY),
    counted from zero; raises unless every loss is finite, the mean of the
    last three falls below step 0's, and the counters show exactly ``owed``
    a step.  The step time is the median of steps 2 on that overlap no
    checkpoint write (``phase_checkpoint`` reports those that do).  Emits the
    phase's line; returns ``train``'s result and the counters."""
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    out = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=seq, lr=lr, seed=SEED, log_every=log_every,
                device="cuda", ckpt_dir=ckpt_dir, ckpt_every=CKPT_EVERY)
    counters = read_counters()
    peak_bytes = torch.cuda.max_memory_allocated()
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    want = {k: n * TRAIN_STEPS for k, n in owed.items()}
    if counters != want:
        raise AssertionError(f"{phase}: launch counters {counters}, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: losses {losses} are not all finite")
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    n_params = sum(t.numel() for t in flatten(out["params"]).values())
    saves = out["checkpoint"]["saves"] if out["checkpoint"] else []
    timed = [h for h in hist[2:] if not during_write(h, saves)]
    step_ms = statistics.median(h["seconds"] for h in timed) * 1e3
    emit({"phase": phase, "model": cfg.name, **extra, "layers": cfg.num_layers, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "params": cfg.param_count(), "params_counted": n_params,
          "remat": cfg.remat, "activations": "bf16", "parameters_and_moments": "f32", "batch": TRAIN_BATCH,
          "seq": seq, "steps": TRAIN_STEPS, "lr": lr, "losses": losses,
          "grad_norms": [h["grad_norm"] for h in hist], "lrs": [h["lr"] for h in hist],
          "step_ms": [h["seconds"] * 1e3 for h in hist], "step_ms_median": step_ms,
          "timed_steps": [h["step"] for h in timed],
          "tokens_per_s": TRAIN_BATCH * seq / (step_ms / 1e3), "peak_memory_bytes": peak_bytes,
          "counters": counters, "counters_per_step": owed})
    out["counters"] = counters
    return out


def phase_train() -> dict:
    """GPT-A at full width with TRAIN_LAYERS layers (``run_train``)."""
    return run_train("train", train_config(TRAIN_LAYERS, torch.bfloat16), seq=TRAIN_SEQ, lr=TRAIN_LR,
                     owed=TRAIN_LAUNCHES_PER_STEP, log_every=TRAIN_STEPS,
                     extra={"reduced": TRAIN_REDUCED, "lr_note": "not the launcher's default 3e-3, which diverges at "
                            "this width: experiments/torch_train.py"})["counters"]


def during_write(h: dict, saves) -> bool:
    """Whether the step of history entry ``h`` overlapped the background write
    of one of ``saves`` (``AsyncCheckpointer.timings``)."""
    return any(s["write_started"] < h["started"] + h["seconds"] and h["started"] < s["write_ended"] for s in saves)


def phase_checkpoint(phase: str, cfg, out: dict, seq: int, lr: float) -> None:
    """The train state ``train`` saved into CKPT_DIR at loop index CKPT_EVERY
    and after the last step: its bytes on disk and in the leaves, the seconds
    of each save's host-blocking snapshot and background write, of
    ``load_pytree``, and the steps that ran while a write was on beside those
    that did not.  Raises unless (a) the final checkpoint, loaded onto the card
    with the live state as ``like``, equals the live state bit for bit, and (b)
    the CKPT_EVERY checkpoint, loaded and run on through the last steps, gives
    the uninterrupted run's losses: bit-equal if one step from one state is
    bit-reproducible on the card (measured first, from two loads), else
    within the f32 loss tolerance of TRAIN_PARITY_TOL."""
    ck, hist = out["checkpoint"], out["history"]
    names = [f"step_{CKPT_EVERY:08d}.npz", f"step_{TRAIN_STEPS:08d}.npz"]
    on_disk = sorted(f for f in os.listdir(CKPT_DIR) if f.endswith(".npz"))
    if on_disk != names or os.path.basename(ck["path"]) != names[-1]:
        raise AssertionError(f"{phase}: checkpoints {on_disk}, latest {ck['path']}; expected {names}")

    live = {"params": out["params"], "opt": out["opt_state"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final = load_pytree(ck["path"], live)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want, got = dict(_walk(live)), dict(_walk(final))
    unequal = [k for k in want if not (got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]))]
    if unequal or set(got) != set(want):
        raise AssertionError(f"{phase}: (a) the final checkpoint differs from the live state at {unequal[:8]}")
    del final, got

    # (b): two loads of the CKPT_EVERY checkpoint, one step from each, then one of them run on
    path = os.path.join(CKPT_DIR, names[0])
    a, b = load_pytree(path, live), load_pytree(path, live)
    start = int(a["opt"].step)
    step_fn = make_train_step(build_model(cfg).loss, optimizer_config(lr, TRAIN_STEPS))
    data = make_batches(cfg, DataConfig(seed=SEED, batch_size=TRAIN_BATCH, seq_len=seq), num_steps=TRAIN_STEPS)
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in bt.items()} for bt in itertools.islice(data, start, None)]
    pa, oa, ma = step_fn(a["params"], a["opt"], batches[0])
    pb, ob, mb = step_fn(b["params"], b["opt"], batches[0])
    la, lb = dict(_walk({"params": pa, "opt": oa})), dict(_walk({"params": pb, "opt": ob}))
    differ = [k for k in la if not torch.equal(la[k], lb[k])]
    reproducible = not differ and float(ma["loss"]) == float(mb["loss"])
    del b, pb, ob, lb
    resumed = [float(ma["loss"])]
    for batch in batches[1:]:
        pa, oa, m = step_fn(pa, oa, batch)
        resumed.append(float(m["loss"]))
    uninterrupted = [h["loss"] for h in hist[start:]]
    rtol = 0.0 if reproducible else TRAIN_PARITY_TOL["f32"]["loss_rel"]
    result = {
        "phase": phase, "model": cfg.name, "dir": "local/chip_smoke_ckpt (.gitignore lists local/; removed after)",
        "ckpt_every": CKPT_EVERY, "files": {f: os.path.getsize(os.path.join(CKPT_DIR, f)) for f in names},
        "leaf_bytes": [s["bytes"] for s in ck["saves"]], "snapshot_s": [s["snapshot_s"] for s in ck["saves"]],
        "write_s": [s["write_ended"] - s["write_started"] for s in ck["saves"]], "load_s": load_s,
        "steps_during_write": [h["step"] for h in hist if during_write(h, ck["saves"])],
        "step_ms_during_write": [h["seconds"] * 1e3 for h in hist if during_write(h, ck["saves"])],
        "step_ms_apart": [h["seconds"] * 1e3 for h in hist if not during_write(h, ck["saves"])],
        "final_bit_equal": True, "step_bit_reproducible": reproducible, "leaves_differing_after_one_step": differ,
        "resumed_from_updates": start, "resumed_losses": resumed, "uninterrupted_losses": uninterrupted,
        "resume_held": "bit-equal" if reproducible else f"{rtol} relative",
    }
    emit(result)
    if len(resumed) != len(uninterrupted) or not all(abs(g - w) <= rtol * abs(w) for g, w in zip(resumed, uninterrupted)):
        raise AssertionError(f"{phase}: (b) resumed losses {resumed} against {uninterrupted} ({result['resume_held']})")


def train_hubert() -> dict:
    """HuBERT-XLarge at full width and depth on the audio family's batches
    (``run_train``), its state checkpointed at loop index CKPT_EVERY and at the
    end and then restored (``phase_checkpoint``); the directory goes at the end."""
    cfg = dataclasses.replace(get_config("hubert_xlarge"), dtype=torch.bfloat16)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        out = run_train("train_hubert", cfg, seq=HUBERT_TRAIN_SEQ, lr=HUBERT_TRAIN_LR, owed=HUBERT_TRAIN_OWED,
                        log_every=1, ckpt_dir=CKPT_DIR,
                        extra={"batches": "make_batches(audio, seed 0): embeds, labels, mask",
                               "lr_note": "the sweep's largest stable lr: experiments/torch_train.py --arch hubert_xlarge"})
        phase_checkpoint("train_hubert_checkpoint", cfg, out, HUBERT_TRAIN_SEQ, HUBERT_TRAIN_LR)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out["counters"]


def train_hybrid() -> dict:
    """Zamba2-2.7B at full width and depth (``run_train``)."""
    cfg = dataclasses.replace(get_config("zamba2_2p7b"), dtype=torch.bfloat16)
    return run_train("train_hybrid", cfg, seq=HYBRID_TRAIN_SEQ, lr=HYBRID_TRAIN_LR, owed=HYBRID_TRAIN_OWED,
                     log_every=1, extra={"lr_note": "the sweep's largest stable lr: experiments/torch_train.py "
                                                    "--arch zamba2_2p7b"})["counters"]


def loss_and_grads(model, params, batch) -> tuple:
    """One step's loss and the gradient of every leaf, as the train step takes
    them (zeros for a leaf the loss does not read)."""
    leaves = list(flatten(params).values())
    for t in leaves:
        t.requires_grad_(True)
    with torch.enable_grad():
        loss, _ = model.loss(params, batch)
        grads = gradients(loss, leaves)
    for t in leaves:
        t.requires_grad_(False)
    return float(loss.detach()), dict(zip(flatten(params), grads))


def grad_gaps(grads: dict, ref: dict) -> dict:
    """Each leaf's gradient against ``ref``'s, relative in norm (0 where both are 0)."""
    out = {}
    for path, g in grads.items():
        num, den = (g - ref[path]).float().norm().item(), ref[path].float().norm().item()
        out[path] = num / den if den else (0.0 if num == 0 else math.inf)
    return out


def parity_gaps(cfg, seq: int, control=None) -> dict:
    """The kernel path against the plain path (masked plain sdpa, plain
    RMSNorm, the plain chunked WKV-6, all through autograd) on the same weights (seed 0) and batch
    (``make_batches(seed 0)``, TRAIN_BATCH x ``seq``); with ``control`` (name,
    a context of the model), that path against the plain path too."""
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = model.init(gen)
    batch = next(make_batches(cfg, DataConfig(seed=SEED, batch_size=TRAIN_BATCH, seq_len=seq)))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
    reset_counters()
    loss_k, grads_k = loss_and_grads(model, params, batch)
    launched = read_counters()
    if not (launched["rmsnorm_bwd"] and launched["wkv6_bwd" if cfg.rwkv is not None else "flash_attention_bwd"]):
        raise AssertionError(f"{cfg.name} train parity: the kernel path launched {launched}")
    with plain_path():
        loss_p, grads_p = loss_and_grads(model, params, batch)
    rel = grad_gaps(grads_k, grads_p)
    worst = max(rel, key=rel.get)
    out = {"layers": cfg.num_layers, "dtype": str(cfg.dtype).replace("torch.", ""), "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p), "grad_rel_diff_max": rel[worst],
           "grad_rel_diff_worst_leaf": worst, "grad_rel_diff": rel,
           "finite": all(bool(torch.isfinite(g).all()) for g in grads_k.values())}
    if control is not None:
        name, ctx = control
        with ctx(model):
            loss_c, grads_c = loss_and_grads(model, params, batch)
        rel_c = grad_gaps(grads_c, grads_p)
        worst_c = max(rel_c, key=rel_c.get)
        out["control"] = {"path": name, "loss_rel_diff": abs(loss_c - loss_p) / abs(loss_p),
                          "grad_rel_diff_max": rel_c[worst_c], "grad_rel_diff_worst_leaf": worst_c,
                          "grad_rel_diff": rel_c}
    return out


def hold_train_parity(phase: str, cases, extra: dict) -> None:
    """Each case (key, cfg, seq, control) through ``parity_gaps``, within
    TRAIN_PARITY_TOL for its dtype; a case with a control whose gradients miss
    that holds each leaf at twice the control's gap on the same leaf plus
    HYBRID_GRAD_SLACK, capped at HYBRID_GRAD_CAP."""
    result = {"phase": phase, **extra, "tol": TRAIN_PARITY_TOL}
    for key, cfg, seq, control in cases:
        g = parity_gaps(cfg, seq, control)
        release()
        result[key] = g
        tol = TRAIN_PARITY_TOL["bf16" if cfg.dtype == torch.bfloat16 else "f32"]
        rel = g["grad_rel_diff"]
        limit = dict.fromkeys(rel, tol["grad_rel"])
        if control is not None and g["grad_rel_diff_max"] > tol["grad_rel"]:
            rel_c = g["control"]["grad_rel_diff"]
            limit = {k: min(2 * rel_c[k] + HYBRID_GRAD_SLACK, HYBRID_GRAD_CAP) for k in rel}
            g["grad_tol_against_control"] = limit
        missed = {k: (rel[k], limit[k]) for k in rel if not rel[k] <= limit[k]}
        if not (g["finite"] and g["loss_rel_diff"] <= tol["loss_rel"] and not missed):
            emit(result)
            raise AssertionError(f"{phase} {key}: loss {g['loss_rel_diff']} (tol {tol['loss_rel']}), "
                                 f"gradients (gap, limit) {missed}")
    emit(result)


def phase_train_parity() -> None:
    """GPT-A, bf16 at 8 layers and f32 at 2 layers, full width."""
    hold_train_parity("train_parity", [("bf16", train_config(TRAIN_LAYERS, torch.bfloat16), TRAIN_SEQ, None),
                                       ("f32", train_config(2, torch.float32), TRAIN_SEQ, None)],
                      {"model": "gpt-a", "reduced": TRAIN_REDUCED})


def phase_train_hubert_parity() -> None:
    """HuBERT-XLarge at full width and depth, f32 and bf16, on its audio batch."""
    cfg = get_config("hubert_xlarge")
    hold_train_parity("train_hubert_parity",
                      [(key, dataclasses.replace(cfg, dtype=dt), HUBERT_TRAIN_SEQ, None)
                       for key, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))], {"model": cfg.name})


def phase_train_hybrid_parity() -> None:
    """Zamba2-2.7B at full width and depth: f32, and bf16 beside the control
    (the plain path with the SSD in chunks of 64)."""
    cfg = get_config("zamba2_2p7b")
    hold_train_parity("train_hybrid_parity",
                      [("f32", dataclasses.replace(cfg, dtype=torch.float32), HYBRID_TRAIN_SEQ, None),
                       ("bf16", dataclasses.replace(cfg, dtype=torch.bfloat16), HYBRID_TRAIN_SEQ,
                        (HYBRID_CONTROL, lambda m: ssd_chunk(m, 64)))],
                      {"model": cfg.name, "control_path": "plain path, the Mamba2 scan in chunks of 64 (the config's: 128)"})


def train_rwkv() -> dict:
    """RWKV-6 7B at full width with RWKV_TRAIN_LAYERS layers (``run_train``):
    K1 and K4 forward and backward."""
    return run_train("train_rwkv", train_config(RWKV_TRAIN_LAYERS, torch.bfloat16, "rwkv6_7b"), seq=TRAIN_SEQ,
                     lr=RWKV_TRAIN_LR, owed=RWKV_TRAIN_OWED, log_every=1,
                     extra={"reduced": RWKV_TRAIN_REDUCED, "lr_note": "the sweep's largest stable lr: "
                            "experiments/torch_train.py --arch rwkv6_7b"})["counters"]


def phase_train_rwkv_parity() -> None:
    """RWKV-6 7B at full width: f32 at 2 layers, and bf16 at RWKV_TRAIN_LAYERS
    beside the control (the plain path with the WKV in chunks of 64)."""
    hold_train_parity("train_rwkv_parity",
                      [("f32", train_config(2, torch.float32, "rwkv6_7b"), TRAIN_SEQ, None),
                       ("bf16", train_config(RWKV_TRAIN_LAYERS, torch.bfloat16, "rwkv6_7b"), TRAIN_SEQ,
                        (RWKV_CONTROL, lambda m: plain_path(wkv_chunk=64)))],
                      {"model": "rwkv6-7b", "reduced": RWKV_TRAIN_REDUCED,
                       "control_path": "plain path, the WKV in chunks of 64 (the config's: 128)"})


# ---------------------------------------------------------------------------
# the dry-run held against the card: what repro_torch.launch.dryrun predicts on
# meta for a step this script runs at full width, from the config alone, beside
# what the card did in that step
# ---------------------------------------------------------------------------

# The predicted peak may part from the caching allocator's by max(3 % of the
# measured, 256 MiB): the allocator hands out whole blocks (a free block that
# would leave less than 1 MiB is not split), and aten's CUDA kernels that take
# scratch (reductions, sorts) allocate what no meta kernel shows.  cuBLAS's
# workspaces go through the allocator too and are no tensor of the program:
# they are cleared before the step, so that the step makes them anew, and the
# prediction adds what the step's kind makes: one workspace of
# CUBLAS_WORKSPACE_BYTES for the forward's thread, a second once a backward
# runs on autograd's thread.  The bytes that clearing them after the step
# gives back must equal that.  Argument bytes, launches and transport bytes
# are exact.
DRYRUN_PEAK_TOL = {"rel": 0.03, "abs": 256 * 2**20}
CUBLAS_WORKSPACE_BYTES = 32 * 2**20  # PyTorch's cuBLAS workspace a (handle, stream) on a Hopper card
# full-size combinations whose dry-run (the launcher, ``python -m
# repro_torch.launch.dryrun``) runs on the card's host and is timed
DRYRUN_COMBOS = (("deepseek_coder_33b", "train_4k", "multi"), ("qwen2_moe_a2p7b", "prefill_32k", "single"),
                 ("zamba2_2p7b", "long_500k", "multi"))
DRYRUN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "local", "chip_smoke_dryrun")
DRYRUN_LINES: list = []  # every comparison made in this process, for phase dryrun's summary
# the comparisons owed: GPT-A's served prefill and decode step, GPT-A's and
# RWKV-6's train steps, rank 0's pipelined calls (GPT-A (2, 1, 2) on both
# boundaries and FSDP on (2, 2, 1), and on (2, 1, 2) striped RWKV-6,
# DeepSeek-V2-Lite pinned and Zamba2), its tensor-parallel calls in train_tp,
# train_fsdp, train_tp_moe (pinned) and train_tp_recurrent (three), and its
# FSDP call in train_fsdp_rwkv
DRYRUN_CHECKS = 17
BACKGROUND: list = []  # the processes this script started and has not yet waited for
KERNEL_KEYS = tuple(name for name, *_ in KERNELS)
_PREDICTED: dict = {}


def dryrun_steps() -> dict:
    """name -> a builder of (call, arguments, transport or None) on ``meta``:
    the dry-run's program of each step this script holds against the card,
    made from the config as the card's is made (``dryrun.meta_params`` for
    ``model.init``), nothing taken from a card tensor."""
    meta = torch.device("meta")

    def serve(kind):
        cfg = get_config("gpt_a")
        model = build_model(cfg)
        params = dryrun.meta_params(model, dtype=cfg.dtype)  # the served copy: cast_params of the f32 init
        cache = zeros_cache(model, 4, MAX_LEN, meta)
        if kind == "prefill":
            args = (params, {"tokens": torch.empty((4, 512), dtype=torch.int32, device=meta)}, cache)
            return (lambda: model.prefill(*args)), args, None
        args = (params, cache, torch.empty((4,), dtype=torch.int32, device=meta),
                torch.empty((4,), dtype=torch.int32, device=meta))
        return (lambda: model.decode_step(*args)), args, None

    def train_step(layers, arch, lr):
        cfg = train_config(layers, torch.bfloat16, arch)
        model = build_model(cfg)
        params = dryrun.meta_params(model)
        args = (params, init_opt_state(params), dryrun.train_batch(cfg, TRAIN_BATCH, TRAIN_SEQ))
        step = make_train_step(model.loss, optimizer_config(lr, TRAIN_STEPS))
        return (lambda: step(*args)), args, None

    def pipelined(cfg, shape, boundary, batch, fsdp=False):  # TP inside the stages where model_plan has a plan
        mesh = Mesh(shape, PIPE_AXES, 0)
        plan = model_plan(cfg, mesh, fsdp=fsdp)
        params = stage_params(dryrun.meta_params(build_model(cfg)), cfg, mesh)
        args = (params if plan is None else shard_params(params, mesh, plan), dryrun.train_batch(cfg, batch, TRAIN_SEQ))
        loss_fn = PipelineLoss(cfg, mesh, PIPE_N_MICRO, boundary, transport=MetaTransport(mesh), plan=plan)
        return (lambda: loss_fn(*args)), args, loss_fn.transport

    steps = {"serve_prefill": lambda: serve("prefill"), "serve_decode": lambda: serve("decode"),
             "train_gpt_a": lambda: train_step(TRAIN_LAYERS, "gpt_a", TRAIN_LR),
             "train_rwkv": lambda: train_step(RWKV_TRAIN_LAYERS, "rwkv6_7b", RWKV_TRAIN_LR)}
    for boundary in ("direct", "striped"):
        steps[f"pipe_gpt_a_2x1x2_{boundary}"] = functools.partial(
            pipelined, train_config(PIPE_LAYERS, torch.bfloat16), (2, 1, 2), boundary, PIPE_BATCH)
    steps["pipe_gpt_a_" + PIPE_FSDP_CHECK] = functools.partial(
        pipelined, train_config(PIPE_LAYERS, torch.bfloat16), PIPE_FSDP_MESH, "direct", PIPE_BATCH, fsdp=True)
    for prefix, cfg, batch in (("pipe_zamba_", hybrid_pipe_config(), HYBRID_PIPE_BATCH),
                               ("pipe_rwkv_", rwkv_pipe_config(), PIPE_BATCH),
                               ("pipe_deepseek_", moe_pipe_config(), PIPE_BATCH)):
        steps[f"{prefix}2x1x2_striped"] = functools.partial(pipelined, cfg, PIPE_TP_MESH, "striped", batch)

    def tensor_parallel(cfg, shape, batch, fsdp=False, min_bytes=None):
        mesh = Mesh(*shape, 0)
        model, plan = build_model(cfg), model_plan(cfg, mesh, fsdp=fsdp, min_bytes=min_bytes)
        args = (shard_params(dryrun.meta_params(model), mesh, plan), dryrun.train_batch(cfg, batch, TRAIN_SEQ))
        loss_fn = DataParallelLoss(model.loss, mesh, transport=MetaTransport(mesh), plan=plan)
        return (lambda: loss_fn(*args)), args, loss_fn.transport

    steps[TP_CHECK] = functools.partial(tensor_parallel, train_config(TP_LAYERS, torch.bfloat16), TP_MESH, TP_BATCH)
    steps[FSDP_CHECK] = functools.partial(tensor_parallel, train_config(TP_LAYERS, torch.bfloat16), TP_MESH, TP_BATCH,
                                          fsdp=True)
    steps[TP_MOE_CHECK] = functools.partial(tensor_parallel, tp_moe_config(), TP_MESH, TP_MOE_BATCH)
    for arch, layers, _, check, family in TP_REC_MODELS:
        steps[check] = functools.partial(tensor_parallel, tp_rec_config(arch, layers, family), TP_REC_MESH,
                                         TP_REC_BATCH)
    steps[FSDP_RWKV_CHECK] = functools.partial(tensor_parallel, fsdp_rwkv_config(), FSDP_RWKV_MESH, FSDP_RWKV_BATCH,
                                               fsdp=True, min_bytes=FSDP_RWKV_MIN_BYTES)
    return steps


def write_predictions(path: str) -> None:
    """Each of ``dryrun_steps`` counted on ``meta`` (``dryrun.count``, and its
    transport's bytes), as one JSON file at ``path``."""
    out = {}
    for name, build_step in dryrun_steps().items():
        call, args, transport = build_step()
        with torch.no_grad() if name.startswith("serve") else contextlib.nullcontext():
            out[name] = dryrun.count(call, args)
        out[name]["transport"] = transport.counts() if transport is not None else None
        del call, args
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def background_dryruns() -> None:
    """The dry-run's work that needs no card, in one process: the
    predictions (``write_predictions``), then the launcher for each of
    DRYRUN_COMBOS, all written under DRYRUN_DIR."""
    write_predictions(os.path.join(DRYRUN_DIR, "predictions.json"))
    for arch, shape, mesh in DRYRUN_COMBOS:
        dryrun.main(["--arch", arch, "--shape", shape, "--mesh", mesh, "--out", DRYRUN_DIR, "--force"])


def start_dryruns() -> tuple:
    """``background_dryruns`` in a process of the lowest priority, started
    before the card's phases so that it runs beside the build and the kernel
    checks, on host cores they leave idle: (the process, its start)."""
    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    os.makedirs(DRYRUN_DIR)
    env = {**os.environ, "PYTHONPATH": os.path.join(root, "src"), "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.background_dryruns()"], cwd=root,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            preexec_fn=lambda: os.nice(19))
    BACKGROUND.append(proc)
    return proc, time.perf_counter()


def predictions(started) -> dict:
    """``write_predictions``' entries, once the background process has ended
    (raises unless it ended with 0); ``_wall_s``: its seconds from its start."""
    if not _PREDICTED:
        proc, t0 = started
        log, _ = proc.communicate(timeout=900)
        BACKGROUND.remove(proc)
        if proc.returncode != 0:
            raise AssertionError(f"the background dry-runs: exit {proc.returncode}: {log[-3000:]}")
        with open(os.path.join(DRYRUN_DIR, "predictions.json")) as f:
            _PREDICTED.update(json.load(f))
        _PREDICTED["_wall_s"] = time.perf_counter() - t0
    return _PREDICTED


def hold_dryrun(name: str, label: str, pred: dict, call, args, *, backward: bool, transport=None, owed=None):
    """The card's step ``call`` on ``args`` (a tree of its tensors) held
    against ``pred``, its dry-run (``write_predictions``' entry): run from
    cleared cuBLAS workspaces and counters, its peak from
    ``reset_peak_memory_stats`` and its device time between CUDA events.
    Exact: argument bytes, each kernel's launches (and ``owed``, where given),
    ``transport``'s bytes by axis and op, and the cuBLAS workspaces the step
    made (one, two where it runs a ``backward``); the peak within
    DRYRUN_PEAK_TOL of the dry-run's plus those workspaces.
    Returns (the comparison's line, the step's output)."""
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    reset_counters()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = call()
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counters = read_counters()
    device_ms = start.elapsed_time(end)
    kept = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    ws = kept - torch.cuda.memory_allocated()  # the workspaces the step made
    ws_predicted = CUBLAS_WORKSPACE_BYTES * (2 if backward else 1)
    held = dryrun.argument_bytes(args, rounded=True)
    measured = peak - (base - held)  # the step's peak: its arguments and what it made, nothing else on the card
    predicted = pred["peak_bytes"] + ws_predicted
    launched = {k: counters[k] for k in KERNEL_KEYS if counters[k]}
    compute_ms, memory_ms = pred["flops"] / BF16_FLOPS * 1e3, pred["bytes_accessed"] / HBM_BYTES_PER_S * 1e3
    line = {"check": name, "prediction": label,
            "argument_bytes": {"card": dryrun.argument_bytes(args), "meta": pred["argument_bytes"]},
            "launches": {"card": launched, "meta": pred["launches"]},
            "cublas_workspace": {"card": ws, "predicted": ws_predicted},
            "peak_bytes": {"card": measured, "meta": pred["peak_bytes"], "predicted": predicted, "diff": measured - predicted,
                           "rel_diff": (measured - predicted) / measured,
                           "allowed": max(DRYRUN_PEAK_TOL["rel"] * measured, DRYRUN_PEAK_TOL["abs"]),
                           "card_other_bytes": base - held, "card_max_allocated": peak},
            "roofline": {"device_ms": device_ms, "flops": pred["flops"], "bytes_accessed": pred["bytes_accessed"],
                         "compute_ms": compute_ms, "memory_ms": memory_ms,
                         "device_over_bound": device_ms / max(compute_ms, memory_ms),
                         "kernel_flops": pred["kernel_flops"], "kernel_bytes": pred["kernel_bytes"]},
            "meta_host_s": pred["host_s"], "meta_aten_ops": pred["aten_ops"]}
    failures = []
    if line["argument_bytes"]["card"] != line["argument_bytes"]["meta"]:
        failures.append("argument bytes")
    if ws != ws_predicted:
        failures.append("cublas workspace")
    if launched != pred["launches"] or (owed is not None and launched != {k: v for k, v in owed.items()
                                                                        if k in KERNEL_KEYS and v}):
        failures.append("launches")
    if transport is not None or pred["transport"] is not None:
        line["transport"] = {"card": transport.counts() if transport else None, "meta": pred["transport"]}
        if line["transport"]["card"] != line["transport"]["meta"]:
            failures.append("transport bytes")
    if not abs(measured - predicted) <= line["peak_bytes"]["allowed"]:
        failures.append("peak bytes")
    line["failures"] = failures
    DRYRUN_LINES.append(line)
    return line, out


def check_dryrun_lines(lines) -> None:
    bad = [(x["check"], x["failures"]) for x in lines if x["failures"]]
    if bad:
        raise AssertionError(f"dry-run against the card: {bad}; lines {json.dumps(lines)}")


def dryrun_serving(cfg, model, params, started) -> None:
    """GPT-A served: one 4 x 512 prefill into an empty ring of MAX_LEN and one
    decode step on it (K1, K2, K3), each held against its dry-run."""
    pred = predictions(started)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(4, 512)).astype(np.int32)).to("cuda")
    cache = zeros_cache(model, 4, MAX_LEN, "cuda")
    with torch.no_grad():
        args = (params, {"tokens": tokens}, cache)
        lines = [hold_dryrun(f"{cfg.name} prefill 4 x 512, ring {MAX_LEN}", "serve_prefill", pred["serve_prefill"],
                             lambda: model.prefill(*args), args, backward=False)[0]]
        args = (params, cache, tokens[:, -1].contiguous(), torch.full((4,), 512, dtype=torch.int32, device="cuda"))
        lines.append(hold_dryrun(f"{cfg.name} decode step, ring {MAX_LEN}", "serve_decode", pred["serve_decode"],
                                 lambda: model.decode_step(*args), args, backward=False)[0])
    emit({"phase": "dryrun_serve", "model": cfg.name, "tol": DRYRUN_PEAK_TOL, "checks": lines})
    check_dryrun_lines(lines)


def dryrun_train(cfg, label: str, pred: dict, owed: dict, lr: float) -> dict:
    """One train step of ``cfg`` as ``launch.train.train`` takes it (f32
    parameters and moments from the seed, TRAIN_BATCH x TRAIN_SEQ of
    ``make_batches(seed 0)``, ``make_train_step(model.loss)``), held against
    its dry-run; ``owed`` the launches a step owes."""
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = model.init(gen)
    batch = next(make_batches(cfg, DataConfig(seed=SEED, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ)))
    args = (params, init_opt_state(params), {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()})
    step = make_train_step(model.loss, optimizer_config(lr, TRAIN_STEPS))
    line, out = hold_dryrun(f"{cfg.name} train step, {cfg.num_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ}", label,
                            pred, lambda: step(*args), args, backward=True, owed=owed)
    del out, args, params
    return line


def phase_dryrun_train(started) -> None:
    """GPT-A (8 layers: K1, K2 and their backward) and RWKV-6 7B (8 layers:
    K1, K4 and their backward) train steps held against their dry-runs."""
    pred = predictions(started)
    lines = [dryrun_train(train_config(TRAIN_LAYERS, torch.bfloat16), "train_gpt_a", pred["train_gpt_a"],
                          TRAIN_LAUNCHES_PER_STEP, TRAIN_LR)]
    release()
    lines.append(dryrun_train(train_config(RWKV_TRAIN_LAYERS, torch.bfloat16, "rwkv6_7b"), "train_rwkv",
                              pred["train_rwkv"], RWKV_TRAIN_OWED, RWKV_TRAIN_LR))
    release()
    emit({"phase": "dryrun_train", "tol": DRYRUN_PEAK_TOL, "checks": lines})
    check_dryrun_lines(lines)


def phase_dryrun(started: list) -> None:
    """Every comparison of this run (the pipelined ranks' from their
    processes) in one line, and the full-size combinations' dry-runs that
    ``background_dryruns`` ran: each must end "ok", with its host seconds
    (the launcher's own ``host_s``).  A dry-run on ``meta`` needs no card."""
    predictions(started)
    combos = []
    for arch, shape, mesh in DRYRUN_COMBOS:
        with open(os.path.join(DRYRUN_DIR, f"{arch}_{shape}_{mesh}_striped.json")) as f:
            r = json.load(f)
        if r["status"] != "ok":
            raise AssertionError(f"dryrun {arch} {shape} {mesh}: {r}")
        combos.append({"arch": arch, "shape": shape, "mesh": mesh, "host_s": r["host_s"],
                       "peak_bytes": r["memory"]["peak_bytes"], "argument_bytes": r["memory"]["argument_bytes"],
                       "plan_bytes_per_device": r["plan_bytes_per_device"], "roofline": r["roofline"]})
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    emit({"phase": "dryrun", "checks": len(DRYRUN_LINES), "background_wall_s": _PREDICTED.get("_wall_s"),
          "summary": [{"check": x["check"], "peak_rel_diff": x["peak_bytes"]["rel_diff"],
                       "device_over_bound": x["roofline"]["device_over_bound"], "failures": x["failures"]}
                      for x in DRYRUN_LINES],
          "run_one": combos, "note": "run_one's seconds are the host's; its roofline is computed, not measured"})
    if len(DRYRUN_LINES) != DRYRUN_CHECKS:
        raise AssertionError(f"dry-run: {len(DRYRUN_LINES)} comparisons made, {DRYRUN_CHECKS} owed")
    check_dryrun_lines(DRYRUN_LINES)


# ---------------------------------------------------------------------------
# the spawned ranks: processes that share the one card, each spawn running
# several runs in turn, each run with its own deadline
# ---------------------------------------------------------------------------

# A spawn costs each rank a new interpreter and its imports, the card's
# context, the gloo group, its first pinned buffer and the card's first
# launches (PERF.md times each part).  So the distributed phases
# share two spawns: one of four ranks (every pipelined run, train_tp with
# train_fsdp, train_tp_moe) and one of two (train_dp, train_tp_recurrent).  A
# rank frees its tensors and the allocator's cache between runs, so that each
# run's peak is its own, and each run counts its launches from zero.  Each run
# has its own deadline: the parent reads the ranks' heartbeat files (``beat``)
# and stops every rank once the slowest has been in one run longer than that
# run's deadline (the first run's clock starts at the spawn).  A stalled run
# fails within its own deadline, and a spawn is bounded by the sum of its
# runs'.  A rank that waits on another more than TIMEOUT (120 s) fails alone.
RUN_DEADLINE_S = 300
TEARDOWN_S = 60  # from the last rank's last beat to every process gone
WARM_UP_N = 1024  # the side of the first matrix product: cuBLAS's handle and workspace


@dataclasses.dataclass
class Job:
    """A run of a spawn: ``fn(rank, world, *args)`` on each rank gives that
    rank's result (JSON); ``hold(results, spawn)`` in the parent holds the
    ranks' results in rank order (``spawn``: the spawn's figures, this run's
    seconds on each rank and what ``after`` returned), emits the run's lines,
    raises on a failure and returns its counters by path.  ``after()``, where
    given, runs in the parent in a thread once every rank has left the run,
    beside the ranks' later runs."""
    fn: object
    args: tuple
    hold: object
    deadline_s: float = RUN_DEADLINE_S
    after: object = None


def beat(store: str, rank: int, run: int) -> None:
    """This rank's heartbeat: it has begun run ``run`` of its spawn (the
    number of runs: it has ended them all)."""
    path = f"{store}.beat{rank}"
    with open(path + ".tmp", "w") as f:
        f.write(str(run))
    os.replace(path + ".tmp", path)


def read_beat(store: str, rank: int) -> int:
    try:
        with open(f"{store}.beat{rank}") as f:
            return int(f.read())
    except (FileNotFoundError, ValueError):
        return 0


_MARKS: list = []  # this rank's (store, rank): where ``mark`` writes


def mark(what: str) -> None:
    """Appends this rank's memory on the card now (allocated, reserved, the
    card's free bytes) to its marks file beside the spawn's store, read by the
    parent when a spawn fails; nothing outside a spawned rank."""
    if not _MARKS:
        return
    store, rank = _MARKS[0]
    with open(f"{store}.marks{rank}", "a") as f:
        f.write(json.dumps({"at": what, "t": time.time(), "allocated": torch.cuda.memory_allocated(),
                            "peak": torch.cuda.max_memory_allocated(), "reserved": torch.cuda.memory_reserved(),
                            "card_free": torch.cuda.mem_get_info()[0]}) + "\n")


def join_as_rank(rank: int, world: int, store: str) -> dict:
    """A spawned rank's start: two host threads (several ranks share the
    host's cores), expandable segments (several allocators share the card),
    full f32 products, the card, and the ``gloo`` group at ``store``; then the
    process's first pinned host buffer, its first launch and its first
    matrix product, each timed alone.  Returns those times."""
    torch.set_num_threads(2)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank} finds no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world, timeout=TIMEOUT)
    out = {"joined": time.time()}
    t0 = time.perf_counter()
    torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True)
    out["pin_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    a = torch.ones(WARM_UP_N, WARM_UP_N, device="cuda")
    torch.cuda.synchronize()
    out["first_launch_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    a @ a
    torch.cuda.synchronize()
    out["cublas_s"] = time.perf_counter() - t0
    out["ready"] = time.time()
    return out


def rank_runs(rank: int, world: int, runs: list, store: str) -> None:
    """One spawned rank: joins (``join_as_rank``), then each (function,
    arguments) of ``runs`` in turn, its heartbeat first, the card's cache
    emptied and its peak and the kernels' counters reset before it; writes
    {"timeline": its times, "runs": each run's result} as JSON beside
    ``store``."""
    entered = time.time()
    timeline = join_as_rank(rank, world, store)
    timeline.update(entered=entered, runs=[])
    _MARKS[:] = [(store, rank)]
    outs = []
    try:
        for i, (fn, args) in enumerate(runs):
            beat(store, rank, i)
            release()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            mark(f"run {i} {fn.__name__}")
            t0, held = time.time(), torch.cuda.memory_allocated()
            outs.append(fn(rank, world, *args))
            peak = torch.cuda.max_memory_allocated()
            release()
            timeline["runs"].append({"run": fn.__name__, "began": t0, "seconds": time.time() - t0,
                                     "allocated_before": held, "peak": peak,
                                     "allocated_after": torch.cuda.memory_allocated()})
        timeline["left"] = time.time()
        with open(f"{store}.rank{rank}.json", "w") as f:
            json.dump({"timeline": timeline, "runs": outs}, f)
        beat(store, rank, len(runs))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, deadlines=(RUN_DEADLINE_S,), after=None) -> list:
    """``fn(rank, world, *args, store)`` on ``world`` processes (the spawn
    start method), whose runs beat (``beat``) as they begin; raises if a rank
    raises or dies, or once the slowest rank has been in run i longer than
    ``deadlines[i]`` (run i's clock starting when the first rank began it, run
    0's at the spawn), or the processes outlive their last beat by TEARDOWN_S
    (every rank is then stopped); ``after`` (run index -> a function) runs
    each function in a thread of this process once every rank has left that
    run, and is waited for (its exception raised) before the spawn's files
    go; returns each rank's results (the JSON each wrote beside ``store``)."""
    os.makedirs(PIPE_DIR, exist_ok=True)
    store = os.path.join(PIPE_DIR, f"store.{os.getpid()}.{time.monotonic_ns()}")
    ctx = torch.multiprocessing.start_processes(fn, args=(world, *args, store), nprocs=world, join=False,
                                                start_method="spawn")
    began = [time.monotonic()] + [None] * len(deadlines)  # the last: the time every rank had ended its runs
    limits = list(deadlines) + [TEARDOWN_S]
    after, started = dict(after or {}), []
    pool = ThreadPoolExecutor(1)
    try:
        while not ctx.join(timeout=0.5):
            now = time.monotonic()
            at = [read_beat(store, r) for r in range(world)]
            for i in sorted(i for i in after if min(at) > i):
                started.append(pool.submit(after.pop(i)))
            for i in range(1, len(began)):
                if began[i] is None and max(at) >= i:
                    began[i] = now
            slow = min(at)
            if now - began[slow] > limits[slow]:
                what = f"run {slow} of {len(deadlines)}" if slow < len(deadlines) else "the teardown"
                raise TimeoutError(f"{world} ranks: {what} outlived its {limits[slow]} s (heartbeats {at})")
    except BaseException:  # each rank's memory where it marked it, for the failure's line
        marks = {}
        for r in range(world):
            with contextlib.suppress(FileNotFoundError), open(f"{store}.marks{r}") as f:
                marks[r] = [json.loads(x) for x in f]
        emit({"phase": "spawn_failed", "world": world, "heartbeats": [read_beat(store, r) for r in range(world)],
              "marks": marks})
        raise
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
        pool.shutdown(wait=True)
    for f in started:
        f.result()
    for i in sorted(after):  # a run the ranks left after the last reading of their beats
        after.pop(i)()
    out = []
    for r in range(world):
        with open(f"{store}.rank{r}.json") as f:
            out.append(json.load(f))
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    return out


def run_jobs(world: int, jobs: list) -> dict:
    """``jobs`` in one spawn of ``world`` ranks (``rank_runs``), each with its
    own deadline; emits the spawn's line (each rank's time from the spawn to
    its function, in ``join_as_rank``'s parts, in each run and after its
    last), then each job's ``hold``; returns their counters by path."""
    held = {"allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved(),
            "card_free": torch.cuda.mem_get_info()[0]}
    spawned, t0 = time.time(), time.perf_counter()
    done = {}
    after = {i: functools.partial(lambda i, fn: done.__setitem__(i, fn()), i, j.after)
             for i, j in enumerate(jobs) if j.after is not None}
    ranks = spawn_ranks(rank_runs, world, [(j.fn, j.args) for j in jobs], deadlines=[j.deadline_s for j in jobs],
                        after=after)
    wall, ended = time.perf_counter() - t0, time.time()
    split = []
    for r in ranks:
        t = r["timeline"]
        split.append({"start_s": t["entered"] - spawned, "join_s": t["joined"] - t["entered"], "pin_s": t["pin_s"],
                      "first_launch_s": t["first_launch_s"], "cublas_s": t["cublas_s"],
                      "runs_s": [x["seconds"] for x in t["runs"]], "teardown_s": ended - t["left"]})
    names = [x["run"] for x in ranks[0]["timeline"]["runs"]]
    emit({"phase": "spawn", "world": world, "runs": names, "deadlines_s": [j.deadline_s for j in jobs],
          "wall_seconds": wall, "parent_memory_at_spawn": held, "ranks": split})
    spawn = {"world": world, "runs": names, "wall_seconds": wall, "spawned": spawned, "parent_memory_at_spawn": held}
    counts = {}
    for i, job in enumerate(jobs):
        counts.update(job.hold([r["runs"][i] for r in ranks],
                               {**spawn, "run_seconds": [s["runs_s"][i] for s in split], "after": done.get(i)}))
    return counts


_MESHES: dict = {}


def rank_mesh(shape, axes=None):
    """This rank's mesh of ``shape`` over ``axes`` (PIPE_AXES), made once a
    process: its groups serve every run on it."""
    key = (tuple(shape), tuple(axes or PIPE_AXES))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(*key)
    return _MESHES[key]


# ---------------------------------------------------------------------------
# the cross-pod pipeline on four ranks
# ---------------------------------------------------------------------------

# GPT-A at full width with PIPE_LAYERS of its 24 layers, on meshes of four
# ranks: a rank holds 1 layer (201,334,784 parameters) and embed and lm_head
# (206,045,184 each), 613,429,248 parameters, 9.81 GB of f32 parameters,
# gradients and two moments (2 layers a rank, 13.0 GB, peaked at 18.87 GB on
# NVIDIA H100 80GB HBM3 before the depth was cut to 2 to pay for phase
# train_fsdp's time).  Before its stage, each rank makes the whole model from
# the seed and its accumulated reference, then keeps its stage of both.  On
# (2, 1, 2) each family is tensor-parallel over model inside the stages: after
# the replicated calls on its whole stage (the control, one a boundary) a rank
# holds its shards of its stage (GPT-A: 306,720,768 parameters, 4.91 GB of f32
# state).
PIPE_LAYERS = 2
# the trained runs of both spawns take one step (two until phase
# train_fsdp_rwkv's time was taken from them)
STEPS_CUT = {"steps": "2 -> 1", "steps_why": "cut to pay for phase train_fsdp_rwkv's time within the script's budget"}
PIPE_REDUCED = {"num_layers": "24 -> 2", "why": "four ranks share the card, each holding its stage's layers and a "
                "copy of embed and lm_head (9.81 GB of f32 state a rank at 2 layers, 13.0 at 4); cut from 4 to 2 "
                "layers to pay for phase train_fsdp's time within the script's budget", **STEPS_CUT}
PIPE_STEPS, PIPE_BATCH, PIPE_N_MICRO = 1, 8, 4
# Zamba2-2.7B with 3 of its 9 groups (full depth until phase
# train_pipeline_fsdp's time was taken from it): three groups padded to four,
# the last stage running one zero group that its zero gate switches off; on
# (2, 1, 2), tensor-parallel in the stages as the reference's plan
# places it, its replicated control running the stages without TP as the (2,
# 1, 1) run did
HYBRID_PIPE_BATCH, HYBRID_PIPE_LAYERS = 4, 18
HYBRID_PIPE_REDUCED = {"num_layers": "54 -> 18 (3 of 9 groups, padded to 4: the last stage's second group is zero)",
                       "why": "cut from full depth to pay for phase train_pipeline_fsdp's time within the script's "
                              "budget; the padded, switched-off group still runs", **STEPS_CUT}
# RWKV-6 7B and DeepSeek-V2-Lite with 2 layers (one a stage) on (2, 1, 2):
# RWKV-6 by heads (K4 and K4 bwd on 32 of the 64 heads of a microbatch of 2 x
# 512), DeepSeek-V2-Lite's 64 experts split over model (32 a rank) and MLA by
# heads (8 of 16), as phase train_tp_moe places them
PIPE_RWKV_LAYERS, PIPE_MOE_LAYERS = 2, 2
PIPE_RWKV_REDUCED = {"num_layers": "32 -> 2", "why": "four ranks share the card's 80 GB: each makes the whole model "
                     "(4.36 GB of f32 parameters at 2 layers) and its accumulated reference (the parameters, the "
                     "sums and one chunk's gradients: 13.1 GB) before it keeps its stage", **STEPS_CUT}
PIPE_MOE_REDUCED = {"num_layers": "27 -> 2", "why": "four ranks share the card's 80 GB: each makes the whole model "
                    "(6.36 GB of f32 parameters at 2 layers) and its accumulated reference (19.1 GB), two ranks at "
                    "a time, before it keeps its stage", **STEPS_CUT}
PIPE_AXES = ("pod", "data", "model")
# The pipelined step computes gradient accumulation over the same row chunks
# (chunk m * DP + d is microbatch m's data shard d) through the same layer
# code at the same shapes, with n_micro * DP a power of two, so that scaling
# the loss first (the pipeline) or the f32 gradients after (accumulation)
# rounds neither.  What differs is the order of the f32 sums: the loss adds
# its n_micro * DP terms in another order (at most that many roundings of
# 2**-24), and each gradient leaf its chunks' parts (autograd sums the
# microbatches in reverse, then the data all-reduce).
PIPE_TOL = {"loss_rel": 1e-6, "grad": 1e-5}  # grad: max|diff| <= 1e-5 max|g| a leaf
PIPE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "local", "chip_smoke_pipeline")
# FSDP over data inside the stages (slice 7f-ii), on the (2, 2, 1) ranks after
# that mesh's runs: the reference's plan with fsdp on, at 4 MiB, splits the
# layer's six matrices, embed (on its rows) and lm_head (on d) over data; the
# norms stay whole.  A rank holds 306,720,768 of its stage's 613,429,248
# parameters (4.91 GB of f32 state, 9.81 without), gathers them once a step
# and reduce-scatters their gradients once
PIPE_FSDP_MESH, PIPE_CKPT_MESH, PIPE_TP_MESH = (2, 2, 1), (2, 1, 2), (2, 1, 2)
PIPE_FSDP_CHECK = "fsdp_2x2x1_direct"  # the dry-run's prediction of rank 0's held call (under "pipe_gpt_a_")


@dataclasses.dataclass
class PipeRun:
    """One pipelined run of the four ranks (``pipe_run``, held by
    ``hold_pipe_run``): ``cfg`` on the mesh ``shape``, one call on the first
    batch for each of ``boundaries`` (each bit-equal to the first), then
    PIPE_STEPS steps through the launcher with ``trained``."""
    phase: str
    cfg: object
    shape: tuple
    boundaries: tuple
    trained: str
    batch: int
    seq: int
    lr: float
    predicted: dict  # "<mesh>_<boundary>" -> write_predictions' entry: rank 0's held calls
    extra: dict  # the phase line's "reduced" and the like
    ckpt: bool = False  # the trained run saves its state (slice 7c), hashed against every rank's own
    fsdp: bool = False  # then FSDP over data inside the stages (slice 7f-ii)
    pinned: bool = False  # MoE: the tensor-parallel calls replay the first control's routes
    f32: bool = False  # the hybrid: f32 calls beside, its bf16 gradients held against the control's own gap
    waves: int = 1  # the accumulated reference made by that many groups of model index in turn (the card's memory)
    ref_on_host: bool = False  # the reference kept on the host: four ranks' control calls do not fit beside it


def pipeline_owed(norms: int, attns: int, last: bool, n_micro: int, remat: bool = True, wkvs: int = 0) -> dict:
    """Launches a rank owes per step: ``train_owed`` for each of its
    microbatches, with its stage's ``norms``, ``attns`` and ``wkvs``, and the
    final norm only on the last stage."""
    one = train_owed(norms, attns, wkvs=wkvs, remat=remat)
    if not last:
        one["rmsnorm"] -= 1
        one["rmsnorm_bwd"] -= 1
    return {k: n_micro * v for k, v in one.items()}


def stage_owed(cfg, num_stages: int, last: bool, n_micro: int) -> dict:
    """``pipeline_owed`` of a stage of ``cfg`` over ``num_stages``: its rows
    of the stack (padded) a microbatch, each owing what its block owes: a
    decoder's two norms and one attention (none with MLA, which attends
    plainly), RWKV-6's two norms and one WKV-6 recurrence, a Zamba2 group's
    two norms a Mamba2 layer and the shared block's two norms and one
    attention."""
    per = padded_num_layers(stack_length(cfg), num_stages) // num_stages
    remat = cfg.remat != "none"
    if cfg.family == "hybrid":
        m = cfg.attn_period - 1
        return pipeline_owed(per * (2 * m + 2), per, last, n_micro, remat)
    if cfg.rwkv is not None:
        return pipeline_owed(2 * per, 0, last, n_micro, remat, wkvs=per)
    return pipeline_owed(2 * per, 0 if cfg.mla is not None else per, last, n_micro, remat)


def stage_state_bytes(cfg, num_stages: int) -> list:
    """Bytes of f32 parameters, gradients and two moments (16 a parameter)
    that each stage holds: its real rows of the stack and every other leaf."""
    key, L = build_pipeline_parts(cfg).layer_key, stack_length(cfg)
    shapes = expected_shapes(cfg)
    out = []
    for stage in range(num_stages):
        lo, hi = stage_layer_range(L, num_stages, stage)
        rows = max(0, min(hi, L) - min(lo, L))
        n = sum(math.prod(v) // L * rows if p.split("/", 1)[0] == key else math.prod(v) for p, v in shapes.items())
        out.append(16 * n)
    return out


def on_data(tree: dict, fplan, mesh) -> dict:
    """A flat tree of this rank's (its stage, or its ``model`` shards) cut to
    its ``data`` blocks under ``fplan``, the plan with fsdp on, on the host."""
    specs = flatten(fplan)
    return {p: local_block(t.detach(), P(*(e if e == "data" else None for e in specs[p])), mesh).cpu()
            for p, t in tree.items()}


def state_on_data(res: dict, fplan, mesh) -> dict:
    """``launch.train.train``'s final parameters and moments (``res``) cut to
    this rank's ``data`` blocks (``on_data``): flat ``params``, ``mu``, ``nu``."""
    opt = res["opt_state"]
    return {part: on_data(flatten(tree), fplan, mesh) for part, tree in
            (("params", res["params"]), ("mu", opt.mu), ("nu", opt.nu))}


def pipe_call(cfg, mesh, boundary: str, params, batch, plan, check, predicted: dict):
    """One pipelined call of this rank on ``batch`` (``plan``: tensor-parallel
    inside the stages), held against its dry-run on rank 0 where ``check``
    ("<mesh>_<boundary>") is in ``predicted`` (``hold_dryrun``): (its line,
    with its peak, its loss, its gradients)."""
    t0 = time.perf_counter()
    loss_fn = make_pipeline_loss(cfg, mesh, n_micro=PIPE_N_MICRO, boundary=boundary, plan=plan)
    held = None
    torch.cuda.reset_peak_memory_stats()
    if mesh.rank == 0 and check in predicted:
        held, (loss, grads) = hold_dryrun(f"{cfg.name} pipelined call, rank 0 of {check}", check, predicted[check],
                                          lambda: loss_fn(params, batch), (params, batch), backward=True,
                                          transport=loss_fn.transport)
    else:
        loss, grads = loss_fn(params, batch)
    torch.cuda.synchronize()
    line = {"loss": float(loss), "finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
            "bytes": loss_fn.transport.counts(), "transport_seconds": loss_fn.transport.times(),
            "call_seconds": time.perf_counter() - t0, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "dryrun": held}
    return line, loss, grads


def against_accumulation(grads: dict, ref: dict, ref_loss: float, loss: float) -> dict:
    """A pipelined call's loss and gradients against accumulation's (PIPE_TOL's terms)."""
    gaps = {}
    for p, g in grads.items():  # ``ref`` may lie on the host: a leaf at a time on the card
        r = ref[p].to(g.device)
        gaps[p] = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
    worst = max(gaps, key=gaps.get)
    return {"ref_loss": ref_loss, "loss_rel_diff": abs(loss - ref_loss) / abs(ref_loss),
            "grad_max_diff_over_max": gaps[worst], "worst_leaf": worst}


def bit_equal(a, b) -> bool:
    """Two calls' (loss, gradients) bit for bit."""
    return bool(torch.equal(a[0], b[0]) and all(torch.equal(g, b[1][p]) for p, g in a[1].items()))


def pipe_run(rank: int, world: int, run: PipeRun) -> dict:
    """This rank of ``run``: joins its mesh, makes the whole model from the
    seed and ``make_train_step``'s accumulated loss and gradients over n_micro
    * DP chunks of the first batch (``accumulated_value_and_grad``; by
    ``run.waves`` groups of model index in turn), and keeps its stage of both
    (the reference on the host with ``run.ref_on_host``).
    Where the mesh splits ``cfg`` over ``model`` (``model_plan``) it first
    makes one replicated call on its whole stage for each boundary, held
    against them, the control (a MoE's routes recorded; for the hybrid one f32
    call beside), and then cuts its shards (``shard_params``) and makes one
    tensor-parallel call for each boundary (a MoE's pinned to the control's
    routes), each leaf's squared difference from the first control's block
    summed (the parent puts the leaves together); then a MoE's one unpinned
    call and the hybrid's one f32 tensor-parallel call.  Elsewhere it makes
    one call for each boundary, held against accumulation.  Rank 0's calls
    are held against their dry-runs where ``run.predicted`` has them.  Then it
    trains PIPE_STEPS steps through ``launch.train.train`` with the trained
    boundary from the same seed, counting the kernels' launches from zero;
    with ``run.ckpt`` the run saves its state under PIPE_DIR and
    ``pipeline_checkpoint`` hashes it; with ``run.fsdp`` the rank then runs
    FSDP over ``data`` inside the stages (``pipe_fsdp_run``)."""
    cfg, shape, runs = run.cfg, tuple(run.shape), run.boundaries
    if world != math.prod(shape):
        raise ValueError(f"{world} ranks for the mesh {shape}")
    mesh = rank_mesh(shape)
    model, plan = build_model(cfg), model_plan(cfg, mesh)
    key, L = build_pipeline_parts(cfg).layer_key, stack_length(cfg)
    label = "x".join(map(str, shape))
    lo, hi = stage_layer_range(L, shape[0], mesh.coords["pod"])
    b0 = next(make_batches(cfg, DataConfig(seed=SEED, batch_size=run.batch, seq_len=run.seq)))
    b0 = {k: torch.from_numpy(v).to("cuda") for k, v in b0.items()}
    out = {"rank": rank, "coords": mesh.coords, "parity": {}, "train": {},
           "card_free_bytes_at_start": torch.cuda.mem_get_info()[0]}
    t0 = time.perf_counter()
    for wave in range(run.waves):
        if mesh.coords["model"] % run.waves == wave:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(SEED)
            torch.cuda.reset_peak_memory_stats()
            whole = model.init(gen)
            ref_loss, _, ref = accumulated_value_and_grad(model.loss, whole, b0, accum_steps=PIPE_N_MICRO * shape[1])
            out["reference_peak_bytes"] = torch.cuda.max_memory_allocated()
            ref_loss = float(ref_loss)
            ref = {p: (g[lo:hi].clone() if p.split("/", 1)[0] == key else g) for p, g in ref.items()}
            if run.ref_on_host:
                ref = {p: g.cpu() for p, g in ref.items()}
            params = stage_params(whole, cfg, mesh)
            del whole
            release()
            mark("reference")
        if run.waves > 1:
            dist.barrier()
    out["state_bytes"] = 16 * sum(t.numel() for t in flatten(params).values())
    out["reference_seconds"] = time.perf_counter() - t0
    first, routes, ref32 = None, None, None
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    if plan is not None:  # the control: the replicated calls on the whole stage, then this rank's shards
        out["control"], control = {}, None
        for boundary in runs:
            with route_log() if run.pinned and control is None else contextlib.nullcontext() as log:
                line, loss, grads = pipe_call(cfg, mesh, boundary, params, b0, None, None, {})
            if log is not None:
                routes, line["route_calls"] = log, len(log)
            line.update(against_accumulation(grads, ref, ref_loss, line["loss"]))
            out["control"][boundary] = line
            if control is None:
                control = (loss, grads)
            else:
                line["bit_equal_to_" + runs[0]] = bit_equal((loss, grads), control)
            del loss, grads
        specs = flatten(plan)
        if run.f32:  # the replicated call in f32 activations, the same f32 weights
            line, _, f_grads = pipe_call(cfg32, mesh, runs[0], params, b0, None, None, {})
            ref32 = {p: local_block(g, specs[p], mesh).clone() for p, g in f_grads.items()}
            out["f32"] = {"control_loss": line["loss"], "control_finite": line["finite"]}
            del f_grads
        ref = {p: local_block(g, specs[p], mesh).clone() for p, g in control[1].items()}
        if run.f32:
            out["control_vs_f32"] = {"sums": leaf_sums(ref, ref32)}
        ref_loss = out["control"][runs[0]]["loss"]
        params = shard_params(params, mesh, plan)
        out["split"] = sorted(split_paths(plan))
        out["param_count"] = sum(t.numel() for t in flatten(params).values())
        del control
        release()
        mark("controls")
    for boundary in runs:
        with route_log(routes) if routes is not None else contextlib.nullcontext() as replayed:
            line, loss, grads = pipe_call(cfg, mesh, boundary, params, b0, plan, f"{label}_{boundary}", run.predicted)
        if replayed is not None:
            line["route_calls"] = len(replayed)
        if plan is None:
            line.update(against_accumulation(grads, ref, ref_loss, line["loss"]))
        else:  # against the control, each leaf's blocks as phase train_tp holds them
            line.update(ref_loss=ref_loss, loss_rel_diff=abs(line["loss"] - ref_loss) / abs(ref_loss),
                        sums=leaf_sums(grads, ref))
            if run.f32 and first is None:
                out["bf16_vs_f32"] = {"sums": leaf_sums(grads, ref32)}
        out["parity"][boundary] = line
        if first is None:
            first = (loss, grads)
        else:
            line["bit_equal_to_" + runs[0]] = bit_equal((loss, grads), first)
        del grads
    if routes is not None:  # one call of the trained boundary routed by its own gates, as training routes
        with route_log() as free:
            line, _, u_grads = pipe_call(cfg, mesh, run.trained, params, b0, plan, None, {})
        out["unpinned"] = {"loss": line["loss"], "finite": line["finite"], "sums": leaf_sums(u_grads, ref),
                           "route_agreement": route_agreement(free, routes), "call_seconds": line["call_seconds"]}
        del u_grads, free, routes
    if run.f32:
        line, _, f_grads = pipe_call(cfg32, mesh, runs[0], params, b0, plan, None, {})
        out["f32"].update(loss=line["loss"], finite=line["finite"], sums=leaf_sums(f_grads, ref32))
        del f_grads, ref32
    mark("calls")
    if run.fsdp:  # the control of the FSDP call: the first call, cut to this rank's data blocks, on the host
        fplan = model_plan(cfg, mesh, fsdp=True)
        control = {"loss": first[0].detach().cpu(), "grads": on_data(first[1], fplan, mesh)}
    del params, first, ref
    release()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    ckpt_dir = os.path.join(PIPE_DIR, "ckpt") if run.ckpt else None
    res = train(cfg, steps=PIPE_STEPS, batch=run.batch, seq=run.seq, lr=run.lr, seed=SEED, log_every=PIPE_STEPS,
                device="cuda", mesh=mesh, pipeline=True, n_micro=PIPE_N_MICRO, boundary=run.trained,
                ckpt_dir=ckpt_dir)
    counters = read_counters()
    hist = res["history"]
    out["train"][run.trained] = {"counters": counters, "losses": [h["loss"] for h in hist],
                                 "grad_norms": [h["grad_norm"] for h in hist],
                                 "step_ms": [h["seconds"] * 1e3 for h in hist],
                                 "bytes_per_step": per_step([h["bytes"] for h in hist]),
                                 "transport_seconds_per_step": per_step([h["transport_seconds"] for h in hist]),
                                 "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                                 "seconds": time.perf_counter() - t0}
    if ckpt_dir:
        out["checkpoint"] = pipeline_checkpoint(res)
    if run.fsdp:
        trained_state = state_on_data(res, fplan, mesh)
    del res
    release()
    if run.fsdp:
        out["fsdp"] = pipe_fsdp_run(mesh, cfg, fplan, b0, run.predicted, control, trained_state, steps=PIPE_STEPS,
                                    batch=run.batch, seq=run.seq, lr=run.lr, boundary=run.trained)
    return out


def pipe_fsdp_run(mesh, cfg, fplan, b0, predicted: dict, control: dict, trained_state: dict, *, steps: int,
                  batch: int, seq: int, lr: float, boundary: str) -> dict:
    """FSDP over ``data`` inside the stages on a rank of (2, 2, 1) (slice
    7f-ii): the whole model made from the seed again, cut to the rank's stage
    and by ``fplan`` (the plan with fsdp on) to its ``data`` blocks; one
    pipelined call on the first batch ``b0`` (rank 0's held against its
    dry-run), its loss and gradient blocks against ``control``, the mesh's
    call without FSDP cut to the same blocks (``against_blocks``); then
    ``steps`` steps over the FSDP ``PipelineLoss`` and the final blocks and
    moments against ``trained_state``, the mesh's launcher-trained run cut to
    the same blocks (``train_held``)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    whole = build_model(cfg).init(gen)
    params = shard_params(stage_params(whole, cfg, mesh), mesh, fplan)
    del whole
    release()
    line, loss, grads = pipe_call(cfg, mesh, boundary, params, b0, fplan, PIPE_FSDP_CHECK, predicted)
    line.update(control_loss=float(control["loss"]), **against_blocks(loss, grads, control["loss"], control["grads"]))
    out = {"parity": line, "split_over_data": sorted(split_paths(fplan, "data"))}
    del loss, grads
    release()
    n = sum(t.numel() for t in flatten(params).values())
    out["params"], out["state_bytes"] = n, 16 * n  # f32 parameters, gradients and two moments
    loss_fn = make_pipeline_loss(cfg, mesh, n_micro=PIPE_N_MICRO, boundary=boundary, plan=fplan)
    out["train"], out["state"] = train_held(loss_fn, params, cfg, steps=steps, batch=batch, seq=seq, lr=lr,
                                            want=trained_state)
    return out


def hold_pipe_run(run: PipeRun, mine: list, spawn: dict) -> dict:
    """Phase ``run.phase``'s line for ``pipe_run``'s ranks (``mine``);
    raises unless every rank's parity holds: within PIPE_TOL of accumulation,
    or on a mesh that splits ``cfg`` over ``model`` the control (the
    replicated calls, one a boundary) within PIPE_TOL and each
    tensor-parallel call within TP_TOL of the first control (the loss on
    every rank, each gradient leaf put together from the ranks' blocks,
    relative in norm; a MoE's calls pinned to the control's routes, on as
    many calls; the hybrid's f32 tensor-parallel call at
    TRAIN_PARITY_TOL["f32"] and, where TP_TOL misses, each bf16 leaf's gap
    from the control at twice the control's own gap from the replicated f32
    call (its rounding's spread) plus HYBRID_GRAD_SLACK, at most
    HYBRID_GRAD_CAP: a halved, zeroed or doubled gradient reads 0.5 or more
    from the control.  Phase train_tp_recurrent measures its tensor-parallel
    call from the f32 call instead; at 18 of Zamba2's layers in the stages
    the bf16 control itself parts from that call by more than the cap (0.43
    at ``groups/mamba/mamba/D``, PERF.md), so the line reports that
    reading beside the limit and holds it to nothing); a second
    boundary is bit-equal to the first with 1/TP of its ``pod`` bytes,
    replicated and tensor-parallel alike; rank 0's calls meet their dry-runs;
    the trained run's losses are finite and its first is the held call's (a
    MoE's: the unpinned call's); the counters show exactly ``stage_owed`` a
    rank a step; with ``run.ckpt`` the saved file has every rank's own state
    bit for bit (``hold_checkpoint``); with ``run.fsdp`` phase
    ``train_pipeline_fsdp`` (``hold_pipe_fsdp``).  Returns the counters
    summed over the ranks, by path."""
    cfg, shape, runs, trained, steps = run.cfg, tuple(run.shape), run.boundaries, run.trained, PIPE_STEPS
    label = "x".join(map(str, shape))
    key = build_pipeline_parts(cfg).layer_key
    split = set(mine[0].get("split", ()))
    tensor_parallel = "control" in mine[0]

    def owed(last):
        return stage_owed(cfg, shape[0], last, PIPE_N_MICRO)

    line = {"phase": run.phase, "model": cfg.name, **run.extra, "mesh": dict(zip(PIPE_AXES, shape)),
            "boundaries": runs, "trained": trained, "tensor_parallel": tensor_parallel, "layers": cfg.num_layers,
            "batch": run.batch, "seq": run.seq, "n_micro": PIPE_N_MICRO, "steps": steps, "lr": run.lr,
            "reference": f"make_train_step(model.loss, accum_steps={PIPE_N_MICRO * shape[1]}) on the same parameters, "
                         f"in each rank", "tol": PIPE_TOL, "param_count": cfg.param_count(),
            "stage_state_bytes": stage_state_bytes(cfg, shape[0]), "counters_per_step": {"first": owed(False),
                                                                                        "last": owed(True)},
            "spawn": spawn, "note": "the ranks share one card", "ranks": mine}
    failures, counts = [], {}
    for r in mine:
        want = {k: steps * v for k, v in owed(r["coords"]["pod"] == shape[0] - 1).items()}
        held_calls = [(b + " (control)", r["control"][b]) for b in runs] if tensor_parallel else \
            [(b, r["parity"][b]) for b in runs]
        for name, p in held_calls:
            if not (p["finite"] and p["loss_rel_diff"] <= PIPE_TOL["loss_rel"]
                    and p["grad_max_diff_over_max"] <= PIPE_TOL["grad"]):
                failures.append((r["rank"], name, "parity", {k: v for k, v in p.items() if k != "bytes"}))
        for boundary in runs if tensor_parallel else ():
            p = r["parity"][boundary]
            if not (p["finite"] and p["loss_rel_diff"] <= TP_TOL["loss_rel"]):
                failures.append((r["rank"], boundary, "tensor-parallel loss", p["loss"], p["ref_loss"]))
        if run.pinned:
            calls = [r["control"][runs[0]]["route_calls"]] + [r["parity"][b]["route_calls"] for b in runs]
            per = padded_num_layers(stack_length(cfg), shape[0]) // shape[0]
            if set(calls) != {(1 if cfg.remat == "none" else 2) * PIPE_N_MICRO * per}:  # forward and remat's
                failures.append((r["rank"], "routes", calls))
        checked = [r["parity"][b]["dryrun"] for b in runs if r["parity"][b].get("dryrun")]
        owed_checks = [b for b in runs if f"{label}_{b}" in run.predicted] if r["rank"] == 0 else []
        if len(checked) != len(owed_checks):
            failures.append((r["rank"], "dryrun", f"{len(checked)} held calls checked, {len(owed_checks)} owed"))
        DRYRUN_LINES.extend(checked)
        failures += [(r["rank"], x["check"], "dryrun", x["failures"]) for x in checked if x["failures"]]
        for calls in [r["parity"]] + ([r["control"]] if tensor_parallel else []):
            for boundary in runs[1:]:
                p, d = calls[boundary], calls[runs[0]]
                if not p["bit_equal_to_" + runs[0]]:
                    failures.append((r["rank"], boundary, "not bit-equal"))
                if p["bytes"]["pod"]["send"] * shape[2] != d["bytes"]["pod"]["send"]:
                    failures.append((r["rank"], boundary, "pod bytes", p["bytes"]["pod"], d["bytes"]["pod"]))
        t = r["train"][trained]
        first = r["unpinned"]["loss"] if run.pinned else r["parity"][trained]["loss"]
        if not all(np.isfinite(t["losses"])) or t["losses"][0] != first:
            failures.append((r["rank"], trained, "losses", t["losses"], first))
        if t["counters"] != want:
            failures.append((r["rank"], trained, "counters", t["counters"], want))
        total = counts.setdefault(f"{run.phase} {cfg.name} {label} {trained}", dict.fromkeys(want, 0))
        for k, v in t["counters"].items():
            total[k] += v
    if tensor_parallel:
        line["tp_tol"] = TP_TOL
        line["grad_rel_diff"], held = {}, {}
        if run.f32:  # the hybrid's f32 calls, and its bf16 leaves beside the control's where TP_TOL misses
            for part in ("f32", "control_vs_f32", "bf16_vs_f32"):
                held[part] = leaf_gaps(mine, part, split, stack=key)
            f32_loss = [abs(r["f32"]["loss"] - r["f32"]["control_loss"]) / abs(r["f32"]["control_loss"]) for r in mine]
            f32_worst = max(held["f32"], key=held["f32"].get)
            if not all(r["f32"]["finite"] and r["f32"]["control_finite"] for r in mine) or \
                    max(f32_loss) > TRAIN_PARITY_TOL["f32"]["loss_rel"] or \
                    held["f32"][f32_worst] > TRAIN_PARITY_TOL["f32"]["grad_rel"] or \
                    len(held["f32"]) != len(expected_shapes(cfg)):
                failures.append(("f32", f32_loss, f32_worst, held["f32"][f32_worst]))
            held["f32_loss_rel_diff"], held["f32_tol"] = f32_loss, TRAIN_PARITY_TOL["f32"]
        for boundary in runs:
            gaps = leaf_gaps(mine, lambda r: r["parity"][boundary], split, stack=key)
            worst = max(gaps, key=gaps.get)
            line["grad_rel_diff"][boundary] = {"worst_leaf": worst, "worst": gaps[worst], "by_leaf": gaps}
            limit = dict.fromkeys(gaps, TP_TOL["grad_rel"])
            if run.f32 and gaps[worst] > TP_TOL["grad_rel"]:  # each leaf at its control's own rounding spread
                limit = {k: min(2 * held["control_vs_f32"][k] + HYBRID_GRAD_SLACK, HYBRID_GRAD_CAP) for k in gaps}
                held["grad_tol_against_control"] = limit
                held["bf16_vs_f32_within_the_same_limit"] = all(held["bf16_vs_f32"][k] <= limit[k] for k in gaps)
            missed = {k: (gaps[k], limit[k]) for k in gaps if not gaps[k] <= limit[k]}
            if missed or len(gaps) != len(expected_shapes(cfg)):
                failures.append((boundary, "tensor-parallel grads", missed, len(gaps)))
        line.update(held)
        if run.pinned:
            free = leaf_gaps(mine, "unpinned", split, stack=key)
            worst = max(free, key=free.get)
            line["unpinned"] = {"held_to": "nothing", "worst_leaf": worst, "worst": free[worst], "by_leaf": free,
                                "loss_rel_diff": [abs(r["unpinned"]["loss"] - r["parity"][runs[0]]["ref_loss"]) /
                                                  abs(r["parity"][runs[0]]["ref_loss"]) for r in mine],
                                "route_agreement": [r["unpinned"]["route_agreement"] for r in mine]}
        for r in mine:
            for part in [r["parity"][b] for b in runs] + [r.get(k, {}) for k in ("unpinned", "f32", "control_vs_f32",
                                                                                 "bf16_vs_f32")]:
                part.pop("sums", None)
    if run.ckpt:
        line["checkpoint"] = hold_checkpoint(mine, spawn["after"], steps, failures, split)
    fsdp_runs = {r["rank"]: r.pop("fsdp") for r in mine if "fsdp" in r}
    emit(line)
    if failures:
        raise AssertionError(f"{run.phase} {shape}: {failures}")
    if fsdp_runs:
        counts[f"train_pipeline_fsdp {cfg.name} {label} {trained}"] = hold_pipe_fsdp(
            cfg, shape, trained, mine, fsdp_runs, owed, steps=steps, batch=run.batch, seq=run.seq, lr=run.lr)
    return counts


def hold_pipe_fsdp(cfg, shape, boundary: str, ranks: list, fsdp_runs: dict, owed, *, steps: int, batch: int,
                   seq: int, lr: float) -> dict:
    """Phase ``train_pipeline_fsdp``: the FSDP runs of ``pipe_run``'s
    ranks on ``shape`` (``pipe_fsdp_run``, ``fsdp_runs`` by rank; ``ranks``
    their results without FSDP on the same mesh).  Raises unless each rank's
    loss and every gradient block are bit-equal to its call without FSDP,
    rank 0's call was held against its dry-run and met it, a step's ``data``
    gathers are each data-split block once and its reduce-scatters DP times
    that, the trained run's first loss is the call's and its losses finite,
    the counters show exactly ``owed(last)`` a step, and its final blocks
    and moments are within PIPE_TOL["grad"] of the launcher-trained run's
    (bit-equal where the clip's norm rounds alike).  Prints each rank's
    bytes and seconds a step by axis and op, step ms, f32 state and peak,
    beside the run's without FSDP; returns the counters summed over the
    ranks."""
    failures, total = [], {}
    for r in ranks:
        f = fsdp_runs[r["rank"]]
        p, t = f["parity"], f["train"]
        want = {k: steps * v for k, v in owed(r["coords"]["pod"] == shape[0] - 1).items()}
        if not (p["finite"] and p["loss_bit_equal"] and p["grads_bit_equal"]):
            failures.append((r["rank"], "not bit-equal to the call without FSDP",
                             {k: v for k, v in p.items() if k not in ("bytes", "transport_seconds", "dryrun")}))
        if p["dryrun"]:
            DRYRUN_LINES.append(p["dryrun"])
            failures += [(r["rank"], "dryrun", p["dryrun"]["failures"])] if p["dryrun"]["failures"] else []
        elif r["rank"] == 0:
            failures.append((0, "dryrun", "the held call was not checked"))
        t["bytes_per_step"] = per_step(t.pop("bytes"))
        t["transport_seconds_per_step"] = per_step(t.pop("transport_seconds"))
        once = p["bytes"]["data"]
        if not (once["all_gather"] > 0 and once["reduce_scatter"] == shape[1] * once["all_gather"]
                and all(b["data"]["all_gather"] == once["all_gather"]
                        and b["data"]["reduce_scatter"] == once["reduce_scatter"] for b in t["bytes_per_step"])):
            failures.append((r["rank"], "data gathers not once a step", once, t["bytes_per_step"]))
        if not all(np.isfinite(t["losses"])) or t["losses"][0] != p["loss"]:
            failures.append((r["rank"], "losses", t["losses"], p["loss"]))
        if t["counters"] != want:
            failures.append((r["rank"], "counters", t["counters"], want))
        for k, v in t["counters"].items():
            total[k] = total.get(k, 0) + v
        if f["state"]["max_diff_over_max"] > PIPE_TOL["grad"]:
            failures.append((r["rank"], "state against the run without FSDP", f["state"]))
        plain = r["train"][boundary]
        f["without_fsdp"] = {"step_ms": plain["step_ms"], "peak_memory_bytes": plain["peak_memory_bytes"],
                             "state_bytes": r["state_bytes"], "bytes_per_step": plain["bytes_per_step"],
                             "transport_seconds_per_step": plain["transport_seconds_per_step"]}
    emit({"phase": "train_pipeline_fsdp", "model": cfg.name, "reduced": PIPE_REDUCED,
          "mesh": dict(zip(PIPE_AXES, shape)), "boundary": boundary, "layers": cfg.num_layers, "batch": batch,
          "seq": seq, "n_micro": PIPE_N_MICRO, "steps": steps, "lr": lr,
          "plan": "model_plan(cfg, mesh, fsdp=True): the reference's make_param_shardings(fsdp=True), 4 MiB",
          "split_over_data": fsdp_runs[0]["split_over_data"],
          "reference": "the mesh's first call and launcher-trained run without FSDP (phase train_pipeline) on the same "
                       "ranks, cut to each rank's data blocks", "state_tol": PIPE_TOL["grad"],
          "state_held": "bit-equal" if all(f["state"]["bit_equal"] == f["state"]["leaves"] for f in fsdp_runs.values())
          else f"within {PIPE_TOL['grad']} (the clip's norm summed in another order)",
          "counters_per_step": {"first": owed(False), "last": owed(True)}, "note": "the ranks share one card",
          "ranks": [{"rank": r["rank"], "coords": r["coords"], **fsdp_runs[r["rank"]]} for r in ranks]})
    if failures:
        raise AssertionError(f"train_pipeline_fsdp: {failures}")
    return total


def hybrid_pipe_config():
    return train_config(HYBRID_PIPE_LAYERS, torch.bfloat16, "zamba2_2p7b")


def rwkv_pipe_config():
    return train_config(PIPE_RWKV_LAYERS, torch.bfloat16, "rwkv6_7b")


def moe_pipe_config():
    return train_config(PIPE_MOE_LAYERS, torch.bfloat16, TP_MOE_ARCH)


def pipe_runs(started) -> list:
    """The pipelined runs of the four ranks, in order (``pipe_run``): GPT-A
    at full width with PIPE_LAYERS layers on (2, 2, 1) ``direct``, then FSDP
    over ``data`` inside the stages on the same ranks (phase
    ``train_pipeline_fsdp``, slice 7f-ii), and on (2, 1, 2) held with both
    boundaries, trained ``striped`` and saved (slice 7c), tensor-parallel over
    ``model`` inside the stages (K2 at 16 of 32 heads; slice 7b-iv): K1, K2
    and their backward.  Then on (2, 1, 2), each tensor-parallel inside the
    stages and held against the replicated call on the same mesh: RWKV-6 7B
    with 2 layers (K1, K4 and their backward, K4 at 32 of 64 heads), DeepSeek-
    V2-Lite with 2 layers (K1 and K1 bwd; 32 of 64 experts and 8 of 16 MLA
    heads a rank, pinned to the control's routes), and Zamba2-2.7B with
    HYBRID_PIPE_LAYERS layers (three groups padded to four, two a stage, the
    padded one switched off by its zero gate and run all the same: K1 at 2560
    and 5120, K2 at 16 of 32 heads of 80, and their backward)."""
    pred = predictions(started)

    def predicted(prefix: str) -> dict:  # "<mesh>_<boundary>" -> the dry-run's entry
        return {k[len(prefix):]: v for k, v in pred.items() if k.startswith(prefix)}

    gpt, both = train_config(PIPE_LAYERS, torch.bfloat16), ("direct", "striped")
    return [PipeRun("train_pipeline", gpt, PIPE_FSDP_MESH, ("direct",), "direct", PIPE_BATCH, TRAIN_SEQ, TRAIN_LR,
                    predicted("pipe_gpt_a_"), {"reduced": PIPE_REDUCED}, fsdp=True),
            PipeRun("train_pipeline", gpt, PIPE_CKPT_MESH, both, "striped", PIPE_BATCH, TRAIN_SEQ, TRAIN_LR,
                    predicted("pipe_gpt_a_"), {"reduced": PIPE_REDUCED}, ckpt=True),
            PipeRun("train_pipeline_rwkv", rwkv_pipe_config(), PIPE_TP_MESH, both, "striped", PIPE_BATCH, TRAIN_SEQ,
                    RWKV_TRAIN_LR, predicted("pipe_rwkv_"), {"reduced": PIPE_RWKV_REDUCED}, ref_on_host=True),
            PipeRun("train_pipeline_moe", moe_pipe_config(), PIPE_TP_MESH, both, "striped", PIPE_BATCH, TRAIN_SEQ,
                    TRAIN_LR, predicted("pipe_deepseek_"), {"reduced": PIPE_MOE_REDUCED}, pinned=True, waves=2,
                    ref_on_host=True),
            PipeRun("train_pipeline_hybrid", hybrid_pipe_config(), PIPE_TP_MESH, both, "striped", HYBRID_PIPE_BATCH,
                    HYBRID_TRAIN_SEQ, HYBRID_TRAIN_LR, predicted("pipe_zamba_"),
                    {"reduced": HYBRID_PIPE_REDUCED, "padded_groups": 1}, f32=True, ref_on_host=True)]


def phase_ranks_of_four(started) -> dict:
    """One spawn of four ranks (``run_jobs``): every pipelined run
    (``pipe_runs``), then phase train_tp with train_fsdp and phase
    train_tp_moe; returns their counters by path."""
    jobs = [Job(pipe_run, (run,), functools.partial(hold_pipe_run, run),
                after=functools.partial(checkpoint_file, run.cfg, run.shape) if run.ckpt else None)
            for run in pipe_runs(started)]
    return run_jobs(4, jobs + [tp_job(started), tp_moe_job(started)])


def phase_ranks_of_two(started) -> dict:
    """One spawn of two ranks (``run_jobs``): phase train_dp, phase
    train_tp_recurrent, then phase train_fsdp_rwkv; returns their counters by
    path."""
    return run_jobs(2, [dp_job(), tp_rec_job(started), fsdp_rwkv_job(started)])


# the functions of main that spawn ranks, in its order (experiments/torch_spawn_timeline.py runs them alone)
DISTRIBUTED_PHASES = ("phase_ranks_of_four", "phase_ranks_of_two")


def leaf_digests(tree, threads: int = 4) -> dict:
    """The SHA-256 of each leaf's bytes by its checkpoint key (``_walk``), each
    leaf copied to the host on its own and hashed in ``threads`` threads."""
    def one(item):
        t = item[1].detach().contiguous().reshape(-1)
        return hashlib.sha256(t.view(torch.uint8).cpu().numpy()).hexdigest()

    items = list(_walk(tree))
    with ThreadPoolExecutor(threads) as pool:
        return dict(zip((k for k, _ in items), pool.map(one, items)))


def pipeline_checkpoint(res: dict) -> dict:
    """This rank's view of the pipelined run's checkpoint (slice 7c): the
    SHA-256 of each leaf of its own state (``leaf_digests``), the save's
    gather seconds, and on rank 0 its snapshot and write seconds.  The file
    itself is checked in the parent (``checkpoint_file``)."""
    ck = res["checkpoint"]
    t0 = time.perf_counter()
    out = {"gather_s": ck["gather_s"], "own": leaf_digests({"params": res["params"], "opt": res["opt_state"]})}
    out["own_digest_s"] = time.perf_counter() - t0
    out["saves"] = [{"bytes": s["bytes"], "snapshot_s": s["snapshot_s"], "write_s": s["write_ended"] - s["write_started"]}
                    for s in ck["saves"]]
    return out


def checkpoint_file(cfg, shape) -> dict:
    """The pipelined run's saved file under PIPE_DIR/ckpt, in the parent on
    the host while the ranks go on to their next runs: loaded with
    ``load_pytree`` into the whole model's tree, cut into each stage with
    ``stage_params`` (and where the mesh splits ``cfg`` over ``model``, into
    each block of it with ``shard_params``) and hashed as the ranks hash their
    own state, by "<pod>/<model>"; with the load's seconds and the hashing's."""
    ckpt_dir = os.path.join(PIPE_DIR, "ckpt")
    out = {"files": sorted(os.listdir(ckpt_dir))}
    written = [f for f in out["files"] if f.endswith(".npz")]
    if len(written) != 1:
        return out
    path = os.path.join(ckpt_dir, written[0])
    shapes = convert_tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), dryrun.meta_params(build_model(cfg)))
    like = {"params": shapes, "opt": OptState(torch.empty((), dtype=torch.int32), shapes, shapes)}
    t0 = time.perf_counter()
    whole = load_pytree(path, like)
    out["load_s"] = time.perf_counter() - t0
    out["file_bytes"] = os.path.getsize(path)
    out["by_block"] = {}
    plan = model_plan(cfg, Mesh(shape, PIPE_AXES, 0))
    t0 = time.perf_counter()
    for stage in range(shape[0]):
        for j in range(shape[2] if plan is not None else 1):
            m = Mesh(shape, PIPE_AXES, Mesh(shape, PIPE_AXES, 0).rank_at(pod=stage, model=j))

            def cut(tree):
                staged = stage_params(tree, cfg, m)
                return staged if plan is None else shard_params(staged, m, plan)

            opt = whole["opt"]
            out["by_block"][f"{stage}/{j}"] = leaf_digests(
                {"params": cut(whole["params"]), "opt": OptState(opt.step, cut(opt.mu), cut(opt.nu))}, threads=1)
    out["file_digest_s"] = time.perf_counter() - t0
    return out


def whole_key(key: str, split) -> bool:
    """Whether the leaf of checkpoint key ``key`` (``params/...``,
    ``opt/.mu/...``, ``opt/.step``) is one that no ``model`` rank splits."""
    return key.split("/", 2)[-1] not in split if key.startswith("opt/.") else key[len("params/"):] not in split


def hold_checkpoint(ranks: list, file: dict, steps: int, failures: list, split=()) -> dict:
    """Adds to ``failures`` unless rank 0 wrote exactly ``step_<steps>.npz``
    (``file``: ``checkpoint_file``'s reading of it), every rank's own leaves
    hash as its (stage, block) cut of that file, and
    the leaves that no rank splits (``split``: the leaves the plan splits over
    ``model``) hash alike on the ranks that hold copies of them: a stage's
    rows on the ranks of its ``pod`` coordinate, every other leaf and the step
    on every rank; returns the figures of the line, the digests dropped."""
    zero = next(r for r in ranks if r["rank"] == 0)["checkpoint"]
    written = [f for f in file["files"] if f.endswith(".npz")]
    if written != [f"step_{steps:08d}.npz"]:
        failures.append((0, "checkpoint files", file["files"]))
        return {"files": file["files"]}
    blocks = file.pop("by_block")
    own = {r["rank"]: r["checkpoint"].pop("own") for r in ranks}
    for r in ranks:
        c = r["coords"]
        want = blocks[f"{c['pod']}/{c['model'] if split else 0}"]
        if own[r["rank"]] != want:
            failures.append((r["rank"], "checkpoint", sorted(k for k in want if own[r["rank"]].get(k) != want[k])[:8]))
        r["checkpoint"]["leaves_held"] = len(own[r["rank"]])
        for q in ranks:
            same_stage = q["coords"]["pod"] == c["pod"]
            differ = sorted(k for k, v in own[r["rank"]].items()
                            if whole_key(k, split) and (same_stage or "/layers/" not in f"/{k}")
                            and own[q["rank"]].get(k) != v)
            if differ:
                failures.append((r["rank"], q["rank"], "copies differ", differ[:8]))
    return {"file": written, "file_bytes": file["file_bytes"], "saves": zero["saves"], "load_s": file["load_s"],
            "file_digest_s": file["file_digest_s"], "checked_in": "the parent, beside the ranks' later runs",
            "leaves_by_block": {k: len(v) for k, v in blocks.items()},
            "gather_s": {r["rank"]: r["checkpoint"]["gather_s"] for r in ranks},
            "own_digest_s": {r["rank"]: r["checkpoint"]["own_digest_s"] for r in ranks},
            "copies_bit_equal": not any("copies differ" in f for f in failures),
            "held": "the file, loaded and cut into stages (stage_params) and blocks (shard_params), hashes as every "
                    "rank's own state (SHA-256 a leaf); the leaves no rank splits hash alike wherever they are copies"}


# ---------------------------------------------------------------------------
# phase train_dp: data parallelism on the plain step (slice 7d), ranks sharing the card
# ---------------------------------------------------------------------------

# GPT-A at full width with 2 of its 24 layers on a (data, model) = (2, 1) mesh:
# two gloo ranks that share the card, each the whole model's f32 state
DP_MESH = ((2, 1), ("data", "model"))
DP_LAYERS, DP_STEPS, DP_BATCH = 2, 1, 8
DP_REDUCED = {"num_layers": "24 -> 2", "why": "two ranks share the card, each holding the whole model's f32 "
              "parameters, gradients and moments: 13.0 GB a rank at 2 layers, 83.9 GB at 24; cut from 4 layers "
              "to pay for the pipelined RWKV-6, DeepSeek-V2-Lite and Zamba2 runs within the script's budget",
              **STEPS_CUT}


def dp_rank(rank: int, world: int, cfg) -> dict:
    """One rank of the data-parallel run on the card: joins the (2, 1) mesh,
    makes the whole model from the seed, holds one ``DataParallelLoss`` call
    on the first batch (this rank's half of its rows) against
    ``accumulated_value_and_grad`` over the same batch in 2 chunks (in each
    rank), then trains DP_STEPS steps through ``launch.train.train`` on the
    mesh, counting the kernels' launches from zero, and hashes its final
    parameters and moments.  Returns its results."""
    mesh = rank_mesh(*DP_MESH)
    model = build_model(cfg)
    b0 = next(make_batches(cfg, DataConfig(seed=SEED, batch_size=DP_BATCH, seq_len=TRAIN_SEQ)))
    b0 = {k: torch.from_numpy(v).to("cuda") for k, v in b0.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    whole = model.init(gen)
    ref_loss, _, ref = accumulated_value_and_grad(model.loss, whole, b0, accum_steps=DP_MESH[0][0])
    loss_fn = DataParallelLoss(model.loss, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = loss_fn(whole, b0)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    gaps = {p: float((g - ref[p]).abs().max()) / max(float(ref[p].abs().max()), 1e-30) for p, g in grads.items()}
    worst = max(gaps, key=gaps.get)
    out = {"rank": rank, "coords": mesh.coords, "parity": {
        "loss": float(loss), "ref_loss": float(ref_loss),
        "loss_rel_diff": abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)),
        "grad_max_diff_over_max": gaps[worst], "worst_leaf": worst,
        "bit_equal": bool(torch.equal(loss, ref_loss) and all(torch.equal(g, ref[p]) for p, g in grads.items())),
        "finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
        "call_seconds": call_s, "bytes": loss_fn.transport.counts(), "transport_seconds": loss_fn.transport.times()}}
    del whole, grads, ref, loss_fn
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    res = train(cfg, steps=DP_STEPS, batch=DP_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, seed=SEED, log_every=DP_STEPS,
                device="cuda", mesh=mesh)
    hist = res["history"]
    out["train"] = {"counters": read_counters(), "losses": [h["loss"] for h in hist],
                    "grad_norms": [h["grad_norm"] for h in hist], "step_ms": [h["seconds"] * 1e3 for h in hist],
                    "bytes": [h["bytes"] for h in hist], "transport_seconds": [h["transport_seconds"] for h in hist],
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(), "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["digests"] = leaf_digests({"params": res["params"], "opt": res["opt_state"]})
    out["digest_s"] = time.perf_counter() - t0
    return out


def dp_job() -> Job:
    """Phase train_dp as a run of the two ranks' spawn: GPT-A at full width
    with DP_LAYERS layers on DP_MESH (``dp_rank``, ``hold_dp``)."""
    cfg = train_config(DP_LAYERS, torch.bfloat16)
    return Job(dp_rank, (cfg,), functools.partial(hold_dp, cfg))


def hold_dp(cfg, ranks: list, spawn: dict) -> dict:
    """Phase train_dp's line for ``dp_rank``'s ranks: raises unless each
    rank's DP call is within PIPE_TOL of accumulation over the same chunks,
    the trained run's first loss is that call's, its losses are finite, the
    counters show exactly ``train_owed`` a rank a step, and the two replicas'
    parameters and moments are bit-equal after the steps.  Prints the
    ``data`` all-reduce's bytes and seconds a step; returns the counters
    summed over the ranks."""
    owed = train_owed(2 * DP_LAYERS, DP_LAYERS)
    want = {k: DP_STEPS * v for k, v in owed.items()}
    failures, total, first = [], dict.fromkeys(want, 0), ranks[0]["digests"]
    for r in ranks:
        p, t = r["parity"], r["train"]
        if not (p["finite"] and p["loss_rel_diff"] <= PIPE_TOL["loss_rel"] and p["grad_max_diff_over_max"] <= PIPE_TOL["grad"]):
            failures.append((r["rank"], "parity", p))
        if not all(np.isfinite(t["losses"])) or t["losses"][0] != p["loss"]:
            failures.append((r["rank"], "losses", t["losses"], p["loss"]))
        if t["counters"] != want:
            failures.append((r["rank"], "counters", t["counters"], want))
        for k, v in t["counters"].items():
            total[k] += v
        if r["digests"] != first:
            failures.append((r["rank"], "replicas differ", sorted(k for k, v in r["digests"].items()
                                                                 if first.get(k) != v)[:8]))
        steps = [h["data"]["all_reduce"] for h in t.pop("bytes")]
        secs = [h["data"]["all_reduce"] for h in t.pop("transport_seconds")]
        t["data_all_reduce_bytes_per_step"] = [b - a for a, b in zip([0] + steps, steps)]
        t["data_all_reduce_seconds_per_step"] = [b - a for a, b in zip([0.0] + secs, secs)]
        r["leaves_hashed"] = len(r.pop("digests"))
    emit({"phase": "train_dp", "model": cfg.name, "reduced": DP_REDUCED, "mesh": dict(zip(DP_MESH[1], DP_MESH[0])),
          "layers": cfg.num_layers, "batch": DP_BATCH, "seq": TRAIN_SEQ, "steps": DP_STEPS, "lr": TRAIN_LR,
          "reference": f"make_train_step(model.loss, accum_steps={DP_MESH[0][0]}) on the same parameters, in each rank",
          "tol": PIPE_TOL, "replicas_bit_equal": not any(f[1] == "replicas differ" for f in failures),
          "spawn": spawn, "counters_per_step": owed, "note": "the ranks share one card", "ranks": ranks})
    if failures:
        raise AssertionError(f"train_dp: {failures}")
    return {f"train_dp {cfg.name} 2x1": total}


# ---------------------------------------------------------------------------
# phase train_tp: tensor parallelism over model on the plain step (slice 7b-i)
# ---------------------------------------------------------------------------

# GPT-A at full width with 2 of its 24 layers on a (data, model) = (2, 2) mesh:
# four gloo ranks that share the card, each holding its shards under the
# reference's placement plan (every matrix halved: 407,392,256 of the
# 814,764,032 parameters, 6.52 GB of f32 parameters, gradients and moments)
TP_MESH = ((2, 2), ("data", "model"))
TP_LAYERS, TP_STEPS, TP_BATCH = 2, 1, 8
TP_REDUCED = {"num_layers": "24 -> 2", "why": "four ranks share the card's 80 GB: each makes the whole model "
              "(3.26 GB of f32 parameters at 2 layers) and the one-process step on it before it cuts its shards "
              "and trains them; cut from 4 layers to pay for the pipelined RWKV-6, DeepSeek-V2-Lite and Zamba2 "
              "runs within the script's budget", **STEPS_CUT}
TP_TOL = TRAIN_PARITY_TOL["bf16"]  # the port's bf16 kernel path against the plain one, loss and a leaf in norm
TP_CHECK = "tp_gpt_a_2x2"  # the dry-run's prediction of rank 0's held call
# FSDP over data on the same ranks (slice 7f): the reference's plan with fsdp
# on halves 8 of GPT-A's 11 leaves again on data (the FFN, the attention's
# four projections, embed and lm_head); the norms stay whole
FSDP_CHECK = "fsdp_gpt_a_2x2"  # the dry-run's prediction of rank 0's held FSDP call


def tp_rank(rank: int, world: int, cfg, predicted) -> dict:
    """One rank of the tensor-parallel run on the card: joins TP_MESH, makes
    the whole model from the seed and the plain one-process step's loss and
    gradients on the whole first batch (``accumulated_value_and_grad``), keeps
    its blocks of those and its shards of the model (``shard_params``), holds
    one ``DataParallelLoss`` call with the plan on the first batch (rank 0's
    against its dry-run, ``hold_dryrun``) and sums, leaf by leaf, its gradient
    blocks' squared differences from the reference's and the reference's
    squares; then trains TP_STEPS steps
    through ``launch.train.train`` on the mesh, counting the kernels' launches
    from zero, and hashes its final shards and moments.  Then the same with
    FSDP over ``data`` on top (``fsdp_run``), held against what the
    tensor-parallel call and training left, cut to the rank's ``data``
    blocks.  Returns its results."""
    mesh = rank_mesh(*TP_MESH)
    model, plan = build_model(cfg), model_plan(cfg, mesh)
    specs = flatten(plan)
    fplan = model_plan(cfg, mesh, fsdp=True)

    b0 = next(make_batches(cfg, DataConfig(seed=SEED, batch_size=TP_BATCH, seq_len=TRAIN_SEQ)))
    b0 = {k: torch.from_numpy(v).to("cuda") for k, v in b0.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    whole = model.init(gen)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    r_loss, _, r_grads = accumulated_value_and_grad(model.loss, whole, b0)
    ref = {p: local_block(g, specs[p], mesh).clone() for p, g in r_grads.items()}
    reference = {"loss": float(r_loss), "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                 "seconds": time.perf_counter() - t0}
    del r_grads
    params = shard_params(convert_tree_map(lambda t: t.detach(), whole), mesh, plan)
    del whole
    release()
    loss_fn = DataParallelLoss(model.loss, mesh, plan=plan)
    held = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if rank == 0:
        held, (loss, grads) = hold_dryrun(f"{cfg.name} tensor-parallel call, rank 0 of 2x2", TP_CHECK,
                                          predicted[TP_CHECK], lambda: loss_fn(params, b0), (params, b0),
                                          backward=True, transport=loss_fn.transport)
    else:
        loss, grads = loss_fn(params, b0)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    out = {"rank": rank, "coords": mesh.coords, "reference": reference,
           "local_heads": params["layers"]["attn"]["wq"].shape[-1] // cfg.resolved_head_dim,
           "split": sorted(p for p, spec in specs.items() if is_split(spec)),
           "parity": {"loss": float(loss), "sums": leaf_sums(grads, ref),
                      "finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
                      "call_seconds": call_s, "bytes": loss_fn.transport.counts(),
                      "transport_seconds": loss_fn.transport.times(), "dryrun": held}}
    tp_call = {"loss": loss.detach().cpu(), "grads": on_data(grads, fplan, mesh),
               "model_bytes": loss_fn.transport.counts()["model"]}
    del params, grads, loss_fn, ref
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    res = train(cfg, steps=TP_STEPS, batch=TP_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, seed=SEED, log_every=TP_STEPS,
                device="cuda", mesh=mesh)
    hist = res["history"]
    out["train"] = {"counters": read_counters(), "losses": [h["loss"] for h in hist],
                    "grad_norms": [h["grad_norm"] for h in hist], "step_ms": [h["seconds"] * 1e3 for h in hist],
                    "bytes": [h["bytes"] for h in hist], "transport_seconds": [h["transport_seconds"] for h in hist],
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(), "seconds": time.perf_counter() - t0}
    out["digests"] = leaf_digests({"params": res["params"], "opt": res["opt_state"]})
    out["train"]["state_bytes"] = 16 * sum(t.numel() for t in flatten(res["params"]).values())
    tp_final = state_on_data(res, fplan, mesh)
    del res
    release()
    out["fsdp"] = fsdp_run(rank, mesh, cfg, fplan, b0, predicted[FSDP_CHECK], tp_call, tp_final)
    return out


def fsdp_run(rank: int, mesh, cfg, fplan, b0, predicted: dict, tp_call: dict, tp_final: dict) -> dict:
    """FSDP over ``data`` on a rank of TP_MESH (slice 7f): the whole model
    made from the seed again and cut by ``fplan``, the plan with fsdp on (each
    rank its ``data`` block of its ``model`` shard of 8 of the 11 leaves);
    one ``DataParallelLoss`` call on the first batch ``b0`` (rank 0's held
    against its dry-run), its loss and gradient blocks against the
    tensor-parallel call's cut to the same blocks (``tp_call``:
    ``against_blocks``); then TP_STEPS steps over that loss and the final
    blocks and moments against the tensor-parallel run's (``tp_final``:
    ``train_held``)."""
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    whole = model.init(gen)
    params = shard_params(whole, mesh, fplan)
    del whole
    release()
    loss_fn = DataParallelLoss(model.loss, mesh, plan=fplan)
    held = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if rank == 0:
        held, (loss, grads) = hold_dryrun(f"{cfg.name} FSDP call, rank 0 of 2x2", FSDP_CHECK, predicted,
                                          lambda: loss_fn(params, b0), (params, b0), backward=True,
                                          transport=loss_fn.transport)
    else:
        loss, grads = loss_fn(params, b0)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    parity = {"loss": float(loss), "tp_loss": float(tp_call["loss"]),
              **against_blocks(loss, grads, tp_call["loss"], tp_call["grads"]),
              "finite": all(bool(torch.isfinite(g).all()) for g in grads.values()), "call_seconds": call_s,
              "bytes": loss_fn.transport.counts(), "transport_seconds": loss_fn.transport.times(),
              "model_bytes_as_tp": loss_fn.transport.counts()["model"] == tp_call["model_bytes"], "dryrun": held}
    out = {"parity": parity, "split_over_data": sorted(split_paths(fplan, "data"))}
    del grads, loss_fn
    release()
    n = sum(t.numel() for t in flatten(params).values())
    out["params"], out["state_bytes"] = n, 16 * n  # f32 parameters, gradients and two moments
    out["train"], out["state"] = train_held(DataParallelLoss(model.loss, mesh, plan=fplan), params, cfg,
                                            steps=TP_STEPS, batch=TP_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, want=tp_final)
    return out


def against_blocks(loss, grads: dict, want_loss, want_grads: dict) -> dict:
    """A call's loss and gradient blocks against another's cut to the same
    blocks (``want_*``, on the host): bit for bit, and each leaf's relative
    gap in norm."""
    gaps, equal = {}, []
    for p, g in grads.items():
        want = want_grads[p].to("cuda")
        gaps[p] = float((g.float() - want.float()).norm()) / max(float(want.float().norm()), 1e-30)
        equal.append(bool(torch.equal(g, want)))
    worst = max(gaps, key=gaps.get)
    return {"loss_bit_equal": bool(torch.equal(loss.detach().cpu(), want_loss)), "grads_bit_equal": all(equal),
            "leaves_bit_equal": sum(equal), "leaves": len(equal), "grad_rel_diff_worst": gaps[worst],
            "worst_leaf": worst}


def train_held(loss_fn, params, cfg, *, steps: int, batch: int, seq: int, lr: float, want: dict) -> tuple:
    """``steps`` steps of ``make_train_step`` over ``loss_fn`` (a
    ``DataParallelLoss`` or ``PipelineLoss`` of this rank) from ``params``, on
    the batches ``launch.train.train`` takes, at its schedule, the kernels'
    launches counted from zero: (the run's figures, its final blocks and
    moments against ``want``'s, flat trees on the host, each leaf bit-equal or
    its max |diff| over max |want|)."""
    step = make_train_step(loss_fn, optimizer_config(lr, steps))
    opt = init_opt_state(params)
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    hist = []
    for b in make_batches(cfg, DataConfig(seed=SEED, batch_size=batch, seq_len=seq), num_steps=steps):
        b = {k: torch.from_numpy(v).to("cuda") for k, v in b.items()}
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        hist.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "ms": (time.perf_counter() - t0) * 1e3, "bytes": loss_fn.transport.counts(),
                     "seconds": loss_fn.transport.times()})
    train_line = {"counters": read_counters(), "losses": [h["loss"] for h in hist],
                  "grad_norms": [h["grad_norm"] for h in hist], "step_ms": [h["ms"] for h in hist],
                  "bytes": [h["bytes"] for h in hist], "transport_seconds": [h["seconds"] for h in hist],
                  "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    final = {"params": {p: t.detach() for p, t in flatten(params).items()}, "mu": flatten(opt.mu),
             "nu": flatten(opt.nu)}
    state = {}
    for part, tree in final.items():
        for p, t in tree.items():
            w = want[part][p].to("cuda")
            state[f"{part}/{p}"] = [bool(torch.equal(t, w)),
                                    float((t.float() - w.float()).abs().max()) / max(float(w.abs().max()), 1e-30)]
    worst = max(state, key=lambda k: state[k][1])
    return train_line, {"bit_equal": sum(v[0] for v in state.values()), "leaves": len(state), "worst": worst,
                        "max_diff_over_max": state[worst][1]}


def per_step(cumulative: list) -> list:
    """Each step's share of ``Transport`` counters read after every step: by axis and op."""
    prev, out = {}, []
    for c in cumulative:
        out.append({a: {op: v - prev.get(a, {}).get(op, 0) for op, v in ops.items()} for a, ops in c.items()})
        prev = c
    return out


def leaf_gaps(ranks: list, key, split: set, stack=None) -> dict:
    """Each leaf's relative gap in norm of the ranks' ``key`` call (its name
    in a rank's results, or a function of them) from its reference, from
    their ``sums`` (a leaf's squared differences and the reference's squares)
    over the ranks of ``data`` 0: a split leaf's blocks from every ``model``
    rank, a whole leaf from ``model`` 0; in the pipeline's stages (``stack``:
    the stack's key) a stage's rows from every ``pod`` rank and every other
    leaf from ``pod`` 0."""
    part = key if callable(key) else (lambda r: r[key])
    leaves = {}
    for r in ranks:
        c = r["coords"]
        for leaf, (d, w) in part(r)["sums"].items():
            if c["data"] == 0 and (leaf in split or c["model"] == 0) and (
                    stack is None or leaf.split("/", 1)[0] == stack or c["pod"] == 0):
                acc = leaves.setdefault(leaf, [0.0, 0.0])
                acc[0], acc[1] = acc[0] + d, acc[1] + w
    return {leaf: math.sqrt(d) / max(math.sqrt(w), 1e-30) for leaf, (d, w) in leaves.items()}


def tp_job(started) -> Job:
    """Phase train_tp (with train_fsdp) as a run of the four ranks' spawn:
    GPT-A at full width with TP_LAYERS layers on TP_MESH (``tp_rank``,
    ``hold_tp``)."""
    cfg = train_config(TP_LAYERS, torch.bfloat16)
    predicted = {k: predictions(started)[k] for k in (TP_CHECK, FSDP_CHECK)}
    return Job(tp_rank, (cfg, predicted), functools.partial(hold_tp, cfg))


def hold_tp(cfg, ranks: list, spawn: dict) -> dict:
    """Phase train_tp's line for ``tp_rank``'s ranks, tensor-parallel over
    ``model``: raises unless (a) each rank's step 0 loss
    and every gradient leaf, gathered whole, are within TP_TOL of the plain
    one-process step on the same batch (computed in each rank), (b)
    the trained run's first loss is that call's, (c) the counters show
    exactly ``train_owed`` a rank a step, with K2 on the rank's 16 heads, and
    (d) the two ``data`` replicas of each ``model`` index are bit-equal after
    the steps and the leaves the plan leaves whole bit-equal on all four
    ranks; rank 0's call is held against its dry-run.  Prints each rank's
    step ms, peak, and bytes and seconds a step by axis and op; then phase
    train_fsdp's (``hold_fsdp``).  Returns the counters summed over the
    ranks, by path."""
    fsdp_runs = {r["rank"]: r.pop("fsdp") for r in ranks}  # phase train_fsdp's (hold_fsdp)
    owed = train_owed(2 * TP_LAYERS, TP_LAYERS)
    want = {k: TP_STEPS * v for k, v in owed.items()}
    split = set(ranks[0]["split"])
    failures, total = [], dict.fromkeys(want, 0)
    gaps = leaf_gaps(ranks, "parity", split)
    for r in ranks:
        p, t = r["parity"], r["train"]
        reference = r["reference"]
        p["loss_rel_diff"] = abs(p["loss"] - reference["loss"]) / abs(reference["loss"])
        if not (p["finite"] and p["loss_rel_diff"] <= TP_TOL["loss_rel"]):
            failures.append((r["rank"], "loss", p["loss"], reference["loss"]))
        p.pop("sums")
        if p["dryrun"]:
            DRYRUN_LINES.append(p["dryrun"])
            failures += [(r["rank"], "dryrun", p["dryrun"]["failures"])] if p["dryrun"]["failures"] else []
        elif r["rank"] == 0:
            failures.append((0, "dryrun", "the held call was not checked"))
        if r["local_heads"] != cfg.num_heads // TP_MESH[0][1]:
            failures.append((r["rank"], "heads", r["local_heads"]))
        if not all(np.isfinite(t["losses"])) or t["losses"][0] != p["loss"]:
            failures.append((r["rank"], "losses", t["losses"], p["loss"]))
        if t["counters"] != want:
            failures.append((r["rank"], "counters", t["counters"], want))
        for k, v in t["counters"].items():
            total[k] += v
        t["bytes_per_step"] = per_step(t.pop("bytes"))
        t["transport_seconds_per_step"] = per_step(t.pop("transport_seconds"))
    worst = max(gaps, key=gaps.get)
    if gaps[worst] > TP_TOL["grad_rel"] or len(gaps) != len(expected_shapes(cfg)):
        failures.append(("grads", worst, gaps[worst], len(gaps)))

    digests = {r["rank"]: r.pop("digests") for r in ranks}
    coords = {r["rank"]: r["coords"] for r in ranks}
    for a in digests:
        for b in digests:
            same_model = coords[a]["model"] == coords[b]["model"]
            differ = sorted(k for k, v in digests[a].items() if digests[b][k] != v and (same_model or whole_key(k, split)))
            if differ:
                failures.append((a, b, "replicas differ", differ[:8]))
    emit({"phase": "train_tp", "model": cfg.name, "reduced": TP_REDUCED, "mesh": dict(zip(TP_MESH[1], TP_MESH[0])),
          "layers": cfg.num_layers, "batch": TP_BATCH, "seq": TRAIN_SEQ, "steps": TP_STEPS, "lr": TRAIN_LR,
          "reference": {"what": "make_train_step(model.loss)'s loss and gradients on the same parameters and "
                                "global batch, the whole model in one process: each rank before it cuts its shards",
                        "loss": [r["reference"]["loss"] for r in ranks]},
          "tol": TP_TOL, "grad_rel_diff": {"worst_leaf": worst, "worst": gaps[worst], "by_leaf": gaps},
          "split_leaves": len(split), "replicas_bit_equal": not any("replicas differ" in f for f in failures),
          "spawn": spawn, "counters_per_step": owed, "note": "the ranks share one card", "ranks": ranks})
    if failures:
        raise AssertionError(f"train_tp: {failures}")
    return {f"train_tp {cfg.name} 2x2": total, f"train_fsdp {cfg.name} 2x2": hold_fsdp(cfg, ranks, fsdp_runs, owed)}


def hold_fsdp(cfg, ranks: list, fsdp_runs: dict, owed: dict) -> dict:
    """Phase ``train_fsdp``: the FSDP runs of ``tp_rank``'s ranks
    (``fsdp_run``, ``fsdp_runs`` by rank; ``ranks`` their tensor-parallel
    results).  Raises unless each rank's loss and gradient blocks are
    within TP_TOL of the tensor-parallel call's (bit-equal is the
    prediction), its ``model`` bytes are the tensor-parallel call's, the
    trained run's first loss is that call's and its losses finite, the
    counters show exactly ``owed`` a step, its final blocks and moments are
    within PIPE_TOL["grad"] of the tensor-parallel run's (the clip's norm is
    summed in another order), and its peak is below the tensor-parallel
    run's; rank 0's call is held against its dry-run.  Prints each rank's
    bytes and seconds a step by axis and op beside the tensor-parallel run's,
    its parameters, f32 state and peak; returns the counters summed over the
    ranks."""
    want = {k: TP_STEPS * v for k, v in owed.items()}
    failures, total = [], dict.fromkeys(want, 0)
    for r in ranks:
        f = fsdp_runs[r["rank"]]
        p, t = f["parity"], f["train"]
        p["loss_rel_diff"] = abs(p["loss"] - p["tp_loss"]) / abs(p["tp_loss"])
        if not (p["finite"] and p["loss_rel_diff"] <= TP_TOL["loss_rel"]
                and p["grad_rel_diff_worst"] <= TP_TOL["grad_rel"]):
            failures.append((r["rank"], "against tensor parallelism", p))
        if not p["model_bytes_as_tp"]:
            failures.append((r["rank"], "model bytes", p["bytes"]["model"]))
        if p["dryrun"]:
            DRYRUN_LINES.append(p["dryrun"])
            failures += [(r["rank"], "dryrun", p["dryrun"]["failures"])] if p["dryrun"]["failures"] else []
        elif r["rank"] == 0:
            failures.append((0, "dryrun", "the held call was not checked"))
        if not all(np.isfinite(t["losses"])) or t["losses"][0] != p["loss"]:
            failures.append((r["rank"], "losses", t["losses"], p["loss"]))
        if t["counters"] != want:
            failures.append((r["rank"], "counters", t["counters"], want))
        for k, v in t["counters"].items():
            total[k] += v
        if f["state"]["max_diff_over_max"] > PIPE_TOL["grad"]:
            failures.append((r["rank"], "state against tensor parallelism", f["state"]))
        f["peak_vs_tp"] = {"fsdp": t["peak_memory_bytes"], "tp": r["train"]["peak_memory_bytes"]}
        if not t["peak_memory_bytes"] < r["train"]["peak_memory_bytes"]:
            failures.append((r["rank"], "peak not below tensor parallelism's", f["peak_vs_tp"]))
        f["state_bytes_vs_tp"] = {"fsdp": f["state_bytes"], "tp": r["train"]["state_bytes"]}
        t["bytes_per_step"] = per_step(t.pop("bytes"))
        t["transport_seconds_per_step"] = per_step(t.pop("transport_seconds"))
        f["data_per_step_vs_tp"] = [{"fsdp_bytes": fb["data"], "fsdp_seconds": fs["data"], "tp_bytes": tb["data"],
                                     "tp_seconds": ts["data"]}
                                    for fb, fs, tb, ts in zip(t["bytes_per_step"], t["transport_seconds_per_step"],
                                                              r["train"]["bytes_per_step"],
                                                              r["train"]["transport_seconds_per_step"])]
    emit({"phase": "train_fsdp", "model": cfg.name, "reduced": TP_REDUCED, "mesh": dict(zip(TP_MESH[1], TP_MESH[0])),
          "layers": cfg.num_layers, "batch": TP_BATCH, "seq": TRAIN_SEQ, "steps": TP_STEPS, "lr": TRAIN_LR,
          "plan": "model_plan(cfg, mesh, fsdp=True): the reference's make_param_shardings(fsdp=True), 4 MiB",
          "split_over_data": fsdp_runs[0]["split_over_data"],
          "reference": "the tensor-parallel call and run of phase train_tp on the same ranks, cut to each rank's data "
                       "blocks", "tol": TP_TOL, "state_tol": PIPE_TOL["grad"], "counters_per_step": owed,
          "note": "the ranks share one card", "ranks": [{"rank": r["rank"], "coords": r["coords"],
                                                        **fsdp_runs[r["rank"]]} for r in ranks]})
    if failures:
        raise AssertionError(f"train_fsdp: {failures}")
    return total


# ---------------------------------------------------------------------------
# phase train_tp_moe: the MoE and MLA families split over model (slice 7b-ii)
# ---------------------------------------------------------------------------

# DeepSeek-V2-Lite at full width with 2 of its 27 layers on (data, model) =
# (2, 2): four gloo ranks that share the card.  The plan splits the 64 experts
# on their expert dim (32 a rank), MLA by heads (8 of 16 a rank), the shared
# expert's matrices on their first dim, embed on its features and lm_head on
# the vocabulary: 795,879,424 of the 1,589,127,168 parameters a rank, 12.73 GB
# of f32 parameters, gradients and moments.  MLA attends in plain f32, as the
# reference's, so K1 is the only kernel on the path.
TP_MOE_ARCH, TP_MOE_LAYERS, TP_MOE_STEPS, TP_MOE_BATCH = "deepseek_v2_lite_16b", 2, 1, 8
TP_MOE_REDUCED = {"num_layers": "27 -> 2", "why": "four ranks share the card's 80 GB: each makes the whole model "
                  "(6.36 GB of f32 parameters at 2 layers) from the seed and holds the replicated control's whole "
                  "gradients beside it before it cuts its shards", **STEPS_CUT}
TP_MOE_CHECK = "tp_moe_deepseek_2x2"  # the dry-run's prediction of rank 0's pinned tensor-parallel call


def tp_moe_config():
    return train_config(TP_MOE_LAYERS, torch.bfloat16, TP_MOE_ARCH)


def leaf_sums(grads: dict, ref: dict) -> dict:
    """Each leaf's sum of squared differences from ``ref``'s block and ``ref``'s sum of squares."""
    return {p: [float((g.float() - ref[p].float()).square().sum()), float(ref[p].float().square().sum())]
            for p, g in grads.items()}


def tp_moe_rank(rank: int, world: int, cfg, predicted) -> dict:
    """One rank of the MoE run on the card: joins TP_MESH, makes the whole
    model from the seed and runs the replicated ``DataParallelLoss`` call on
    it (no plan, the control), recording its routes (``route_log``: the
    forward's and remat's recomputation's calls in order), and keeps the
    control's block of each gradient; frees the whole model and keeps its
    shards (``shard_params``); then makes the tensor-parallel call pinned to
    the control's routes (rank 0's against its dry-run, ``hold_dryrun``) and
    one unpinned, and sums, leaf by leaf, each's squared differences from the
    control's blocks.  Then it trains TP_MOE_STEPS steps through
    ``launch.train.train`` on the mesh, counting the kernels' launches from
    zero, and hashes its final shards and moments.  Returns its results."""
    mesh = rank_mesh(*TP_MESH)
    model, plan = build_model(cfg), model_plan(cfg, mesh)
    specs = flatten(plan)
    b0 = next(make_batches(cfg, DataConfig(seed=SEED, batch_size=TP_MOE_BATCH, seq_len=TRAIN_SEQ)))
    b0 = {k: torch.from_numpy(v).to("cuda") for k, v in b0.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    whole = model.init(gen)
    t0 = time.perf_counter()
    with route_log() as routes:
        c_loss, c_grads = DataParallelLoss(model.loss, mesh)(whole, b0)
    torch.cuda.synchronize()
    control = {"loss": float(c_loss), "call_seconds": time.perf_counter() - t0,
               "finite": all(bool(torch.isfinite(g).all()) for g in c_grads.values()),
               "peak_memory_bytes": torch.cuda.max_memory_allocated(), "route_calls": len(routes)}
    ref = {p: local_block(g, specs[p], mesh).clone() for p, g in c_grads.items()}
    del c_grads
    params = shard_params(whole, mesh, plan)
    del whole
    release()
    loss_fn = DataParallelLoss(model.loss, mesh, plan=plan)
    held = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with route_log(routes) as replayed:
        if rank == 0:
            held, (loss, grads) = hold_dryrun(f"{cfg.name} tensor-parallel call, rank 0 of 2x2, pinned",
                                              TP_MOE_CHECK, predicted, lambda: loss_fn(params, b0), (params, b0),
                                              backward=True, transport=loss_fn.transport)
        else:
            loss, grads = loss_fn(params, b0)
    torch.cuda.synchronize()
    out = {"rank": rank, "coords": mesh.coords, "control": control,
           "local_heads": params["layers"]["attn"]["wq"].shape[-1] // sum(
               (cfg.mla.qk_nope_head_dim, cfg.mla.qk_rope_head_dim)),
           "local_experts": params["layers"]["moe"]["w_gate"].shape[1],
           "shard_params": sum(t.numel() for t in flatten(params).values()),
           "split": sorted(split_paths(plan)),
           "parity": {"loss": float(loss), "sums": leaf_sums(grads, ref), "route_calls": len(replayed),
                      "finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
                      "call_seconds": time.perf_counter() - t0, "bytes": loss_fn.transport.counts(),
                      "transport_seconds": loss_fn.transport.times(), "dryrun": held}}
    del grads, loss_fn
    release()
    with route_log() as free:
        u_loss, u_grads = DataParallelLoss(model.loss, mesh, plan=plan)(params, b0)
    out["unpinned"] = {"loss": float(u_loss), "sums": leaf_sums(u_grads, ref),
                       "route_agreement": route_agreement(free, routes)}
    del params, u_grads, ref, routes, free
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    res = train(cfg, steps=TP_MOE_STEPS, batch=TP_MOE_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR, seed=SEED,
                log_every=TP_MOE_STEPS, device="cuda", mesh=mesh)
    hist = res["history"]
    out["train"] = {"counters": read_counters(), "losses": [h["loss"] for h in hist],
                    "grad_norms": [h["grad_norm"] for h in hist], "step_ms": [h["seconds"] * 1e3 for h in hist],
                    "bytes": [h["bytes"] for h in hist], "transport_seconds": [h["transport_seconds"] for h in hist],
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(), "seconds": time.perf_counter() - t0}
    out["digests"] = leaf_digests({"params": res["params"], "opt": res["opt_state"]})
    return out


def tp_moe_job(started) -> Job:
    """Phase train_tp_moe as a run of the four ranks' spawn: DeepSeek-V2-Lite
    at full width with TP_MOE_LAYERS layers on TP_MESH (``tp_moe_rank``,
    ``hold_tp_moe``)."""
    cfg = tp_moe_config()
    return Job(tp_moe_rank, (cfg, predictions(started)[TP_MOE_CHECK]), functools.partial(hold_tp_moe, cfg))


def hold_tp_moe(cfg, ranks: list, spawn: dict) -> dict:
    """Phase train_tp_moe's line for ``tp_moe_rank``'s ranks, DeepSeek-V2-Lite's
    experts, MLA's heads and its shared expert split over ``model``: raises
    unless (a) each rank's tensor-parallel call,
    pinned to the routes of the replicated control on the same rank, has its
    loss and every gradient leaf, put together from the ranks, within TP_TOL
    of the control's, with 8 of 16 heads and 32 of 64 experts a rank, (b)
    the trained run's first loss is the unpinned call's, (c) the counters show
    exactly ``train_owed`` a rank a step (K1 forward and backward alone), and
    (d) the two ``data`` replicas of each ``model`` index are bit-equal after
    the steps and the leaves the plan leaves whole bit-equal on all four
    ranks; rank 0's pinned call is held against its dry-run.  The unpinned
    call's gaps and route agreement are reported, held to nothing (top-k
    routing turns a near-tie into a different expert: ``serve_moe_parity``).
    Prints each rank's step ms, peak, and bytes and seconds a step by axis and
    op; returns the counters summed over the ranks."""
    owed = train_owed(2 * TP_MOE_LAYERS, 0)
    want = {k: TP_MOE_STEPS * v for k, v in owed.items()}
    split = set(ranks[0]["split"])
    TP = TP_MESH[0][1]
    failures, total = [], dict.fromkeys(want, 0)
    for r in ranks:
        c, p, u, t = r["control"], r["parity"], r["unpinned"], r["train"]
        p["loss_rel_diff"] = abs(p["loss"] - c["loss"]) / abs(c["loss"])
        u["loss_rel_diff"] = abs(u["loss"] - c["loss"]) / abs(c["loss"])
        if not (c["finite"] and p["finite"] and p["loss_rel_diff"] <= TP_TOL["loss_rel"]):
            failures.append((r["rank"], "loss", p["loss"], c["loss"]))
        if p["route_calls"] != c["route_calls"] or c["route_calls"] != 2 * TP_MOE_LAYERS:
            failures.append((r["rank"], "routes", c["route_calls"], p["route_calls"]))
        if p["dryrun"]:
            DRYRUN_LINES.append(p["dryrun"])
            failures += [(r["rank"], "dryrun", p["dryrun"]["failures"])] if p["dryrun"]["failures"] else []
        elif r["rank"] == 0:
            failures.append((0, "dryrun", "the held call was not checked"))
        if (r["local_heads"], r["local_experts"]) != (cfg.num_heads // TP, cfg.moe.num_experts // TP):
            failures.append((r["rank"], "heads, experts", r["local_heads"], r["local_experts"]))
        if not all(np.isfinite(t["losses"])) or t["losses"][0] != u["loss"]:
            failures.append((r["rank"], "losses", t["losses"], u["loss"]))
        if t["counters"] != want:
            failures.append((r["rank"], "counters", t["counters"], want))
        for k, v in t["counters"].items():
            total[k] += v
        t["bytes_per_step"] = per_step(t.pop("bytes"))
        t["transport_seconds_per_step"] = per_step(t.pop("transport_seconds"))
    gaps = leaf_gaps(ranks, "parity", split)
    free = leaf_gaps(ranks, "unpinned", split)
    for r in ranks:
        r["parity"].pop("sums")
        r["unpinned"].pop("sums")
    worst, worst_free = max(gaps, key=gaps.get), max(free, key=free.get)
    if gaps[worst] > TP_TOL["grad_rel"] or len(gaps) != len(expected_shapes(cfg)):
        failures.append(("grads", worst, gaps[worst], len(gaps)))

    digests = {r["rank"]: r.pop("digests") for r in ranks}
    coords = {r["rank"]: r["coords"] for r in ranks}
    for a in digests:
        for b in digests:
            same_model = coords[a]["model"] == coords[b]["model"]
            differ = sorted(k for k, v in digests[a].items() if digests[b][k] != v and (same_model or whole_key(k, split)))
            if differ:
                failures.append((a, b, "replicas differ", differ[:8]))
    emit({"phase": "train_tp_moe", "model": cfg.name, "reduced": TP_MOE_REDUCED,
          "mesh": dict(zip(TP_MESH[1], TP_MESH[0])), "layers": cfg.num_layers, "batch": TP_MOE_BATCH,
          "seq": TRAIN_SEQ, "steps": TP_MOE_STEPS, "lr": TRAIN_LR,
          "control": "each rank's replicated DataParallelLoss call (no plan) on the whole model, the same mesh and "
                     "batch; the tensor-parallel call replays its routes",
          "tol": TP_TOL, "grad_rel_diff": {"worst_leaf": worst, "worst": gaps[worst], "by_leaf": gaps},
          "unpinned": {"held_to": "nothing", "worst_leaf": worst_free, "worst": free[worst_free], "by_leaf": free,
                       "loss_rel_diff": [r["unpinned"]["loss_rel_diff"] for r in ranks],
                       "route_agreement": [r["unpinned"]["route_agreement"] for r in ranks]},
          "split_leaves": len(split), "replicas_bit_equal": not any("replicas differ" in f for f in failures),
          "spawn": spawn, "counters_per_step": owed, "note": "the ranks share one card", "ranks": ranks})
    if failures:
        raise AssertionError(f"train_tp_moe: {failures}")
    return {f"train_tp_moe {cfg.name} 2x2": total}


# ---------------------------------------------------------------------------
# phase train_tp_recurrent: RWKV-6, the Zamba2 hybrid and the pure Mamba2 stack split over model (7b-iii, 7b-v)
# ---------------------------------------------------------------------------

# Three models at full width on (data, model) = (1, 2), two gloo ranks sharing
# the card, each model in turn: RWKV-6 7B with 2 of its 32 layers, split by
# heads (K4 and its backward on 32 of the 64 heads a rank; the channel mix on
# d_ff and d); Zamba2-2.7B with 6 of its 54 layers (1 group), split as the
# reference's plan places it: w_z and w_x on d, conv_x on 2 of its 4 taps,
# the rest of each Mamba2 layer whole (ROADMAP Queue 3 (p)), the shared block
# at 16 of 32 heads of 80 (K2 and its backward); and the pure Mamba2 stack at
# Zamba2-2.7B's widths (family "ssm", as the reference's _build_ssm builds it)
# with 6 layers, split by heads: 40 of the 80 heads of 64 a rank, w_z, w_x and
# conv_x on d_inner, w_out and norm_scale on their rows, the gated norm's
# statistic summed over model (plain torch: K1 takes whole rows only, so K1
# runs on the layers' `ln` and the final norm alone).  `data` x `model` is
# held by train_tp and train_tp_moe; two ranks keep this phase short.
TP_REC_MESH = ((1, 2), ("data", "model"))
TP_REC_STEPS, TP_REC_BATCH = 1, 4
# arch, layers, lr (the single-process phases'), the dry-run's prediction of
# rank 0's held call, the family where it is not the arch's
TP_REC_MODELS = (("rwkv6_7b", 2, RWKV_TRAIN_LR, "tp_rwkv_1x2", None),
                 ("zamba2_2p7b", 6, HYBRID_TRAIN_LR, "tp_zamba_1x2", None),
                 ("zamba2_2p7b", 6, HYBRID_TRAIN_LR, "tp_pure_1x2", "ssm"))
TP_REC_REDUCED = {"num_layers": "32 -> 2 (rwkv6-7b), 54 -> 6 (zamba2-2.7b: 1 of 9 groups), 54 -> 6 (the pure Mamba2 "
                                "stack at zamba2-2.7b's widths)",
                  "why": "two ranks share the card's 80 GB with the phase's time: each makes the whole model "
                         "(3.90, 1.87 and 1.61 GB of f32 parameters) from the seed and holds the replicated control's "
                         "whole gradients beside it before it cuts its shards; Zamba2 cut from 12 layers to pay for "
                         "the pipelined RWKV-6, DeepSeek-V2-Lite and Zamba2 runs (the pipelined Zamba2 runs 18); the "
                         "pure stack, which no config of the repo is, to Zamba2's 6, to add about a minute to the "
                         "script's 1200 s", **STEPS_CUT}
# The pure stack's f32 call against its f32 control: the split sums d_inner
# over the ranks (w_out's output, the gated norm's statistic) where the
# control sums it on one rank, f32 orders only
TP_PURE_F32_TOL = {"loss_rel": 1e-5, "grad_rel": 1e-3}


def tp_rec_owed(cfg) -> dict:
    """The launches a train step owes on a rank: RWKV-6's two norms and one
    WKV-6 recurrence a block; a Zamba2 group's two norms a Mamba2 layer and
    the shared block's two norms and one attention; the pure stack's one
    norm a layer, its ``ln``: its gated norm's row is split over ``model``,
    which the RMSNorm kernel does not take (``ssm._split_gated_norm``)
    (``train_owed``)."""
    if cfg.rwkv is not None:
        return train_owed(2 * cfg.num_layers, 0, wkvs=cfg.num_layers)
    if cfg.family == "ssm":
        return train_owed(cfg.num_layers, 0)
    G, M = cfg.num_layers // cfg.attn_period, cfg.attn_period - 1
    return train_owed(G * (2 * M + 2), G)


def tp_rec_config(arch: str, layers: int, family=None):
    """``arch`` at full width with ``layers`` layers in bf16 activations, as
    the family ``family`` where given (the pure stack: Zamba2's "ssm"), its
    name then marked with it."""
    cfg = train_config(layers, torch.bfloat16, arch)
    return cfg if family is None else dataclasses.replace(cfg, family=family, name=f"{cfg.name}-{family}")


def tp_rec_layout(cfg, params) -> dict:
    """What a rank holds of the split: its heads (RWKV-6's u; the shared
    block's wq; the pure stack's columns of w_z over head_dim) and the pure
    stack's columns of w_x and conv_x and rows of w_out and norm_scale, or
    the hybrid's rows of w_z and taps of conv_x."""
    if cfg.rwkv is not None:
        return {"heads": params["layers"]["u"].shape[1]}
    if cfg.family == "ssm":
        m = params["layers"]["mamba"]
        return {"heads": m["w_z"].shape[2] // cfg.ssm.head_dim, "w_x_cols": m["w_x"].shape[2],
                "conv_x_cols": m["conv_x"].shape[2], "w_out_rows": m["w_out"].shape[1],
                "norm_scale": m["norm_scale"].shape[1], "A_log": m["A_log"].shape[1]}
    m = params["groups"]["mamba"]["mamba"]
    return {"heads": params["shared_attn"]["attn"]["wq"].shape[-1] // cfg.resolved_head_dim,
            "w_z_rows": m["w_z"].shape[2], "w_x_rows": m["w_x"].shape[2], "conv_x_taps": m["conv_x"].shape[2]}


def tp_rec_model(rank: int, mesh, cfg, lr: float, check: str, predicted) -> dict:
    """One model on this rank: the replicated ``DataParallelLoss`` call on
    the whole model made from the seed (no plan, the control), its block of
    each gradient kept; then the rank's shards (``shard_params``) and the
    tensor-parallel call (rank 0's against its dry-run, ``hold_dryrun``),
    each leaf's squared differences from the control's block summed; for the
    hybrid also, in f32 activations, the replicated and the tensor-parallel
    calls, and both bf16 calls' differences from the replicated f32 call's,
    summed alike; then TP_REC_STEPS steps through
    ``launch.train.train`` on the mesh, counting the kernels' launches from
    zero, and the final shards and moments hashed."""
    model, plan = build_model(cfg), model_plan(cfg, mesh)
    specs = flatten(plan)
    b0 = next(make_batches(cfg, DataConfig(seed=SEED, batch_size=TP_REC_BATCH, seq_len=TRAIN_SEQ)))
    b0 = {k: torch.from_numpy(v).to("cuda") for k, v in b0.items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    whole = model.init(gen)
    t0 = time.perf_counter()
    c_loss, c_grads = DataParallelLoss(model.loss, mesh)(whole, b0)
    torch.cuda.synchronize()
    control = {"loss": float(c_loss), "call_seconds": time.perf_counter() - t0,
               "finite": all(bool(torch.isfinite(g).all()) for g in c_grads.values()),
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    ref = {p: local_block(g, specs[p], mesh).clone() for p, g in c_grads.items()}
    del c_grads
    extra = {}
    if cfg.ssm is not None:  # Mamba2: the replicated call in f32 activations, the same f32 weights
        model32 = build_model(dataclasses.replace(cfg, dtype=torch.float32))
        f_loss, f_grads = DataParallelLoss(model32.loss, mesh)(whole, b0)
        ref32 = {p: local_block(g, specs[p], mesh).clone() for p, g in f_grads.items()}
        del f_grads
        extra = {"f32": {"control_loss": float(f_loss)}, "control_vs_f32": {"sums": leaf_sums(ref, ref32)}}
    params = shard_params(whole, mesh, plan)
    del whole
    release()
    loss_fn = DataParallelLoss(model.loss, mesh, plan=plan)
    held = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if rank == 0:
        held, (loss, grads) = hold_dryrun(f"{cfg.name} tensor-parallel call, rank 0 of 1x2", check, predicted,
                                          lambda: loss_fn(params, b0), (params, b0), backward=True,
                                          transport=loss_fn.transport)
    else:
        loss, grads = loss_fn(params, b0)
    torch.cuda.synchronize()
    out = {"model": cfg.name, "rank": rank, "coords": mesh.coords, "control": control,
           "layout": tp_rec_layout(cfg, params), "shard_params": sum(t.numel() for t in flatten(params).values()),
           "split": sorted(split_paths(plan)),
           "parity": {"loss": float(loss), "sums": leaf_sums(grads, ref),
                      "finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
                      "call_seconds": time.perf_counter() - t0, "bytes": loss_fn.transport.counts(),
                      "transport_seconds": loss_fn.transport.times(), "dryrun": held}, **extra}
    if "f32" in out:
        out["bf16_vs_f32"] = {"sums": leaf_sums(grads, ref32)}
    del grads, loss_fn, ref
    if "f32" in out:
        f_loss, f_grads = DataParallelLoss(model32.loss, mesh, plan=plan)(params, b0)
        out["f32"].update(loss=float(f_loss), sums=leaf_sums(f_grads, ref32))
        del f_grads, ref32
    del params
    release()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    res = train(cfg, steps=TP_REC_STEPS, batch=TP_REC_BATCH, seq=TRAIN_SEQ, lr=lr, seed=SEED,
                log_every=TP_REC_STEPS, device="cuda", mesh=mesh)
    hist = res["history"]
    out["train"] = {"counters": read_counters(), "losses": [h["loss"] for h in hist],
                    "grad_norms": [h["grad_norm"] for h in hist], "step_ms": [h["seconds"] * 1e3 for h in hist],
                    "bytes": [h["bytes"] for h in hist], "transport_seconds": [h["transport_seconds"] for h in hist],
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(), "seconds": time.perf_counter() - t0}
    out["digests"] = leaf_digests({"params": res["params"], "opt": res["opt_state"]})
    del res
    release()
    return out


def tp_rec_rank(rank: int, world: int, cfgs, predicted) -> list:
    """One rank of the recurrent families' run on the card: joins
    TP_REC_MESH and runs ``tp_rec_model`` for each model of TP_REC_MODELS in
    turn, the card's cache emptied between them.  Returns their results."""
    mesh = rank_mesh(*TP_REC_MESH)
    outs = []
    for cfg, (_, _, lr, check, _) in zip(cfgs, TP_REC_MODELS):
        outs.append(tp_rec_model(rank, mesh, cfg, lr, check, predicted[check]))
        release()
    return outs


def tp_rec_job(started) -> Job:
    """Phase train_tp_recurrent as a run of the two ranks' spawn: RWKV-6 7B
    (2 layers), Zamba2-2.7B (6 layers) and the pure Mamba2 stack at its
    widths (6 layers) at full width on TP_REC_MESH (``tp_rec_rank``,
    ``hold_tp_rec``)."""
    cfgs = [tp_rec_config(arch, layers, family) for arch, layers, _, _, family in TP_REC_MODELS]
    pred = predictions(started)
    return Job(tp_rec_rank, (cfgs, {m[3]: pred[m[3]] for m in TP_REC_MODELS}),
               functools.partial(hold_tp_rec, cfgs))


def hold_tp_rec(cfgs, ranks: list, spawn: dict) -> dict:
    """Phase train_tp_recurrent's line for ``tp_rec_rank``'s ranks, each
    model split over ``model`` as the reference's plan places it: raises
    unless, for each, (a) each rank's
    tensor-parallel call has its loss and every gradient leaf, put together
    from the ranks, within TP_TOL of the replicated control's on the same
    rank, with 32 of 64 RWKV-6 heads, or 16 of 32 shared-block heads and the
    hybrid's w_z and w_x on half of d and conv_x on 2 of 4 taps, or the pure
    stack's 40 of 80 heads (half of d_inner in w_z, w_x, conv_x, w_out and
    norm_scale, all 80 of A_log), a rank.  The Mamba2 models' f32 calls (the
    same f32 weights, f32 activations) are held at TRAIN_PARITY_TOL["f32"]
    (the hybrid) or TP_PURE_F32_TOL (the pure stack); their bf16 gradients,
    which part chaotically under
    any change of rounding (ROADMAP Queue 3 (w2)), are held where TP_TOL
    misses as ``hold_train_parity`` holds them against a control: each leaf
    of the tensor-parallel bf16 call, measured from the replicated f32 call,
    at twice the replicated bf16 call's own gap from it plus
    HYBRID_GRAD_SLACK, at most HYBRID_GRAD_CAP; (b)
    the trained run's first loss is that call's; (c) the counters show
    exactly ``tp_rec_owed`` a rank a step (K4 and K4 bwd on RWKV-6's path,
    K2 and K2 bwd on the hybrid's, K1 and K1 bwd on the pure stack's ``ln``
    norms alone); (d) the leaves the plan leaves whole are
    bit-equal on both ranks after the steps; rank 0's call is held against
    its dry-run.  Prints each rank's step ms, peak, and bytes and seconds a
    step by axis and op; returns each model's counters summed over the
    ranks."""
    TP = TP_REC_MESH[0][1]
    failures, totals, lines = [], {}, []
    for i, cfg in enumerate(cfgs):
        runs = [r[i] for r in ranks]
        owed = tp_rec_owed(cfg)
        want = {k: TP_REC_STEPS * v for k, v in owed.items()}
        if cfg.rwkv is not None:
            layout = {"heads": cfg.num_heads // TP}
        elif cfg.family == "ssm":
            d_in = cfg.d_model * cfg.ssm.expand
            layout = {"heads": d_in // cfg.ssm.head_dim // TP, "w_x_cols": d_in // TP, "conv_x_cols": d_in // TP,
                      "w_out_rows": d_in // TP, "norm_scale": d_in // TP, "A_log": d_in // cfg.ssm.head_dim}
        else:
            layout = {"heads": cfg.num_heads // TP, "w_z_rows": cfg.d_model // TP, "w_x_rows": cfg.d_model // TP,
                      "conv_x_taps": cfg.ssm.conv_width // TP}
        split = set(runs[0]["split"])
        total = dict.fromkeys(want, 0)
        for r in runs:
            c, p, t = r["control"], r["parity"], r["train"]
            p["loss_rel_diff"] = abs(p["loss"] - c["loss"]) / abs(c["loss"])
            if not (c["finite"] and p["finite"] and p["loss_rel_diff"] <= TP_TOL["loss_rel"]):
                failures.append((cfg.name, r["rank"], "loss", p["loss"], c["loss"]))
            if p["dryrun"]:
                DRYRUN_LINES.append(p["dryrun"])
                failures += [(cfg.name, r["rank"], "dryrun", p["dryrun"]["failures"])] if p["dryrun"]["failures"] else []
            elif r["rank"] == 0:
                failures.append((cfg.name, 0, "dryrun", "the held call was not checked"))
            if r["layout"] != layout:
                failures.append((cfg.name, r["rank"], "layout", r["layout"], layout))
            if not all(np.isfinite(t["losses"])) or t["losses"][0] != p["loss"]:
                failures.append((cfg.name, r["rank"], "losses", t["losses"], p["loss"]))
            if t["counters"] != want:
                failures.append((cfg.name, r["rank"], "counters", t["counters"], want))
            for k, v in t["counters"].items():
                total[k] += v
            t["bytes_per_step"] = per_step(t.pop("bytes"))
            t["transport_seconds_per_step"] = per_step(t.pop("transport_seconds"))
        gaps = leaf_gaps(runs, "parity", split)
        worst = max(gaps, key=gaps.get)
        limit, held = dict.fromkeys(gaps, TP_TOL["grad_rel"]), {}
        if "f32" in runs[0]:  # Mamba2: its f32 calls, and its bf16 leaves beside the control's where TP_TOL misses
            held["f32"] = leaf_gaps(runs, "f32", split)
            held["control_vs_f32"] = leaf_gaps(runs, "control_vs_f32", split)
            held["bf16_vs_f32"] = leaf_gaps(runs, "bf16_vs_f32", split)
            f32_loss = [abs(r["f32"]["loss"] - r["f32"]["control_loss"]) / abs(r["f32"]["control_loss"]) for r in runs]
            f32_worst = max(held["f32"], key=held["f32"].get)
            f32_tol = TP_PURE_F32_TOL if cfg.family == "ssm" else TRAIN_PARITY_TOL["f32"]
            if max(f32_loss) > f32_tol["loss_rel"] or held["f32"][f32_worst] > f32_tol["grad_rel"]:
                failures.append((cfg.name, "f32", f32_loss, f32_worst, held["f32"][f32_worst]))
            held["f32_loss_rel_diff"], held["f32_tol"] = f32_loss, f32_tol
        against = gaps
        if held and gaps[worst] > TP_TOL["grad_rel"]:
            against = held["bf16_vs_f32"]
            limit = {k: min(2 * held["control_vs_f32"][k] + HYBRID_GRAD_SLACK, HYBRID_GRAD_CAP) for k in gaps}
            held["grad_tol_against_control"] = limit
        for r in runs:
            for key in ("parity", "f32", "control_vs_f32", "bf16_vs_f32"):
                r.get(key, {}).pop("sums", None)
        missed = {k: (against[k], limit[k]) for k in gaps if not against[k] <= limit[k]}
        if missed or len(gaps) != len(expected_shapes(cfg)):
            failures.append((cfg.name, "grads", missed, len(gaps)))
        digests = [r.pop("digests") for r in runs]
        differ = sorted(k for k, v in digests[0].items() if whole_key(k, split) and digests[1][k] != v)
        if differ:
            failures.append((cfg.name, "whole leaves differ", differ[:8]))
        totals[f"train_tp_recurrent {cfg.name} 1x2"] = total
        lines.append({"model": cfg.name, "layers": cfg.num_layers, "counters_per_step": owed,
                      "grad_rel_diff": {"worst_leaf": worst, "worst": gaps[worst], "by_leaf": gaps}, **held,
                      "split_leaves": len(split), "whole_leaves_bit_equal": not differ, "ranks": runs})
    emit({"phase": "train_tp_recurrent", "reduced": TP_REC_REDUCED, "mesh": dict(zip(TP_REC_MESH[1], TP_REC_MESH[0])),
          "batch": TP_REC_BATCH, "seq": TRAIN_SEQ, "steps": TP_REC_STEPS,
          "control": "each rank's replicated DataParallelLoss call (no plan) on the whole model, the same mesh and "
                     "batch", "tol": TP_TOL, "spawn": spawn, "note": "the ranks share one card",
          "models": lines})
    if failures:
        raise AssertionError(f"train_tp_recurrent: {failures}")
    return totals


# ---------------------------------------------------------------------------
# phase train_fsdp_rwkv: FSDP for RWKV-6, data on a stacked axis (slice 7f-iii)
# and the FSDP state gathered whole (Queue 1 (d))
# ---------------------------------------------------------------------------

# RWKV-6 7B at full width with 2 of its 32 layers on (data, model) = (2, 1):
# two gloo ranks that share the card, under the plan with fsdp on at a
# threshold of w0's own f32 bytes (2 x 4096 x 4 = 32,768), so that the plan
# puts data on w0's layer axis (its one feature dim takes model's rule, an
# axis of 1 here) and on 12 other leaves' own dims: 973,619,200 of the
# 974,204,928 parameters split, a rank's f32 parameters and two moments
# 5,848,743,936 B against the replica's 11,690,459,136 B.  K1, K4 and K4's
# backward run at RWKV-6's 64 heads a rank (data splits no head), on (2, 512,
# 64, 64) a call.
FSDP_RWKV_MESH = ((2, 1), ("data", "model"))
FSDP_RWKV_LAYERS, FSDP_RWKV_BATCH = 2, 4
FSDP_RWKV_MIN_BYTES = 4 * 2 * 4096  # w0 (2, 4096) in f32: the lowest threshold that splits it on its layer axis
FSDP_RWKV_CHECK = "fsdp_rwkv_2x1"  # the dry-run's prediction of rank 0's held FSDP call
FSDP_RWKV_REDUCED = {"num_layers": "32 -> 2", "why": "two ranks share the card's 80 GB: each makes the whole model "
                     "(3.90 GB of f32 parameters at 2 layers, 120.5 GB of train state at 32) for its replicated run, "
                     "and rank 0 keeps that run's state beside its FSDP run to hold the gathered state against it"}


def fsdp_rwkv_config():
    return train_config(FSDP_RWKV_LAYERS, torch.bfloat16, "rwkv6_7b")


def fsdp_rwkv_rank(rank: int, world: int, cfg, predicted) -> dict:
    """One rank of phase train_fsdp_rwkv: joins FSDP_RWKV_MESH; the
    replicated run (the whole model from the seed, one ``DataParallelLoss``
    call with no plan on the first batch and its AdamW update, as
    ``make_train_step`` takes them), its ``data`` blocks of the gradient kept
    on the host and, on rank 0, its whole state kept on the card; then the
    FSDP run (the model made again and cut by the plan with fsdp on at
    FSDP_RWKV_MIN_BYTES): one call (rank 0's held against its dry-run), its
    launches, its loss and gradient blocks against the replicated call's
    (``against_blocks``), and its update; then ``gather_train_state`` on
    every rank (the whole state on rank 0's host), held on rank 0 against the
    replicated run's state, and re-sharded by the plan for each rank
    (``shard_params``) against every rank's live blocks and moments: rank 0's
    own on the card, the others' by their SHA-256 (``leaf_digests``).  Each run's peak is its own (above what the
    rank held before it)."""
    mesh = rank_mesh(*FSDP_RWKV_MESH)
    model = build_model(cfg)
    fplan = model_plan(cfg, mesh, fsdp=True, min_bytes=FSDP_RWKV_MIN_BYTES)
    opt_cfg = optimizer_config(RWKV_TRAIN_LR, 1)
    b0 = next(make_batches(cfg, DataConfig(seed=SEED, batch_size=FSDP_RWKV_BATCH, seq_len=TRAIN_SEQ)))
    b0 = {k: torch.from_numpy(v).to("cuda") for k, v in b0.items()}

    def made():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        return model.init(gen)

    def run_peak(held: int) -> int:
        return torch.cuda.max_memory_allocated() - held

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole = made()
    rep_fn = DataParallelLoss(model.loss, mesh)
    r_loss, r_grads = rep_fn(whole, b0)
    ref = on_data(r_grads, fplan, mesh)
    whole, r_opt, _ = adamw_update(opt_cfg, r_grads, whole, init_opt_state(whole), norm=rep_fn.grad_norm)
    torch.cuda.synchronize()
    replicated = {"loss": float(r_loss), "seconds": time.perf_counter() - t0, "peak_memory_bytes": run_peak(0),
                  "bytes": rep_fn.transport.counts(), "transport_seconds": rep_fn.transport.times(),
                  "state_bytes": 12 * sum(t.numel() for t in flatten(whole).values())}
    r_loss = r_loss.detach().cpu()
    kept = ({"params": {p: t.detach() for p, t in flatten(whole).items()}, "mu": flatten(r_opt.mu),
             "nu": flatten(r_opt.nu)} if rank == 0 else None)
    del whole, r_grads, r_opt, rep_fn
    release()

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    blocks = shard_params(made(), mesh, fplan)
    release()
    loss_fn = DataParallelLoss(model.loss, mesh, plan=fplan)
    line = None
    reset_counters()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if rank == 0:
        line, (loss, grads) = hold_dryrun(f"{cfg.name} FSDP call, rank 0 of 2x1, data on w0's layer axis",
                                          FSDP_RWKV_CHECK, predicted, lambda: loss_fn(blocks, b0), (blocks, b0),
                                          backward=True, transport=loss_fn.transport, owed=tp_rec_owed(cfg))
    else:
        loss, grads = loss_fn(blocks, b0)
    torch.cuda.synchronize()
    call_s, counters = time.perf_counter() - t1, read_counters()
    parity = {"loss": float(loss), "replicated_loss": float(r_loss), **against_blocks(loss, grads, r_loss, ref),
              "finite": bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads.values()),
              "call_seconds": call_s, "bytes": loss_fn.transport.counts(),
              "transport_seconds": loss_fn.transport.times(), "dryrun": line}
    del ref
    blocks, opt, metrics = adamw_update(opt_cfg, grads, blocks, init_opt_state(blocks), norm=loss_fn.grad_norm)
    del grads
    torch.cuda.synchronize()
    n = sum(t.numel() for t in flatten(blocks).values())
    run = {"seconds": time.perf_counter() - t0, "peak_memory_bytes": run_peak(held), "counters": counters,
           "grad_norm": float(metrics["grad_norm"]), "params": n, "state_bytes": 12 * n,
           "split_over_data": sorted(split_paths(fplan, "data")),
           "w0_block": list(blocks["layers"]["w0"].shape)}

    t0 = time.perf_counter()
    state = gather_train_state(blocks, opt, cfg, mesh, plan=fplan)
    gather = {"seconds": time.perf_counter() - t0,
              "sent_bytes": 0 if rank == 0 else sum(t.numel() * t.element_size() for tree in (blocks, opt.mu, opt.nu)
                                                    for p, t in flatten(tree).items() if p in run["split_over_data"])}
    t0 = time.perf_counter()
    live = leaf_digests({"params": blocks, "opt": opt}) if rank else None  # rank 0 holds its own cut on the card
    gather["live_digest_s"] = time.perf_counter() - t0
    if rank == 0:
        t0 = time.perf_counter()
        gaps, equal = {}, 0
        for part, tree in (("params", state["params"]), ("mu", state["opt"].mu), ("nu", state["opt"].nu)):
            got = flatten(tree)
            if got.keys() != kept[part].keys():
                raise AssertionError(f"train_fsdp_rwkv: the gathered {part} has {sorted(got)[:4]}...")
            for p, t in got.items():
                w = kept[part][p]
                t = t.to("cuda")
                equal += bool(torch.equal(t, w))
                gaps[f"{part}/{p}"] = float((t - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(gaps, key=gaps.get)
        gather.update(against_replicated={"bit_equal": equal, "leaves": len(gaps), "worst": worst,
                                          "max_diff_over_max": gaps[worst]},
                      whole_bytes=sum(t.numel() * t.element_size() for tree in (state["params"], state["opt"].mu,
                                                                                 state["opt"].nu)
                                      for t in flatten(tree).values()),
                      compare_s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        gather["resharded"] = []  # the other ranks' cuts by their SHA-256; rank 0's own against its blocks here
        mine = dict(_walk({"params": blocks, "opt": opt}))
        for r in range(world):
            m = Mesh(*FSDP_RWKV_MESH, r)
            cut = {"params": shard_params(state["params"], m, fplan),
                   "opt": OptState(state["opt"].step, shard_params(state["opt"].mu, m, fplan),
                                   shard_params(state["opt"].nu, m, fplan))}
            if r == 0:
                got = dict(_walk(cut))
                gather["own_resharded_equal"] = got.keys() == mine.keys() and all(
                    torch.equal(t.to("cuda"), mine[k]) for k, t in got.items())
            else:
                gather["resharded"].append(leaf_digests(cut))
            del cut
        gather["reshard_s"] = time.perf_counter() - t0
    del state, kept, blocks, opt, loss_fn
    release()
    return {"rank": rank, "coords": mesh.coords, "replicated": replicated, "parity": parity, "fsdp": run,
            "gather": gather, "live": live}


def fsdp_rwkv_job(started) -> Job:
    """Phase train_fsdp_rwkv as a run of the two ranks' spawn: RWKV-6 7B at
    full width with FSDP_RWKV_LAYERS layers on FSDP_RWKV_MESH
    (``fsdp_rwkv_rank``, ``hold_fsdp_rwkv``)."""
    cfg = fsdp_rwkv_config()
    return Job(fsdp_rwkv_rank, (cfg, predictions(started)[FSDP_RWKV_CHECK]), functools.partial(hold_fsdp_rwkv, cfg))


def hold_fsdp_rwkv(cfg, ranks: list, spawn: dict) -> dict:
    """Phase train_fsdp_rwkv's line for ``fsdp_rwkv_rank``'s ranks: raises
    unless each rank's FSDP call has its loss and every gradient block
    within TP_TOL of the replicated call's (bit-equal is the prediction) and
    finite, its launches exactly ``tp_rec_owed`` (K1, K1 bwd, K4, K4 bwd: one
    step), ``w0`` split on its layer axis (one of the two rows a rank), its
    peak below the replicated run's; rank 0's call is its dry-run's; the
    state gathered on rank 0 is within PIPE_TOL["grad"] of the replicated
    run's, every leaf, and cut by the plan again it is each rank's live
    blocks and moments bit for bit.  Prints each rank's parameters, f32
    state, peak, seconds and bytes by axis and op beside the replicated
    run's, and the gather's bytes and seconds; returns the counters summed
    over the ranks."""
    owed = tp_rec_owed(cfg)
    failures, total = [], dict.fromkeys(owed, 0)
    resharded = ranks[0]["gather"].get("resharded") or []
    for r in ranks:
        p, f = r["parity"], r["fsdp"]
        p["loss_rel_diff"] = abs(p["loss"] - p["replicated_loss"]) / abs(p["replicated_loss"])
        if not (p["finite"] and p["loss_rel_diff"] <= TP_TOL["loss_rel"] and p["grad_rel_diff_worst"] <= TP_TOL["grad_rel"]):
            failures.append((r["rank"], "against the replicated call", p))
        if p["dryrun"]:
            DRYRUN_LINES.append(p["dryrun"])
            failures += [(r["rank"], "dryrun", p["dryrun"]["failures"])] if p["dryrun"]["failures"] else []
        elif r["rank"] == 0:
            failures.append((0, "dryrun", "the held call was not checked"))
        if f["counters"] != owed:
            failures.append((r["rank"], "counters", f["counters"], owed))
        for k, v in f["counters"].items():
            total[k] += v
        if f["w0_block"] != [1, cfg.d_model] or "layers/w0" not in f["split_over_data"]:
            failures.append((r["rank"], "w0 not split on its layer axis", f["w0_block"]))
        f["peak_vs_replicated"] = {"fsdp": f["peak_memory_bytes"], "replicated": r["replicated"]["peak_memory_bytes"]}
        if not f["peak_memory_bytes"] < r["replicated"]["peak_memory_bytes"]:
            failures.append((r["rank"], "peak not below the replicated run's", f["peak_vs_replicated"]))
        live = r.pop("live")
        if not (ranks[0]["gather"].get("own_resharded_equal") if r["rank"] == 0
                else len(resharded) >= r["rank"] and resharded[r["rank"] - 1] == live):
            failures.append((r["rank"], "the gathered state re-sharded is not the rank's live blocks"))
        r["leaves_hashed"] = len(live) if live else 0
    g = ranks[0]["gather"]
    if "against_replicated" not in g or g["against_replicated"]["max_diff_over_max"] > PIPE_TOL["grad"]:
        failures.append((0, "gathered state against the replicated run's", g.get("against_replicated")))
    g["resharded_equal_live"] = not any(f[1].startswith("the gathered state") for f in failures)
    g.pop("resharded", None)
    emit({"phase": "train_fsdp_rwkv", "model": cfg.name, "reduced": FSDP_RWKV_REDUCED,
          "mesh": dict(zip(FSDP_RWKV_MESH[1], FSDP_RWKV_MESH[0])), "layers": cfg.num_layers,
          "batch": FSDP_RWKV_BATCH, "seq": TRAIN_SEQ, "lr": RWKV_TRAIN_LR,
          "plan": f"model_plan(cfg, mesh, fsdp=True, min_bytes={FSDP_RWKV_MIN_BYTES}): data on w0's layer axis",
          "reference": "each rank's replicated DataParallelLoss call (no plan) and its AdamW update, the same mesh "
                       "and batch", "tol": TP_TOL, "state_tol": PIPE_TOL["grad"], "counters_per_step": owed,
          "spawn": spawn, "note": "the ranks share one card", "ranks": ranks})
    if failures:
        raise AssertionError(f"train_fsdp_rwkv: {failures}")
    return {f"train_fsdp_rwkv {cfg.name} 2x1": total}


# ---------------------------------------------------------------------------
# phase examples: the five examples through their mains on the card
# ---------------------------------------------------------------------------

EXAMPLES_CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "local", "chip_smoke_train_100m")


def example_owed() -> dict:
    """The launches each example owes, counted from the code (the smoke
    GPT-A: 2 layers, head size 64, remat "none"; ``CFG_100M``: 12 layers,
    remat "none"): a train step ``train_owed(.., remat=False)``; a served
    batch of ragged prompts prefills on the masked plain ``sdpa`` (one call a
    layer) and decodes through K1 and K3; a pipelined rank of geo_train's
    (2, 2, 2) runs one layer a microbatch, four microbatches a step."""
    smoke = train_owed(2 * 2, 2, remat=False)

    def serve(new_tokens: int) -> dict:  # one batch: its prefill, then new_tokens - 1 decode steps
        steps = new_tokens - 1
        return dict(dict.fromkeys(smoke, 0), rmsnorm=5 * (1 + steps), decode_attention=2 * steps, sdpa_masked_calls=2)

    qs_train = {k: 150 * v for k, v in smoke.items()}
    qs = {k: qs_train[k] + serve(8)[k] for k in smoke}
    stages = [pipeline_owed(2, 1, last, 4, remat=False) for last in (False, True)]
    geo = {k: 30 * 4 * (stages[0][k] + stages[1][k]) for k in smoke}  # 30 steps, four ranks a stage
    return {"quickstart": qs, "bubbletea_serve": serve(6), "train_100m": {k: 200 * v for k, v in
                                                                          train_owed(2 * 12, 12, remat=False).items()},
            "geo_train": geo, "whatif": dict.fromkeys(smoke, 0)}


def phase_examples() -> dict:
    """``whatif``, ``bubbletea_serve``, ``quickstart`` (150 steps),
    ``train_100m`` (200 steps of 4 x 256, its checkpoints under
    EXAMPLES_CKPT, removed after) and ``geo_train`` (30 steps on eight ranks
    sharing the card) through their mains, each counted from zero (geo_train
    summed over its ranks), their printed lines kept out of this script's
    output.  Raises unless each example's launches are ``example_owed``'s,
    the trained losses fall (train_100m asserts it itself), every request got
    its tokens and the simulated parts printed what they print.  Emits one
    line an example; returns the counters by path."""
    owed, counts, failures = example_owed(), {}, []
    runs = (("whatif", lambda: whatif.main()), ("bubbletea_serve", lambda: bubbletea_serve.main()),
            ("quickstart", lambda: quickstart.main(steps=150)),
            ("train_100m", lambda: train_100m.main(["--ckpt-dir", EXAMPLES_CKPT])),
            ("geo_train", lambda: geo_train.main(steps=30)))
    shutil.rmtree(EXAMPLES_CKPT, ignore_errors=True)
    try:
        for name, run in runs:
            release()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                got = run()
            seconds = time.perf_counter() - t0
            lines = buf.getvalue().splitlines()
            line = {"phase": "examples", "example": name, "seconds": seconds, "lines_printed": len(lines),
                    "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            if name == "geo_train":
                counters = dict.fromkeys(owed[name], 0)
                for r in got["ranks"]:
                    for k, v in r["launches"].items():
                        counters[k] += v
                losses = got["ranks"][0]["losses"]
                line.update(losses=[losses[0], losses[-1]], ranks=len(got["ranks"]),
                            pod_bytes_rank0=got["ranks"][0]["bytes"]["pod"],
                            same_losses_on_every_rank=all(r["losses"] == losses for r in got["ranks"]))
                if not line["same_losses_on_every_rank"] or not losses[-1] < losses[0]:
                    failures.append((name, "losses", [r["losses"] for r in got["ranks"]]))
                line["simulated"] = [ln for ln in lines if ln.startswith(("[plan]", "[sim]"))]
                if len(line["simulated"]) != 7:
                    failures.append((name, "parts 1-2", lines))
            else:
                counters = read_counters()
            if name == "whatif":
                line["timed"] = [ln for ln in lines if "searched 8 DCs" in ln]
                if len(line["timed"]) != 1:
                    failures.append((name, "lines", lines))
            if name == "bubbletea_serve":
                line.update(kv_bytes_moved=got["kv_bytes_moved"], tokens=[r.generated for r in got["requests"]],
                            printed=[ln for ln in lines if ln.startswith(("[atlas]", "[bubbletea]", "[splitwise]"))])
                if not got["kv_bytes_moved"] > 0 or any(len(r.generated) != 6 for r in got["requests"]):
                    failures.append((name, "served", line))
            if name == "quickstart":
                line.update(losses=[got["losses"][0], got["losses"][-1]], tokens=[r.generated for r in got["requests"]])
                if not got["losses"][-1] < got["losses"][0] or any(len(r.generated) != 8 for r in got["requests"]):
                    failures.append((name, "trained or served", line))
            if name == "train_100m":
                line.update(losses=[got["losses"][0], got["losses"][-1]], checkpoint=os.path.basename(got["checkpoint"]),
                            files=sorted(f for f in os.listdir(EXAMPLES_CKPT) if f.endswith(".npz")),
                            tokens_per_s_printed=[ln for ln in lines if ln.startswith("step")][-1])
            line["counters"], line["owed"] = counters, owed[name]
            if counters != owed[name]:
                failures.append((name, "counters", counters, owed[name]))
            if name != "whatif":
                counts[f"examples {name}"] = counters
            emit(line)
    finally:
        shutil.rmtree(EXAMPLES_CKPT, ignore_errors=True)
    if failures:
        raise AssertionError(f"examples: {failures}")
    return counts


# ---------------------------------------------------------------------------


def serve_model(arch: str, phase: str, started=None) -> dict:
    """Builds ``arch`` at full width from the seed, serves it and holds the
    kernel path against the plain path; returns the serving path's counters.
    Everything it made is released when it returns.  With ``started``
    (``start_dryruns``), its prefill and decode step are held against their
    dry-runs too (``dryrun_serving``: GPT-A's)."""
    cfg = get_config(arch)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    params32 = model.init(gen)
    f32 = rwkv_parity_f32(cfg, params32) if cfg.rwkv is not None else None
    params = model.cast_params(params32)
    del params32  # the f32 parameters are dropped once cast
    served = phase_serve(phase, cfg, model, params)
    if started is not None:  # GPT-A's served steps against their dry-runs
        dryrun_serving(cfg, model, served["engine"].params, started)
    if f32 is None:
        phase_serve_parity(phase + "_parity", cfg, model, served["engine"].params, served["prompts"])
    else:
        phase_serve_rwkv_parity(phase + "_parity", cfg, model, served["engine"].params, served["prompts"], f32)
    return served["counters"]


def release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script proves the port on the GPU and has no CPU mode", file=sys.stderr)
        return 1
    # f32 products in full f32 (the plain references and the f32 parity need it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = phase_env()
    started = start_dryruns()  # on the host, beside the card's phases
    phase_build()
    rows = phase_kernels()
    release()
    phase_simulate()

    counts = {"gpt-a": serve_model("gpt_a", "serve", started)}
    release()  # GPT-A's weights go before RWKV-6 7B's 30 GB of f32 parameters are made
    counts["rwkv6-7b"] = serve_model("rwkv6_7b", "serve_rwkv")
    release()
    counts["train"] = phase_train()
    release()
    phase_train_parity()
    release()
    counts["train-hubert"] = train_hubert()
    release()
    phase_train_hubert_parity()
    release()
    counts["train-hybrid"] = train_hybrid()
    release()
    phase_train_hybrid_parity()
    release()
    counts["train-rwkv"] = train_rwkv()
    release()
    phase_train_rwkv_parity()
    release()
    phase_dryrun_train(started)
    release()
    counts.update(phase_ranks_of_four(started))
    release()
    counts.update(phase_ranks_of_two(started))
    release()
    counts.update(phase_examples())
    release()
    counts["qwen2-moe-a2.7b"] = serve_moe_model("qwen2_moe_a2p7b", "serve_moe")
    release()
    counts["deepseek-v2-lite-16b"] = serve_moe_model("deepseek_v2_lite_16b", "serve_mla")
    release()
    for arch, phase, layers in STACK_DECODERS:
        counts.update(serve_stack_model(arch, phase, layers))
        release()
    counts.update(encode_hubert())
    release()
    counts.update(serve_hybrid())
    release()
    phase_dryrun(started)

    for row in rows:
        row["launches_by_path"] = {m: c[row["name"]] for m, c in counts.items() if c[row["name"]]}
        row["launches"] = sum(row["launches_by_path"].values())
        if row["name"] == "wkv6_bwd":  # of those, on the chunked route
            row["launches_chunked"] = sum(c["wkv6_bwd_chunk"] for c in counts.values())
        if row["launches"] < 1:
            raise AssertionError(f"{row['name']}: no served or trained path launched it")
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start, 1)})
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for proc in BACKGROUND:  # a failed run leaves no process behind
            proc.kill()
            proc.wait()
