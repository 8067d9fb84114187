"""``chip_smoke.py``'s spawn of several runs and its pipelined runs' owed
launches, on the CPU (the runs themselves need the card).

- The spawn: each run of a merged spawn has its own deadline, read from the
  ranks' heartbeats.  A stub rank function (no ``join_as_rank``, no card)
  whose second run stalls fails within that run's deadline, not within the
  sum of the runs'; one whose runs all end returns each rank's results in
  run order.
- The launches: ``stage_owed`` for each pipelined family on (pod, data,
  model) = (2, 1, 2) is what one stage of the smoke config's pipelined call
  enters of the kernel wrappers (``kernels/ops.py``: each forward wrapper,
  and each autograd Function's backward), counted by monkeypatching them, on
  either stage, with remat "none" (the smoke configs') and "full" (the full
  configs'); the transport is ``MetaTransport``'s with zeros received, so
  one rank runs its stage alone.
- The dry-run's new entries (RWKV-6, DeepSeek-V2-Lite and Zamba2 on (2, 1,
  2) ``striped``) build and count on ``meta``: rank 0's launches are
  ``stage_owed`` of the first stage, and every axis's bytes are counted.
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batches  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_mod  # noqa: E402
from repro_torch.kernels import wkv6 as wkv_mod  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.parallel.pipeline import PipelineLoss, stage_params  # noqa: E402
from repro_torch.parallel.sharding import shard_params  # noqa: E402
from repro_torch.parallel.tensor_parallel import model_plan  # noqa: E402
from repro_torch.parallel.transport import MetaTransport  # noqa: E402
from torch_helpers import F32_TOL  # noqa: E402, F401  (importing it sets one torch thread)

SHAPE = chip_smoke.PIPE_TP_MESH


def stub_rank(rank: int, world: int, sleeps, store: str) -> None:
    """A rank of ``len(sleeps)`` runs that each sleep, beating as each
    begins, as ``chip_smoke.rank_runs`` does, and writing its results."""
    for i, s in enumerate(sleeps):
        chip_smoke.beat(store, rank, i)
        time.sleep(s)
    with open(f"{store}.rank{rank}.json", "w") as f:
        json.dump([{"rank": rank, "run": i} for i in range(len(sleeps))], f)
    chip_smoke.beat(store, rank, len(sleeps))


def test_a_stalled_run_fails_within_its_own_deadline(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "PIPE_DIR", str(tmp_path))
    deadlines = (60, 3)  # the first covers the ranks' start; the second run sleeps far past its own
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="run 1 of 2 outlived its 3 s"):
        chip_smoke.spawn_ranks(stub_rank, 2, (0.0, 600.0), deadlines=deadlines)
    assert time.monotonic() - t0 < 45 < sum(deadlines)


def test_a_spawn_whose_runs_end_returns_each_run_in_order(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "PIPE_DIR", str(tmp_path))
    after = []  # the parent's work on a run once every rank has left it
    out = chip_smoke.spawn_ranks(stub_rank, 2, (0.1, 0.1, 0.1), deadlines=(60, 30, 30),
                                 after={i: lambda i=i: after.append(i) for i in (0, 2)})
    assert out == [[{"rank": r, "run": i} for i in range(3)] for r in range(2)]
    assert sorted(after) == [0, 2]


class ZeroTransport(MetaTransport):
    """``MetaTransport``'s counts, receiving and gathering zeros: one rank
    runs its stage of a pipelined call alone."""

    def recv(self, shape, dtype, device, axis, step):
        return super().recv(shape, dtype, device, axis, step).zero_()

    def all_gather(self, t, axis, dim):
        out = super().all_gather(t, axis, dim)
        return out.zero_() if out is not t else t


def entered(monkeypatch) -> dict:
    """Counts of the kernel wrappers' entries: each forward wrapper of
    ``kernels/ops.py`` and each autograd Function's backward."""
    counts = dict.fromkeys(("rmsnorm", "flash_attention", "decode_attention", "wkv6", "rmsnorm_bwd",
                            "flash_attention_bwd", "wkv6_bwd"), 0)

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in ("rmsnorm", "flash_attention", "decode_attention", "wkv6"):
        monkeypatch.setattr(kops, name, counted(name, getattr(kops, name)))
    for name, fn_cls in (("rmsnorm_bwd", rms_mod.RMSNormFn), ("flash_attention_bwd", fa_mod.FlashAttentionFn),
                         ("wkv6_bwd", wkv_mod.WKV6Fn)):
        monkeypatch.setattr(fn_cls, "backward", staticmethod(counted(name, fn_cls.backward)))
    return counts


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("stage", [0, 1])
@pytest.mark.parametrize("arch", ["rwkv6_7b", "deepseek_v2_lite_16b", "zamba2_2p7b"])
def test_stage_owed_is_what_a_stage_enters(monkeypatch, arch, stage, remat):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32, remat=remat)
    mesh = Mesh(SHAPE, chip_smoke.PIPE_AXES, Mesh(SHAPE, chip_smoke.PIPE_AXES).rank_at(pod=stage, model=1))
    plan = model_plan(cfg, mesh)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = shard_params(stage_params(build_model(cfg).init(gen), cfg, mesh), mesh, plan)
    batch = next(make_batches(cfg, DataConfig(seed=0, batch_size=8, seq_len=32)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_fn = PipelineLoss(cfg, mesh, chip_smoke.PIPE_N_MICRO, "striped", transport=ZeroTransport(mesh), plan=plan)
    counts = entered(monkeypatch)
    loss, grads = loss_fn(params, batch)
    assert torch.isfinite(loss) and all(torch.isfinite(g).all() for g in grads.values())
    owed = chip_smoke.stage_owed(cfg, SHAPE[0], stage == SHAPE[0] - 1, chip_smoke.PIPE_N_MICRO)
    assert counts == {k: owed[k] for k in counts}
    assert owed["wkv6_bwd_chunk"] == owed["wkv6_bwd"]  # on the card every K4 backward of these shapes is chunked


@pytest.mark.parametrize("prefix", ["pipe_rwkv_", "pipe_deepseek_", "pipe_zamba_"])
def test_the_dry_run_s_new_entries_count_on_meta(prefix):
    name = f"{prefix}2x1x2_striped"
    call, args, transport = chip_smoke.dryrun_steps()[name]()
    assert next(iter(args[1].values())).device.type == "meta"
    out = dryrun.count(call, args)
    cfg = {"pipe_rwkv_": chip_smoke.rwkv_pipe_config, "pipe_deepseek_": chip_smoke.moe_pipe_config,
           "pipe_zamba_": chip_smoke.hybrid_pipe_config}[prefix]()
    owed = chip_smoke.stage_owed(cfg, SHAPE[0], False, chip_smoke.PIPE_N_MICRO)
    assert out["launches"] == {k: v for k, v in owed.items() if k in chip_smoke.KERNEL_KEYS and v}
    counts = transport.counts()
    assert counts["pod"]["send"] > 0 and counts["pod"]["all_reduce"] > 0 and counts["model"]["all_reduce"] > 0
    assert out["peak_bytes"] > out["argument_bytes"] > 0
