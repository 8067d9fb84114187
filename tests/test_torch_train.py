"""The port's train launcher against the reference's jitted train step (no
mesh): 15 steps of gpt_a, hubert_xlarge (a batch of frame ``embeds``),
qwen2_vl_7b (a VLM batch of ``embeds`` and M-RoPE positions), zamba2_2p7b and
rwkv6_7b smoke from one converted init on the same batches, the loss of every
step compared; the leaf such a batch never reads; and the command line on the
CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import make_batches as ref_make_batches
from repro.models.transformer import build_model as ref_build_model
from repro.optim import optimizer as ref_opt
from repro_torch import configs, convert
from repro_torch.launch import train as train_mod
from repro_torch.optim import optimizer as port_opt
from repro_torch.models.transformer import build_model
from torch_helpers import reference_params

STEPS, BATCH, SEQ, LR = 15, 8, 32, 3e-3
# f32: the same arithmetic in another order of summation; the two runs part by
# at most 6.3e-7 of the loss over 15 steps (zamba2), held at 1e-5.  bf16:
# activations round at other places in the two frameworks (7.0e-4 seen on
# zamba2, whose Mamba2 layers carry a rounding along the sequence; 1.9e-4 on
# gpt_a), held at 1e-3.  Every family's last loss falls below its first at
# lr 3e-3 over the 15 steps (hubert's frame labels barely: 4.228 -> 4.193).
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
# RWKV-6 in bf16 carries a rounding along its recurrence into every later
# step, and 15 steps at lr 3e-3 amplify it: two runs that differ only in the
# order of f32 sums part by about 1e-3 of the loss (the reference with the WKV
# in chunks of 16 against the config's 32: 1.1e-3).  Besides, XLA keeps a
# fusion's bf16 intermediates in f32 where PyTorch rounds after every op.  So
# its bf16 run is held against the reference compiled to round after every op
# as the port does (ROUND_EVERY_OP), where the two differ only in the order of
# f32 sums, at twice what that reference parts from itself with the WKV in
# chunks of RWKV_CONTROL_CHUNK (a change of the same kind), never below
# LOSS_RTOL.  Its f32 run stays at LOSS_RTOL, where a rounding is 2**-24.
ROUND_EVERY_OP = {"xla_allow_excess_precision": False}
RWKV_CONTROL_CHUNK = 16
# gpt_a keeps its ids of before the families were added
FAMILIES = [pytest.param("gpt_a", dt, id=dt) for dt in ("float32", "bfloat16")] + \
    [pytest.param(arch, dt, id=f"{arch}-{dt}")
     for arch in ("hubert_xlarge", "qwen2_vl_7b", "zamba2_2p7b", "rwkv6_7b") for dt in ("float32", "bfloat16")]
_T = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _reference_run(ref_cfg, ref_params, compiler_options=None):
    """(losses, final params, final optimizer state) of the reference's jitted
    step, compiled with XLA's ``compiler_options`` where given."""
    ocfg = ref_opt.OptimizerConfig(peak_lr=LR, warmup_steps=min(20, STEPS // 5 + 1), total_steps=STEPS)
    jitted = jax.jit(ref_opt.make_train_step(ref_build_model(ref_cfg).loss, ocfg))
    st = ref_opt.init_opt_state(ref_params)
    step, losses = None, []
    for b in ref_make_batches(ref_cfg, RefDataConfig(seed=0, batch_size=BATCH, seq_len=SEQ), num_steps=STEPS):
        b = {k: jnp.asarray(v) for k, v in b.items()}
        if step is None:
            step = jitted.lower(ref_params, st, b).compile(compiler_options) if compiler_options else jitted
        ref_params, st, m = step(ref_params, st, b)
        losses.append(float(m["loss"]))
    return losses, ref_params, st


def _both_runs(arch, dtype, compiler_options=None):
    jdt, tdt = _T[dtype]
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), dtype=jdt)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), dtype=tdt)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    want = _reference_run(ref_cfg, ref_params, compiler_options)
    out = train_mod.train(cfg, steps=STEPS, batch=BATCH, seq=SEQ, lr=LR, seed=0, log_every=5, device="cpu",
                          params=convert.from_reference(tree, cfg))
    return want, out


def _rwkv_control_gap(want):
    """How far the reference's bf16 rwkv6_7b run with the WKV in chunks of
    RWKV_CONTROL_CHUNK parts from ``want``, its run at the config's chunk, both
    compiled with ROUND_EVERY_OP: relative, at the worst step."""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("rwkv6_7b"), dtype=jnp.bfloat16)
    ref_cfg = dataclasses.replace(ref_cfg, rwkv=dataclasses.replace(ref_cfg.rwkv, chunk=RWKV_CONTROL_CHUNK))
    ctl = _reference_run(ref_cfg, reference_params(ref_cfg, seed=0)[0], ROUND_EVERY_OP)[0]
    return float(np.max(np.abs(np.subtract(ctl, want)) / np.abs(want)))


@pytest.mark.parametrize("arch, dtype", FAMILIES)
def test_fifteen_steps_match_the_reference(arch, dtype, capsys):
    rwkv_bf16 = arch == "rwkv6_7b" and dtype == "bfloat16"
    (want, _, _), out = _both_runs(arch, dtype, ROUND_EVERY_OP if rwkv_bf16 else None)
    rtol = LOSS_RTOL[dtype]
    if rwkv_bf16:
        rtol = max(rtol, 2 * _rwkv_control_gap(want))
    got = [h["loss"] for h in out["history"]]
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert got[-1] < got[0]
    assert [h["step"] for h in out["history"]] == list(range(STEPS))
    assert all(np.isfinite(h["grad_norm"]) and h["lr"] > 0 and h["seconds"] > 0 for h in out["history"])
    assert int(out["opt_state"].step) == STEPS
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    assert len(lines) == 4  # steps 0, 5, 10 and the last
    assert all(w in lines[0] for w in ("loss", "gnorm", "lr", "tok/s"))


@pytest.mark.parametrize("arch", ["hubert_xlarge", "qwen2_vl_7b"])
def test_the_leaf_an_embeds_batch_never_reads_is_only_decayed(arch):
    """``embed`` under batches of ``embeds``: a zero gradient, as ``jax.grad``
    gives it, so its moments stay 0 and weight decay alone moves it, to the
    reference's values."""
    (_, ref_params, ref_st), out = _both_runs(arch, "float32")
    embed, init = out["params"]["embed"].detach(), reference_params(
        ref_configs.get_smoke_config(arch), seed=0)[1]["embed"]
    assert not out["opt_state"].mu["embed"].any() and not out["opt_state"].nu["embed"].any()
    assert not np.asarray(ref_st.mu["embed"]).any()
    assert not np.allclose(embed.numpy(), init, rtol=0, atol=0)  # the decay moved it
    np.testing.assert_allclose(embed.numpy(), np.asarray(ref_params["embed"]), rtol=1e-6, atol=0)


def test_accumulation_takes_a_leaf_the_loss_never_reads():
    """``accum_steps=2`` on hubert smoke in f32: each microbatch's gradient of
    ``embed`` is zero, and one step matches the reference's accumulated step."""
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("hubert_xlarge"), dtype=jnp.float32)
    cfg = dataclasses.replace(configs.get_smoke_config("hubert_xlarge"), dtype=torch.float32)
    ref_params, tree = reference_params(ref_cfg, seed=0)
    batch = next(ref_make_batches(ref_cfg, RefDataConfig(seed=0, batch_size=BATCH, seq_len=SEQ)))
    ocfg = ref_opt.OptimizerConfig(peak_lr=LR, warmup_steps=1, total_steps=4)
    ref_step = jax.jit(ref_opt.make_train_step(ref_build_model(ref_cfg).loss, ocfg, accum_steps=2))
    ref_p, ref_st, ref_m = ref_step(ref_params, ref_opt.init_opt_state(ref_params),
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.from_reference(tree, cfg)
    step = port_opt.make_train_step(build_model(cfg).loss, train_mod.optimizer_config(LR, 4), accum_steps=2)
    params, st, m = step(params, port_opt.init_opt_state(params), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]), rtol=LOSS_RTOL["float32"])
    np.testing.assert_allclose(float(m["grad_norm"]), float(ref_m["grad_norm"]), rtol=1e-5)
    assert not st.mu["embed"].any() and int(st.step) == 1
    np.testing.assert_allclose(params["embed"].detach().numpy(), np.asarray(ref_p["embed"]), rtol=1e-6, atol=0)
    # the first moment is the clipped, accumulated gradient over ten: every leaf
    # within the gradients' tolerance, relative in norm (the parameters after one
    # Adam step are not compared: sign(g) flips for a g near 0)
    ref_mu = convert.flatten(ref_st.mu)
    for path, t in convert.flatten(st.mu).items():
        want = np.asarray(ref_mu[path])
        assert np.linalg.norm(t.numpy() - want) <= 1e-4 * np.linalg.norm(want), path


def test_train_cli_runs_on_the_cpu(capsys):
    out = train_mod.main(["--device", "cpu", "--arch", "gpt-a", "--smoke", "--steps", "4", "--batch", "8",
                          "--seq", "32", "--log-every", "1"])
    text = capsys.readouterr().out
    assert "device=cpu" in text and text.count("\nstep ") == 4
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 4 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    for t in convert.flatten(out["params"]).values():
        assert t.device.type == "cpu" and t.dtype == torch.float32


def test_rwkv_train_cli_runs_on_the_cpu(capsys):
    """RWKV-6 smoke through the launcher: WKV6Fn's plain forward and backward."""
    out = train_mod.main(["--device", "cpu", "--arch", "rwkv6-7b", "--smoke", "--steps", "3"])
    text = capsys.readouterr().out
    assert "arch=rwkv6-smoke device=cpu" in text and text.count("\nstep ") == 2  # steps 0 and the last
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert int(out["opt_state"].step) == 3
