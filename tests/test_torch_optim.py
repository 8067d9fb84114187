"""The port's AdamW (``repro_torch.optim.optimizer``) against the reference's
``repro.optim.optimizer`` on the same numpy parameters and gradients: the
schedule, clipping, decay on matrices only, five updates in a row, and
gradient accumulation equal to the full batch (``tests/test_substrate.py``'s
optimizer tests, mirrored)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as ref_opt
from repro_torch import configs, convert
from repro_torch.data.pipeline import input_batch_for
from repro_torch.models.transformer import build_model
from repro_torch.optim.optimizer import (
    OptimizerConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_at,
    make_train_step,
)

# both compute in f32 in the same order; XLA and torch may round a fused
# multiply-add once where the other rounds twice: a few ulp after five steps
STEP_TOL = dict(rtol=1e-6, atol=1e-7)


def _ref_cfg(cfg: OptimizerConfig):
    return ref_opt.OptimizerConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 99, 100, 150])
def test_lr_schedule_matches_reference(step):
    cfg = OptimizerConfig(peak_lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    got = float(lr_at(cfg, torch.tensor(step, dtype=torch.int32)))
    want = float(ref_opt.lr_at(_ref_cfg(cfg), jnp.int32(step)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_lr_schedule_shape():
    cfg = OptimizerConfig(peak_lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(lr_at(cfg, torch.tensor(0))) == 0.0
    assert float(lr_at(cfg, torch.tensor(10))) == pytest.approx(1.0, rel=1e-3)
    assert float(lr_at(cfg, torch.tensor(100))) == pytest.approx(0.1, rel=1e-2)
    assert 0.1 < float(lr_at(cfg, torch.tensor(55))) < 1.0


def test_grad_clipping():
    cfg = OptimizerConfig(clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 100.0)}
    _, st2, m = adamw_update(cfg, grads, params, init_opt_state(params))
    assert float(m["grad_norm"]) == pytest.approx(400.0)
    # clipped: first moment magnitude bounded by (1-b1)*clip-scaled grad
    assert float(st2.mu["w"].abs().max()) < 1.0
    np.testing.assert_allclose(st2.mu["w"].numpy(), np.full((4, 4), 0.1 * 100.0 / (400.0 + 1e-9), np.float32), rtol=1e-6)


def test_weight_decay_only_on_matrices():
    cfg = OptimizerConfig(weight_decay=1.0, peak_lr=0.1, warmup_steps=0, total_steps=10)
    params = {"w": torch.ones((4, 4)), "scale": torch.ones((4,))}
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _, _ = adamw_update(cfg, grads, params, init_opt_state(params))
    assert float((p2["scale"] - 1.0).abs().max()) < 1e-6  # untouched
    assert float(p2["w"].max()) < 1.0  # decayed


def test_five_updates_match_reference():
    rng = np.random.default_rng(0)
    shapes = {"embed": (6, 4), "layers": {"ln1": (2, 4), "w": (2, 4, 3)}, "norm": (4,)}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in s.items()}

    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [tree(lambda s: (rng.standard_normal(s) * 0.7).astype(np.float32)) for _ in range(5)]
    cfg = OptimizerConfig(peak_lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1, clip_norm=1.0)

    tp = convert.unflatten({k: torch.from_numpy(v.copy()) for k, v in convert.flatten(params).items()})
    st = init_opt_state(tp)
    jp = {k: jnp.asarray(v) for k, v in convert.flatten(params).items()}
    jst = ref_opt.init_opt_state(jp)
    for g in grads:
        flat_g = convert.flatten(g)
        tp, st, m = adamw_update(cfg, convert.unflatten({k: torch.from_numpy(v) for k, v in flat_g.items()}), tp, st)
        jp, jst, jm = ref_opt.adamw_update(_ref_cfg(cfg), {k: jnp.asarray(v) for k, v in flat_g.items()}, jp, jst)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(st.step) == int(jst.step) == 5
    for name, got, want in (("params", tp, jp), ("mu", st.mu, jst.mu), ("nu", st.nu, jst.nu)):
        for path, t in convert.flatten(got).items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[path]), **STEP_TOL, err_msg=f"{name} {path}")


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    leaves = {"a": rng.standard_normal((5, 3)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32)}
    got = float(global_norm({k: torch.from_numpy(v) for k, v in leaves.items()}))
    want = float(ref_opt.global_norm({k: jnp.asarray(v) for k, v in leaves.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_grad_accumulation_matches_full_batch():
    """accum_steps=4 over 4 microbatches gives the full batch's loss and, in
    the first moment after one step (0.1 x the clipped gradient), its
    gradients; the parameters agree at the reference test's tolerance."""
    cfg = dataclasses.replace(configs.get_smoke_config("gpt_a"), dtype=torch.float32)
    model = build_model(cfg)
    batch = {k: torch.from_numpy(v) for k, v in input_batch_for(cfg, 8, 32).items()}
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10)
    out = {}
    for accum in (1, 4):
        params = model.init(torch.Generator().manual_seed(0))
        st = init_opt_state(params)
        params, st, m = make_train_step(model.loss, ocfg, accum_steps=accum)(params, st, batch)
        out[accum] = (params, st, m)
    np.testing.assert_allclose(float(out[4][2]["loss"]), float(out[1][2]["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(out[4][2]["grad_norm"]), float(out[1][2]["grad_norm"]), rtol=1e-5)
    for path, mu in convert.flatten(out[4][1].mu).items():
        want = convert.flatten(out[1][1].mu)[path]
        assert float((mu - want).norm() / want.norm()) < 1e-5, path
    for path, p in convert.flatten(out[4][0]).items():
        np.testing.assert_allclose(p.detach().numpy(), convert.flatten(out[1][0])[path].detach().numpy(), atol=5e-3, rtol=5e-2)
