"""A training cell: the program's ``make_train_step`` over the mix's batches.

Set-up makes the weights and the optimizer state from the seed, builds the
step, and drives it through its ``CHECKED_STEPS`` first steps, which
warm every shape the window uses.  It keeps what the checks read: each step's
loss, the global gradient norm of step 1, each leaf's gradient as AdamW took
it at step 1 (its first moment over 1 - b1) and each leaf's change over the
steps before the last (against the leaf made again from the seed): the last
step's loss needs only the reference's forward, which keeps its time inside
a run's.  The same step,
state and feed then run back to back for the window, each step ending in a
synchronisation.  With ``--trace 1`` the window makes the step's two calls
itself (``accumulated_value_and_grad``, then ``adamw_update``) between CUDA
events, and traces ``TRACE_STEPS`` of its steps with the profiler.

After the window the program's state is freed and the reference follows the
checked steps in float32 from the same weights and batches."""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import torch

from chipbench import compare, generator, trace, weights
from chipbench.device import Marks, free, peak_bytes, sync
from chipbench.reference.common import AdamW, Precision, exact
from chipbench.spec import load_module, shapes

CHECKED_STEPS = 2  # the first steps, which the reference follows (two of three: a run has to end in its time)
TRACE_STEPS = 2  # the steps a --trace 1 run profiles
SKETCH = 8  # random projections of each leaf's gradient, whose gaps estimate the norm of a difference


def _feed(mix, vocab, seed, device):
    for rows in generator.train_batches(mix, vocab, seed):
        yield {"tokens": torch.from_numpy(rows).to(device)}


def _program_step(ctx, model, opt_cfg, mix):
    from repro_torch.optim.optimizer import make_train_step

    loss_fn = model.loss
    if ctx.fault == "half_batch":  # the mean taken over the first half of each microbatch
        loss_fn = lambda p, b: model.loss(p, {"tokens": b["tokens"][: b["tokens"].shape[0] // 2]})  # noqa: E731
    step = make_train_step(loss_fn, opt_cfg, accum_steps=mix["accum_steps"])
    if ctx.fault == "frozen":  # the state handed back unchanged
        from repro_torch.optim.optimizer import accumulated_value_and_grad

        def step(params, state, batch):  # noqa: F811
            loss, _, _ = accumulated_value_and_grad(loss_fn, params, batch, accum_steps=mix["accum_steps"])
            return params, state, {"loss": loss, "grad_norm": torch.zeros(())}
    return step, loss_fn


def _leaf_norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in leaves.items()}


def _sketch(leaves: Dict[str, torch.Tensor], seed: int, scale: float) -> Dict[str, List[float]]:
    """Each leaf's products with ``SKETCH`` Gaussian vectors drawn from the
    seed and the leaf's name, times ``scale``: the same vectors on both sides."""
    out = {}
    for i, k in enumerate(sorted(leaves)):
        x = leaves[k].detach().float().flatten()
        gen = torch.Generator(device=x.device)
        row = []
        for j in range(SKETCH):
            gen.manual_seed((int(seed) * 1_000_003 + 7919 * (i + 1) + 104_729 * (j + 1)) % (2**63 - 1))
            row.append(float(torch.dot(x, torch.randn(x.shape, generator=gen, device=x.device))) * scale)
        out[k] = row
    return out


def _changes(params, layout, seed, device) -> Dict[str, float]:
    out = {}
    for i, (path, _, _) in enumerate(layout):
        p0 = weights.leaf(layout, i, seed, device, torch.float32)
        out["/".join(path)] = float((weights.get(params, path).detach() - p0).double().norm())
        del p0
    return out


def run(ctx) -> Dict[str, Any]:
    """The program's run (``program``), then its check against the reference."""
    rec = program(ctx)
    mix, m = ctx.cell.traffic, shapes(ctx.cell.config)
    ref = load_module("reference", ctx.cell.config["reference"])
    t_ref = time.perf_counter()
    want = follow(ref, m, mix, ref.layout(m), ctx.seed, ctx.device, Precision("f32"), CHECKED_STEPS)
    rec["reference_s"] = time.perf_counter() - t_ref
    rec["numbers"] = compare.train_numbers(rec["got"], want, ctx.cell.limits)
    return rec


def program(ctx) -> Dict[str, Any]:
    """Set-up, the checked steps and the window; the program's state freed
    before it returns.  ``got`` holds what the checks compare."""
    from repro_torch.convert import flatten
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.optimizer import OptimizerConfig, adamw_update, accumulated_value_and_grad, init_opt_state

    mix, m, dev = ctx.cell.traffic, shapes(ctx.cell.config), ctx.device
    ref = load_module("reference", ctx.cell.config["reference"])
    layout = ref.layout(m)
    opt_cfg = OptimizerConfig(**mix["optimizer"])
    model = build_model(ctx.model_cfg)
    params = weights.make(layout, ctx.seed, dev, lambda path: torch.float32)
    state = init_opt_state(params)
    step, loss_fn = _program_step(ctx, model, opt_cfg, mix)
    feed = _feed(mix, m["vocab_size"], ctx.seed, dev)

    got: Dict[str, Any] = {"loss": []}
    for i in range(CHECKED_STEPS):
        params, state, met = step(params, state, next(feed))
        got["loss"].append(float(met["loss"]))
        if i == 0:
            got["grad_norm"] = float(met["grad_norm"])
            mu = flatten(state.mu)
            got["grad_leaf"] = {k: n / (1 - opt_cfg.b1) for k, n in _leaf_norms(mu).items()}
            got["grad_sketch"] = _sketch(mu, ctx.seed, 1 / (1 - opt_cfg.b1))
        if i == CHECKED_STEPS - 2:
            got["change_leaf"] = _changes(params, layout, ctx.seed, dev)
    sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    tokens_a_step = mix["accum_steps"] * mix["micro_batch"] * mix["seq_len"]
    run: Dict[str, Any] = {"setup_s": setup_s, "tokens_a_step": tokens_a_step}
    steps, t0 = 0, time.perf_counter()
    if not ctx.trace:
        while True:
            params, state, _ = step(params, state, next(feed))
            sync(dev)
            steps += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        run["window_s"] = time.perf_counter() - t0
    else:
        window = trace.Window()
        fwd_bwd, adamw, untraced_s, untraced = [], [], 0.0, 0

        def timed_step(keep: bool):
            nonlocal params, state
            marks = Marks(dev, 3)
            batch = next(feed)
            marks.mark(0)
            _, _, grads = accumulated_value_and_grad(loss_fn, params, batch, accum_steps=mix["accum_steps"])
            marks.mark(1)
            params, state, _ = adamw_update(opt_cfg, grads, params, state)
            marks.mark(2)
            sync(dev)
            if keep:  # the profiled steps' device times carry the profiler's gaps
                fwd_bwd.append(marks.ms(0, 1))
                adamw.append(marks.ms(1, 2))

        while True:
            s0 = time.perf_counter()
            if steps == 1:  # the second step of the window onwards, traced
                with trace.traced(window, dev):
                    for _ in range(TRACE_STEPS):
                        timed_step(False)
                steps += TRACE_STEPS
            else:
                timed_step(True)
                steps += 1
                untraced_s += time.perf_counter() - s0
                untraced += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        run.update(window_s=time.perf_counter() - t0, trace=window, fwd_bwd_ms=fwd_bwd, adamw_ms=adamw,
                   untraced_steps=untraced, untraced_s=untraced_s)
    run["steps"] = steps
    run["memory_peak_bytes"] = peak_bytes(dev)

    run["attempted"], run["failed"], run["got"] = steps + CHECKED_STEPS, 0, got
    del params, state, step, loss_fn, feed, model
    gc.collect()
    free(dev)
    return run


def follow(ref, m, mix, layout, seed, device, prec: Precision, n_steps: int) -> Dict[str, Any]:
    """The reference's first ``n_steps`` steps from the seed's weights and
    batches: each step's loss, step 1's global gradient norm and each leaf's
    clipped gradient norm, each leaf's change over the steps before the last,
    whose loss is taken without a gradient."""
    exact()
    params = weights.make(layout, seed, device, lambda path: torch.float32)
    paths = ["/".join(p) for p, _, _ in layout]
    leaves = [weights.get(params, p) for p, _, _ in layout]
    for p in leaves:
        p.requires_grad_(True)
    opt = AdamW(mix["optimizer"], leaves)
    feed = generator.train_batches(mix, m["vocab_size"], seed)
    A, rows = mix["accum_steps"], mix["micro_batch"]
    out: Dict[str, Any] = {"loss": []}
    for i in range(n_steps):
        tokens = torch.from_numpy(next(feed)).to(device)
        last = i == n_steps - 1
        total = 0.0
        with torch.set_grad_enabled(not last):
            for a in range(A):
                loss = ref.loss(m, prec, params, tokens[a * rows:(a + 1) * rows]) / A
                if not last:
                    loss.backward()
                total += float(loss.detach())
        out["loss"].append(total)
        if last:
            break
        norm, seen = opt.update([p.detach() for p in leaves], [p.grad for p in leaves])
        for p in leaves:
            p.grad = None
        if i == 0:
            out["grad_norm"], out["grad_leaf"] = norm, dict(zip(paths, seen))
            out["grad_sketch"] = _sketch(dict(zip(paths, opt.mu)), seed, 1 / (1 - mix["optimizer"]["b1"]))
    out["change_leaf"] = _changes(params, layout, seed, device)
    del params, leaves, opt
    gc.collect()
    free(device)
    return out

