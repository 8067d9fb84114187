"""A prefill-service cell: the program's ``SplitwiseCluster.serve`` (a
batched prefill on one engine, the cache copied to the other) under a closed
loop of ``clients`` clients (``generator.prompts``).

Set-up makes the served weights from the seed, builds the cluster and serves
the cycle's longest and shortest groups (``generator.groups``), the largest
and smallest tensors of the masked attention that every batch of the cycle
takes.  In the window every client has one request outstanding: whenever the
cluster is free the oldest waiting requests, up to ``max_batch``, go to
``serve`` together, which ends in a synchronisation, and each client served
issues its next request.  A request's time to first token runs from its
issue to the end of the call that served it.  Once ``--seconds`` have passed
the clients issue only what completes the cycle of lengths in progress, so
that every seed's window serves whole cycles (the same batches, in the
seed's order); the requests still waiting are served, and the window closes
when the last is answered.

The checks: a sample of the requests drawn from the seed (``CHECK_REQUESTS``
of them, with a longest prompt of the cycle among them).  For each, the
cache handed to the decode side is projected, layer by layer, on a fixed
random probe as the call hands it over (``decode_batch``'s argument); after
the window and with the cluster freed, the reference runs the prompt in
float32 and gives its logits and probed K and V."""
from __future__ import annotations

import collections
import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from chipbench import compare, generator, trace, weights
from chipbench.device import free, peak_bytes, sync
from chipbench.reference.common import Precision, exact
from chipbench.spec import load_module, shapes

CHECK_REQUESTS = 48  # requests the check compares
CHECK_SHARE = 0.35  # of the requests, drawn from the seed as they are issued, whose caches are kept
TRACE_FROM_BATCH, TRACE_BATCHES = 4, 3  # the calls a --trace 1 run profiles


def _dtype_of(ref, serve_dtype):
    return lambda path: torch.float32 if path[-1] in ref.F32_LEAVES else serve_dtype


def probe_matrix(m: Dict[str, Any], seed: int, device) -> torch.Tensor:
    """(H * D, P) f32, columns of unit norm."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63 - 1) + 1)
    width = m["num_heads"] * m["head_dim"]
    p = torch.randn(width, 4, generator=gen, device=device)
    return p / p.norm(dim=0, keepdim=True)


def check_sample(kept: List[int], lengths: Dict[int, int], longest: int, seed: int) -> List[int]:
    """``CHECK_REQUESTS`` of the kept requests, drawn from the seed, the first
    one of the cycle's longest prompt among them."""
    first = next((i for i in kept if lengths[i] == longest), None)
    rng = np.random.default_rng((int(seed), 1))
    others = [kept[i] for i in rng.permutation(len(kept)) if kept[i] != first]
    return sorted(([first] if first is not None else []) + others[: CHECK_REQUESTS - (first is not None)])


def run(ctx) -> Dict[str, Any]:
    """The program's run (``program``), then its check against the reference."""
    rec = program(ctx)
    m = shapes(ctx.cell.config)
    ref = load_module("reference", ctx.cell.config["reference"])
    t_ref = time.perf_counter()
    gap, cache_gap = check(ref, m, ctx.seed, ctx.device, rec["got"], Precision("f32"))
    rec["reference_s"] = time.perf_counter() - t_ref
    rec["numbers"] = compare.serve_numbers(gap, cache_gap, ctx.cell.limits)
    return rec


def program(ctx) -> Dict[str, Any]:
    """Set-up and the window; the cluster freed before it returns.  ``got``
    holds what the checks compare: the sampled prompts, their served tokens
    and handed-over caches (probed), and the probe."""
    from repro_torch.serving.engine import Request, SplitwiseCluster

    mix, m, dev = ctx.cell.traffic, shapes(ctx.cell.config), ctx.device
    ref = load_module("reference", ctx.cell.config["reference"])
    params = served_weights(ref, m, ctx.seed, dev)
    cluster = SplitwiseCluster(ctx.model_cfg, params, max_batch=mix["max_batch"], max_len=mix["ring"], device=dev)
    cut = generator.groups(mix)
    longest = max(max(g) for g in cut)
    stream = generator.prompts(mix, m["vocab_size"], ctx.seed)
    keep_draw = np.random.default_rng((int(ctx.seed), 2))
    probe = probe_matrix(m, ctx.seed, dev)
    kept: Dict[int, Any] = {}

    decode_batch = cluster.decode_engine.decode_batch

    def handed_over(requests, cache, *args, **kwargs):  # the cache as the decode side receives it
        for i, r in enumerate(requests):
            if r.req_id in keep:
                n = len(r.prompt)
                kept[r.req_id] = tuple(
                    torch.stack([layer[i, :n].float().flatten(1) @ probe for layer in cache[key]])
                    * (0.0 if ctx.fault == "frozen" else 1.0)  # the fault: the handed-over state left empty
                    for key in ("k", "v"))
        return decode_batch(requests, cache, *args, **kwargs)

    cluster.decode_engine.decode_batch = handed_over

    def serve(batch: List[Request]) -> None:
        if ctx.fault == "half_batch":  # the second half of the batch never served
            batch = batch[: max(1, len(batch) // 2)]
        cluster.serve(batch)
        sync(dev)
        if ctx.fault == "token":  # a served token altered
            for r in batch:
                r.generated[0] = (r.generated[0] + 1) % m["vocab_size"]

    warm = np.random.default_rng((int(ctx.seed), 5))
    keep: set = set()
    for group in (max(cut, key=max), min(cut, key=max)):
        serve([Request(-1, warm.integers(0, m["vocab_size"], size=n, dtype=np.int32), max_new_tokens=1)
               for n in group])
    setup_s = time.perf_counter() - ctx.t_start

    objs: List[Request] = []
    issued: List[float] = []
    waiting: collections.deque = collections.deque()

    def issue(at: float) -> None:  # a client's next request
        i = len(objs)
        objs.append(Request(i, next(stream), max_new_tokens=mix["max_new_tokens"]))
        issued.append(at)
        first_longest = len(objs[i].prompt) == longest and not any(len(objs[j].prompt) == longest for j in keep)
        if keep_draw.random() < CHECK_SHARE or first_longest:
            keep.add(i)
        waiting.append(i)

    ttft, batch_log, slots, pads, batches = {}, [], 0, 0, 0
    window = trace.Window()
    t0 = time.perf_counter()
    for _ in range(mix["clients"]):
        issue(0.0)
    while waiting:
        ids = [waiting.popleft() for _ in range(min(mix["max_batch"], len(waiting)))]
        batch = [objs[i] for i in ids]
        widest = max(len(r.prompt) for r in batch)
        slots += widest * len(batch)
        pads += sum(widest - len(r.prompt) for r in batch)
        s0 = time.perf_counter()
        traced = ctx.trace and TRACE_FROM_BATCH <= batches < TRACE_FROM_BATCH + TRACE_BATCHES
        if traced:
            with trace.traced(window, dev):
                serve(batch)
        else:
            serve(batch)
        done = time.perf_counter()
        batch_log.append({"lengths": [len(r.prompt) for r in batch], "seconds": done - s0, "traced": traced})
        batches += 1
        for i in ids:
            ttft[i] = done - t0 - issued[i]
            if done - t0 < ctx.seconds or len(objs) % mix["lengths"]["cycle"]:
                issue(done - t0)
    window_s = time.perf_counter() - t0

    failed = [r.req_id for r in objs if not r.generated]
    run: Dict[str, Any] = {
        "setup_s": setup_s, "window_s": window_s, "ttft_s": [ttft[i] for i in sorted(ttft)],
        "batch_log": batch_log, "slots": slots, "pad_slots": pads, "batches": batches,
        "valid_tokens": sum(len(r.prompt) for r in objs if r.generated),
        "memory_peak_bytes": peak_bytes(dev), "attempted": len(objs), "failed": len(failed),
    }
    if ctx.trace:
        run["trace"] = window
    sampled = check_sample(sorted(kept), {i: len(objs[i].prompt) for i in kept}, longest, ctx.seed)
    run["got"] = {"served": {i: objs[i].generated[0] for i in sampled if objs[i].generated},
                  "prompts": {i: objs[i].prompt for i in sampled},
                  "kept": {i: tuple(t.cpu() for t in kept[i]) for i in sampled}, "probe": probe}
    del cluster, params, objs, kept, decode_batch, handed_over
    gc.collect()
    free(dev)
    return run


def _layer_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst layer's || got - want || / || want || over (L, T, P)."""
    return float(((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max())


def served_weights(ref, m, seed, device):
    return weights.make(ref.layout(m), seed, device, _dtype_of(ref, getattr(torch, m["dtype"])))


def check(ref, m, seed, device, got, prec: Precision):
    """(the widest served-token gap, the worst cache gap) over the sampled
    requests; a sampled request that was not served reads as infinite."""
    exact()
    params = served_weights(ref, m, seed, device)
    gap, cache_gap = 0.0, 0.0
    for i, prompt in sorted(got["prompts"].items()):
        if i not in got["served"] or i not in got["kept"]:
            return float("inf"), float("inf")
        logits, k, v = ref.prefill(m, prec, params, torch.from_numpy(prompt).to(device), got["probe"])
        logits = logits[-1]
        gap = max(gap, float(logits.max() - logits[got["served"][i]]))
        kept = got["kept"][i]
        cache_gap = max(cache_gap, _layer_gap(kept[0], k.cpu()), _layer_gap(kept[1], v.cpu()))
    del params
    gc.collect()
    free(device)
    return gap, cache_gap


def control(ref, m, seed, device, got) -> tuple:
    """The control's numbers on the same prompts: the reference in float8 in
    the program's place, read at every position (the float32 reference's gap
    of the token the control puts first) and its K and V against float32's."""
    exact()
    params = served_weights(ref, m, seed, device)
    gap, cache_gap = 0.0, 0.0
    for _, prompt in sorted(got["prompts"].items()):
        tokens = torch.from_numpy(prompt).to(device)
        want, wk, wv = ref.prefill(m, Precision("f32"), params, tokens, got["probe"], all_logits=True)
        low, lk, lv = ref.prefill(m, Precision("fp8"), params, tokens, got["probe"], all_logits=True)
        picked = want.gather(-1, low.argmax(-1, keepdim=True))[:, 0]
        gap = max(gap, float((want.max(-1).values - picked).max()))
        cache_gap = max(cache_gap, _layer_gap(lk.cpu(), wk.cpu()), _layer_gap(lv.cpu(), wv.cpu()))
    del params
    gc.collect()
    free(device)
    return gap, cache_gap
