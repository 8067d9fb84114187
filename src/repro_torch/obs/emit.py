"""Span emission helpers shared by every engine.

The engines do not hand-roll event construction: ``simulate`` (and the
horizon runner, per iteration) call :func:`trace_sim_result` on a
finished ``SimResult``; ``atlas_schedule`` calls
:func:`trace_schedule` on a raw ``temporal.Schedule``.  Centralising
emission keeps lane naming, span kinds and the first-witness
:class:`~repro_torch.obs.tracer.Expectation` registration identical across
the event-heap engine, the Atlas list-scheduler and the replicated
baseline path.

Everything here is duck-typed against ``repro_torch.core`` objects
(``SimResult.busy`` intervals, ``temporal.Transfer`` records) so this
module never imports the engines.

The port's own copy of ``repro/obs/emit.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch import units
from repro_torch.obs.tracer import (
    CAT_CHANNEL,
    CAT_GPU,
    Expectation,
    Tracer,
)


def pair_lane(pair: Tuple[int, int], dc_names: Optional[Sequence[str]] = None) -> str:
    """Deterministic lane name for one directed DC pair."""
    a, b = pair
    if dc_names:  # TopologyMatrix defaults to an empty dc_names tuple
        return f"{dc_names[a]}->{dc_names[b]}"
    return f"dc{a}->dc{b}"


def _transfer_pair(tr, stage_dc) -> Tuple[int, int]:
    """Directed DC pair one ``temporal.Transfer`` rides: activations go
    down the stage chain, gradients back up."""
    a, b = stage_dc[tr.boundary], stage_dc[tr.boundary + 1]
    return (a, b) if tr.direction == "act" else (b, a)


def _emit_transfers(
    tracer, transfers, spec, *, label: str, t0_ms: float,
    replicas: int, dc_names=None,
) -> None:
    pid = f"{label}/wan"
    bits_each = units.bytes_to_bits(spec.act_bytes)
    for tr in transfers:
        pair = _transfer_pair(tr, spec.stage_dc)
        if pair[0] == pair[1]:
            continue  # intra-DC hop: not WAN traffic
        dur = tr.end - tr.start
        rate = units.bits_rate_gbps(bits_each, dur) if dur > 0 else 0.0
        tracer.span(
            "transfer",
            CAT_CHANNEL,
            pid,
            pair_lane(pair, dc_names),
            t0_ms + tr.start,
            t0_ms + tr.end,
            pair=list(pair),
            direction=tr.direction,
            pipeline=tr.pipeline,
            micro=tr.micro,
            arrive_ms=t0_ms + tr.arrive,
            bits=bits_each * replicas,
            rate_gbps=rate,
            replicas=replicas,
        )


def trace_sim_result(
    tracer: Tracer,
    res,
    spec,
    *,
    label: str = "sim",
    t0_ms: float = 0.0,
    dc_names: Optional[Sequence[str]] = None,
) -> Optional[Expectation]:
    """Emit one iteration window of a ``SimResult`` and register its
    first-witness expectation.

    GPU lanes get one span per busy interval (named by its kind), one
    per bubble gap and one trailing ``allreduce`` span; the channel
    lanes get one span per WAN transfer when the result carries a
    transfer log (``res.transfers``).  The result's intervals are
    iteration-relative, so the same (possibly cache-reused) result can
    be re-anchored at any ``t0_ms`` — exactly how the horizon runner
    replays reused iterations.
    """
    if tracer is None or not tracer.enabled:
        return None
    total = res.iteration_ms
    pp_end = total - res.allreduce_ms
    gpu_pid = f"{label}/gpu"
    bubble_ms = 0.0
    for key in sorted(res.busy):
        p, s = key
        tid = f"p{p}/s{s}"
        dc = spec.stage_dc[s]
        for iv in res.busy[key]:
            tracer.span(
                iv.kind, CAT_GPU, gpu_pid, tid,
                t0_ms + iv.start, t0_ms + iv.end,
                micro=iv.micro, dc=dc,
            )
        for a, b in res.bubbles.get(key, ()):
            tracer.span(
                "bubble", CAT_GPU, gpu_pid, tid, t0_ms + a, t0_ms + b, dc=dc
            )
            bubble_ms += b - a
        if res.allreduce_ms > 0.0:
            tracer.span(
                "allreduce", CAT_GPU, gpu_pid, tid,
                t0_ms + pp_end, t0_ms + total, dc=dc,
            )
    stats = res.stats or {}
    transfers = getattr(res, "transfers", None)
    wan_expect = None
    if transfers is not None:
        replicas = int(stats.get("replicated_pipelines", 1))
        _emit_transfers(
            tracer, transfers, spec,
            label=label, t0_ms=t0_ms, replicas=replicas, dc_names=dc_names,
        )
        wan = stats.get("wan_bits")
        if wan is not None:
            wan_expect = tuple(sorted((tuple(p), b) for p, b in wan.items()))
    exp = Expectation(
        label=label,
        t0_ms=t0_ms,
        t1_ms=t0_ms + total,
        n_lanes=len(res.busy),
        utilization=res.utilization,
        allreduce_ms=res.allreduce_ms,
        bubble_ms=bubble_ms,
        wan_bits=wan_expect,
    )
    tracer.expect(exp)
    return exp


def trace_schedule(
    tracer: Tracer,
    sched,
    spec,
    *,
    label: str = "atlas",
    t0_ms: float = 0.0,
    dc_names: Optional[Sequence[str]] = None,
) -> None:
    """Emit a raw ``temporal.Schedule``: one GPU span per task, one
    channel span per WAN transfer.  Used by ``atlas_schedule`` callers
    who want the schedule's timeline without running ``simulate``;
    spans carry no bubble/allreduce accounting, so no expectation is
    registered."""
    if tracer is None or not tracer.enabled:
        return
    gpu_pid = f"{label}/gpu"
    for task in sched.tasks:
        tracer.span(
            task.kind, CAT_GPU, gpu_pid, f"p{task.pipeline}/s{task.stage}",
            t0_ms + task.start, t0_ms + task.end,
            micro=task.micro, dc=spec.stage_dc[task.stage],
        )
    _emit_transfers(
        tracer, sched.transfers, spec,
        label=label, t0_ms=t0_ms, replicas=1, dc_names=dc_names,
    )
