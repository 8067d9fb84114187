"""What-if DC planning (paper §4.5): sweep candidate DC sets and GPU
counts through Algorithm 1 and print the cost/performance frontier — no
deployment required.  Includes the branch-and-bound placement search on
a world-spanning 8-DC WAN (exhaustive search would need 40320 orders
per D), and a time-varying scenario: diurnal congestion plus a
directed-link outage, priced by per-direction *worst-segment* bandwidth
(``wan.BandwidthSchedule``) so the search routes the pipeline around
the degraded pair — bandwidth-asymmetric, not just latency-aware.

  PYTHONPATH=src python -m repro_torch.examples.whatif

Viewing a run in Perfetto
-------------------------

Pass ``--trace out.json`` to additionally record the multi-job fleet
cascade scenario (the unplanned a->b outage that pushes job A's re-plan
onto job B's channel) with a :class:`repro_torch.obs.RecordingTracer` and
export it as Chrome trace-event JSON:

  PYTHONPATH=src python -m repro_torch.examples.whatif --trace out.json

Then open https://ui.perfetto.dev and drag ``out.json`` in (or load it
in ``chrome://tracing``).  What you will see:

* one process group per job (``A/gpu``, ``B/gpu``) with a thread lane
  per (pipeline, stage) showing fwd/bwd/bubble/allreduce spans, plus a
  ``migration-stall`` span across every lane while A re-plans;
* ``A/wan`` / ``B/wan`` process groups with one lane per directed DC
  pair showing each activation/gradient transfer, sized by priced
  bandwidth — watch the a->b lane stretch 10x when the outage starts;
* a ``fleet/wan`` group showing the allocator's channel-reservation
  ledger (who held which pair, at what granted rate), and
  ``fleet/alloc`` grant/throttle instants per scheduling window;
* per-job ``*/control`` groups with drift-fire / re-plan / migration /
  outage instants — B's drift fire lands *after* A's migration arrives
  on its channel, which is the cascade the scenario demonstrates.

Before the file is written the recorded spans are re-audited against
the engines' own accounting (``repro_torch.obs.verify_trace``): per-window
busy/bubble/allreduce totals, utilization and per-channel bits must
match ``SimResult.stats`` exactly, so the picture you load is a second
witness to the numbers the run printed, not a best-effort log.  The
same file round-trips through ``python -m repro_torch.obs report out.json``
(metrics summary) and ``python -m repro_torch.obs validate out.json``
(structural + dead-DC checks).
"""
import argparse
import dataclasses
import time

from repro_torch.core import topology, wan
from repro_torch.core.dc_selection import JobModel, algorithm1, best_plan, what_if


def main(trace_path=None):
    # a Llama-70B-ish pretraining job: 80 layers, 875M params/layer
    job = JobModel(
        t_fwd_ms=2 * 875e6 * 4096 / 312e12 * 1e3,  # one microbatch, one layer-partition
        act_bytes=wan.activation_bytes(1, 4096, 8192),
        partition_param_bytes=875e6 * 2,
        microbatches=64,
    )
    print(f"comm/compute ratio C = {job.comm_compute_ratio:.1f}")

    scenarios = {
        "single-dc-1200": {"virginia": 1200},
        "two-equal-600": {"virginia": 600, "oregon": 600},
        "paper-dc-set-2": {"a": 600, "b": 500, "c": 400, "d": 300, "e": 200},
        "lopsided-1000+10": {"virginia": 1000, "saopaulo": 10},
    }
    out = what_if(job, scenarios, P=80, gpu_cost_per_hour=2.0)
    print(f"{'scenario':18s} {'D':>3s} {'gpus':>5s} {'iter_ms':>9s} "
          f"{'thr':>8s} {'$ /iter':>8s}  partitions")
    for name, v in out.items():
        print(f"{name:18s} {v['best_D']:3d} {v['gpus_used']:5d} "
              f"{v['total_ms']:9.0f} {v['throughput']:8.4f} "
              f"{v['cost_per_iteration']:8.4f}  {v['partitions']}")

    # heterogeneous WAN: the same fleet on a skewed topology — the
    # topology-aware placement search keeps the slow pair off the cut
    print("\nSkewed-WAN placement (dc0<->dc2 is 150 ms single-TCP):")
    fleet = {"dc0": 16, "dc1": 16, "dc2": 20}  # must span all three DCs
    job_skew = dataclasses.replace(job, topology=topology.skewed_3dc())
    for tag, search in (("topology-aware", None), ("availability-order", False)):
        b = best_plan(algorithm1(job_skew, fleet, P=40, C=1, search_orders=search))
        order = ">".join(d for d in b.dc_order if b.partitions.get(d, 0))
        print(f"  {tag:18s} iter={b.total_ms:9.0f}ms  order={order}")

    # 8-DC world WAN: the pruned (branch-and-bound) placement search —
    # beyond the old 6-DC exhaustive cap — routes the pipeline along the
    # geographic chain instead of criss-crossing oceans
    print("\n8-DC placement search (branch-and-bound, latencies ~ geography):")
    cities = ("virginia", "oregon", "frankfurt", "dublin", "tokyo",
              "singapore", "sydney", "saopaulo")
    lat = [
        #  vir   ore   fra   dub   tok   sin   syd   sao
        [0.0,  60.0,  90.0, 70.0, 150.0, 210.0, 200.0, 120.0],
        [60.0,  0.0, 140.0, 120.0, 100.0, 160.0, 140.0, 180.0],
        [90.0, 140.0,  0.0, 25.0, 230.0, 160.0, 280.0, 190.0],
        [70.0, 120.0, 25.0,  0.0, 210.0, 180.0, 260.0, 170.0],
        [150.0, 100.0, 230.0, 210.0, 0.0, 70.0, 110.0, 260.0],
        [210.0, 160.0, 160.0, 180.0, 70.0, 0.0, 90.0, 320.0],
        [200.0, 140.0, 280.0, 260.0, 110.0, 90.0, 0.0, 310.0],
        [120.0, 180.0, 190.0, 170.0, 260.0, 320.0, 310.0, 0.0],
    ]
    world = topology.TopologyMatrix.from_latency(lat, multi_tcp=True,
                                                 dc_names=cities, name="world8")
    job_world = dataclasses.replace(job, topology=world, microbatches=64)
    fleet8 = {c: 60 for c in cities}  # every DC must hold partitions
    t0 = time.perf_counter()
    b = best_plan(algorithm1(job_world, fleet8, P=24, C=2, search_orders=True))
    dt_ms = (time.perf_counter() - t0) * 1e3
    order = ">".join(d for d in b.dc_order if b.partitions.get(d, 0))
    print(f"  searched 8 DCs in {dt_ms:.0f} ms (exhaustive would scan 8! orders)")
    print(f"  best iter={b.total_ms:9.0f}ms  D={b.D}  order={order}")

    # time-varying WAN (paper Fig 7): diurnal congestion everywhere plus
    # a 6-hour outage-reroute on one *direction* of the pair the static
    # plan crossed first.  Algorithm 1 prices every boundary at its
    # worst-segment bandwidth per direction, so the placement search
    # routes the pipeline around the degraded pair instead of riding a
    # link that will collapse mid-iteration.
    print("\nTime-varying WAN (diurnal dip + directed outage, worst-segment pricing):")
    a0, a1 = b.dc_order[0], b.dc_order[1]  # first boundary of the static plan
    i0, i1 = world.index_of(a0), world.index_of(a1)
    scheds = {
        (a, c): wan.BandwidthSchedule.diurnal(
            peak_gbps=world.link(a, c).bw_gbps,
            trough_gbps=0.8 * world.link(a, c).bw_gbps,
        )
        for a, c in world.wan_pairs()
    }
    scheds[(i0, i1)] = wan.BandwidthSchedule.outage(
        world.link(i0, i1).bw_gbps,
        start_ms=2 * 3.6e6, end_ms=8 * 3.6e6,
        degraded_gbps=0.1 * world.link(i0, i1).bw_gbps,
    )
    job_tv = dataclasses.replace(
        job_world, topology=world.with_bandwidth_schedules(scheds)
    )
    b_tv = best_plan(algorithm1(job_tv, fleet8, P=24, C=2, search_orders=True))
    order_tv = ">".join(d for d in b_tv.dc_order if b_tv.partitions.get(d, 0))
    print(f"  outage {a0}->{a1} (10x degradation, hours 2-8), ~20% diurnal dip")
    print(f"  best iter={b_tv.total_ms:9.0f}ms  D={b_tv.D}  order={order_tv}")
    adj = [tuple(sorted((b_tv.dc_order[i], b_tv.dc_order[i + 1])))
           for i in range(len(order_tv.split('>')) - 1)]
    routed = tuple(sorted((a0, a1))) not in adj
    print(f"  degraded pair off the stage boundaries: {routed}")

    # reactive control plane: the planner did NOT know about
    # the outage this time.  A static plan rides the degraded direction
    # for the whole window; the control plane detects the sustained
    # delivery miss, re-runs Algorithm 1 on the observed WAN, pays the
    # stage migration, and routes around — then migrates nothing when
    # the link recovers and the incumbent is already cost-equal.
    print("\nReplan vs static under an unplanned outage (control plane):")
    from repro_torch.core import control

    lat3 = [[0.0, 20.0, 20.0], [20.0, 0.0, 20.0], [20.0, 20.0, 0.0]]
    tri = topology.TopologyMatrix.from_latency(
        lat3, multi_tcp=True, dc_names=("east", "central", "west"))
    bw3 = tri.link(0, 1).bw_gbps
    live = tri.with_bandwidth_schedules({
        (0, 1): wan.BandwidthSchedule.outage(
            bw3, 10_000.0, 200_000.0, bw3 / 10.0),
        (1, 0): wan.BandwidthSchedule.flat(bw3),
    })
    job3 = dataclasses.replace(
        job, act_bytes=1e7, partition_param_bytes=2e8, microbatches=24,
        topology=None)
    fleet3 = {"east": 4, "central": 4, "west": 4}
    kw3 = dict(P=10, live_topo=live, planned_topo=tri, n_iterations=80, C=1)
    st = control.simulate_horizon(job3, fleet3, **kw3)
    rx = control.simulate_horizon(
        job3, fleet3, control=control.ControlConfig(), **kw3)
    print(f"  outage: east->central drops 10x over [10s, 200s] "
          f"(planner assumed nominal)")
    print(f"  static plan : {st.total_ms/1e3:8.1f}s for "
          f"{st.samples:.0f} samples, {st.replans} re-plans")
    print(f"  reactive    : {rx.total_ms/1e3:8.1f}s "
          f"({rx.replans} re-plan(s), {rx.migration_ms/1e3:.1f}s migrating, "
          f"{rx.stats['replans_noop']} no-op re-anchor(s) on recovery)")
    for m in rx.migrations:
        names = tri.dc_names
        moved = ", ".join(f"stage {i}: {names[a]}->{names[b]}"
                          for i, a, b in m.moves)
        print(f"    t={m.at_ms/1e3:7.1f}s migrated [{moved}] in "
              f"{m.duration_ms/1e3:.1f}s (projected gain "
              f"{m.projected_gain_ms/1e3:.0f}s over "
              f"{m.remaining_samples:.0f} remaining samples)")
    for e in rx.epochs:
        used = ">".join(d for d in e.plan.dc_order if e.plan.partitions.get(d, 0))
        print(f"    epoch {e.index}: {e.iterations} iterations on {used}")
    print(f"  reactive saves {(st.total_ms - rx.total_ms)/1e3:.1f}s "
          f"end-to-end, migration stall included")

    # multi-job fleet sharing one WAN: the links above were a
    # single job's private network; real fleets contend.  Two jobs whose
    # channel demands FIT one shared pair together lose nothing under
    # contention-aware temporal sharing (transfers serialize into each
    # other's idle windows — Atlas §4.2 across jobs), while the naive
    # always-fair-share strawman halves both jobs' rates anyway.  Then
    # the cascade: an unplanned outage pushes job A's re-plan onto the
    # pair job B crosses; B's drift detector fires on the *contention*
    # (not the outage — B never crossed the degraded pair) and B
    # re-plans away, bounded by the fleet's convergence guard.
    print("\nMulti-job fleet on one WAN (contention-priced channels):")
    from repro_torch.core import fleet as fl

    duo = topology.TopologyMatrix.from_latency(
        [[0.0, 20.0], [20.0, 0.0]], multi_tcp=True, dc_names=("east", "west"))
    job_fit = dataclasses.replace(
        job3, act_bytes=2e7, partition_param_bytes=2e8, microbatches=24)
    mk = lambda n: fl.FleetJob(  # noqa: E731
        n, job_fit, {"east": 2, "west": 2}, P=4, n_iterations=32, C=1)
    tmp = fl.simulate_fleet([mk("jobA"), mk("jobB")], duo, validate=True)
    fair = fl.simulate_fleet([mk("jobA"), mk("jobB")], duo,
                             config=fl.FleetConfig(sharing="fair"),
                             validate=True)
    print(f"  two jobs, one east<->west pair, demands fit together:")
    print(f"    temporal sharing : {tmp.total_ms/1e3:7.1f}s "
          f"(throttled iterations: "
          f"{sum(v['throttled_iterations'] for v in tmp.stats['per_job'].values())})")
    print(f"    naive fair-share : {fair.total_ms/1e3:7.1f}s "
          f"(every overlapping window pinned to half rate)")
    print(f"    contention-aware sharing saves "
          f"{(fair.total_ms - tmp.total_ms)/1e3:.1f}s end-to-end")

    quad = topology.TopologyMatrix.from_latency(
        [[0.0 if i == j else 20.0 for j in range(4)] for i in range(4)],
        multi_tcp=True, dc_names=("a", "b", "c", "d"))
    bwq = quad.link(0, 1).bw_gbps
    live_q = quad.with_bandwidth_schedules({
        (0, 1): wan.BandwidthSchedule.outage(bwq, 20_000.0, 1e9, bwq / 10.0)})
    job_cs = dataclasses.replace(job_fit, act_bytes=1.2e8)
    tracer = None
    if trace_path is not None:
        from repro_torch import obs
        tracer = obs.RecordingTracer()
    frc = fl.simulate_fleet(
        [fl.FleetJob("A", job_cs, {"a": 2, "b": 2, "c": 2}, P=6,
                     n_iterations=60, C=1, planned_topo=quad,
                     control=control.ControlConfig()),
         fl.FleetJob("B", job_cs, {"a": 2, "c": 2, "d": 2}, P=6,
                     n_iterations=60, C=1, planned_topo=quad,
                     control=control.ControlConfig())],
        live_q, validate=True, tracer=tracer)
    if tracer is not None:
        from repro_torch.core.validate import check_trace
        n_windows = check_trace(tracer)  # second witness before export
        obs.write_chrome_trace(tracer, trace_path, label="whatif-cascade")
        print(f"  [trace] {tracer.n_events} events ({n_windows} iteration "
              f"windows crosschecked) -> {trace_path}  "
              f"(open in https://ui.perfetto.dev)")
    print(f"  cascade under an unplanned a->b outage "
          f"(per-channel invariant checked):")
    for nm in ("A", "B"):
        hr = frc.jobs[nm]
        routes = [">".join(quad.dc_names[d] for d in dict.fromkeys(e.spec.stage_dc))
                  for e in hr.epochs]
        pj = frc.stats["per_job"][nm]
        print(f"    job {nm}: {' -> '.join(routes)}  "
              f"({hr.replans} re-plan(s), "
              f"{pj['throttled_iterations']} contended iteration(s))")
    print(f"    B never crossed the degraded pair — its re-plan was "
          f"triggered by A's migration landing on B's channel")

    # prefill-as-a-service on the fleet: sell the training
    # bubbles to production inference traffic (paper §5, Fig 13) — at
    # fleet scale.  Host job A spans a,b,c; contender B squeezes the
    # a<->b channel; decode GPUs live in c, so a prefill placed on an
    # a/b pipeline must ship its KV cache over the *same contended WAN*
    # the training jobs transfer activations on (priced into TTFT before
    # the per-tier SLO gate; reservations land in the fleet ledger under
    # the "~prefill" pseudo-job and are invariant-checked).  The closed
    # loop: B's contention stretches A's iterations -> more bubble
    # supply -> monetized utilization under contention *exceeds* the
    # uncontended ceiling at the same offered load.
    print("\nBubbleTea at fleet scale (prefills ride contended bubbles):")
    from repro_torch.core.bubbletea import (ArrivalProcess, InferenceModelSpec,
                                      PromptMix)

    tri_bt = topology.TopologyMatrix.from_latency(
        [[0.0 if i == j else 20.0 for j in range(3)] for i in range(3)],
        multi_tcp=True, dc_names=("a", "b", "c"))
    job_bt = dataclasses.replace(
        job_fit, t_fwd_ms=10.0, act_bytes=6e7)  # a,b channel demand > fits
    arr = ArrivalProcess(rate_per_s=25.0, horizon_ms=60_000.0, seed=7,
                         diurnal_amplitude=0.3, diurnal_period_ms=30_000.0,
                         burst_rate_mult=4.0, mean_on_ms=1_000.0,
                         mean_off_ms=4_000.0)
    reqs = arr.generate(PromptMix(lengths=(512, 1024, 2048),
                                  weights=(0.25, 0.65, 0.10)),
                        tiers={"gold": 0.3, "best_effort": 0.7})
    svc = fl.PrefillService(
        host_job="A", arrivals=reqs,
        model=InferenceModelSpec("llama3-8b", num_params=8e9,
                                 kv_bytes_per_token=16384.0),
        decode_dc="c", tiers={"gold": 1_200.0, "best_effort": 8_000.0})
    hostA = lambda: fl.FleetJob("A", job_bt, {"a": 2, "b": 2, "c": 2},  # noqa: E731
                                P=6, n_iterations=8, C=1)
    contB = fl.FleetJob("B", job_bt, {"a": 2, "b": 2}, P=4,
                        n_iterations=8, C=1)
    print(f"  {len(reqs)} seeded arrivals (diurnal + bursty), "
          f"gold TTFT<=1.2s / best-effort<=8s, decode in c:")
    for tag, jobs in (("A solo (uncontended)", [hostA()]),
                      ("A + B  (contended)  ", [hostA(), contB])):
        p = fl.simulate_fleet(jobs, tri_bt, prefill=svc,
                              validate=True).stats["prefill"]
        tiers = "  ".join(
            f"{t}: {v['acceptance']:.0%} (p99 {v['ttft_p99_ms']/1e3:.1f}s)"
            for t, v in p["per_tier"].items())
        print(f"    {tag}: train-only {p['utilization_train']:.0%} -> "
              f"with prefills {p['utilization_with_prefills']:.0%}  "
              f"[kv over WAN: {p['kv_wan_transfers']}]")
        print(f"        per-tier acceptance: {tiers}")
    print("    contention grew bubble supply: monetized utilization is "
          "higher in the contended run")

    # failure & elasticity: a DC dies mid-horizon with no
    # warning.  Three recovery stances at *fixed* sample count: do
    # nothing (every transfer through the dead DC limps at residual
    # bandwidth), re-plan around it and ship the live weights off the
    # corpse over the degraded WAN, or restore the surviving placement
    # from the nearest async checkpoint and re-earn the samples written
    # since ("replay") — the control plane prices both and takes the
    # cheaper, and validate proves no GPU busy time nor channel
    # reservation ever touches the dead DC inside its outage window.
    print("\nFailure & elasticity (mid-horizon DC loss, checkpoint-aware):")
    from repro_torch.core.failures import (CheckpointPolicy, FailureEvent,
                                     FailureTrace)
    from repro_torch.core.validate import check_horizon

    quad_f = topology.TopologyMatrix.from_latency(
        [[0.0, 30.0, 60.0, 150.0], [30.0, 0.0, 40.0, 170.0],
         [60.0, 40.0, 0.0, 120.0], [150.0, 170.0, 120.0, 0.0]],
        multi_tcp=True, dc_names=("use", "ussc", "usw", "asia"))
    trace = FailureTrace(events=(
        FailureEvent(at_ms=60_000.0, kind="dc_outage", dc="ussc",
                     residual_frac=0.02),))
    ckp = CheckpointPolicy(interval_ms=20_000.0, placement=("use", "usw"),
                           write_bw_gbps=2.0)
    job_f = JobModel(t_fwd_ms=10.0, act_bytes=1e7,
                     partition_param_bytes=4e8, microbatches=64)
    fleet_f = {n: 8 for n in quad_f.dc_names}
    kw_f = dict(P=12, live_topo=quad_f, planned_topo=quad_f,
                n_iterations=64, C=2)
    static_f = control.simulate_horizon(
        job_f, fleet_f, P=12, live_topo=trace.apply_to_topology(quad_f),
        planned_topo=quad_f, n_iterations=64, C=2)
    ship_f = control.simulate_horizon(
        job_f, fleet_f, control=control.ControlConfig(), failures=trace,
        **kw_f)
    ckpt_f = control.simulate_horizon(
        job_f, fleet_f, control=control.ControlConfig(), failures=trace,
        migration=control.MigrationModel(checkpoint=ckp), **kw_f)
    check_horizon(ship_f, live_topo=trace.apply_to_topology(quad_f))
    check_horizon(ckpt_f, live_topo=trace.apply_to_topology(quad_f))
    print(f"  ussc dies at t=60s (residual 2%), {static_f.samples:.0f} "
          f"samples either way:")
    print(f"    static (no reaction)   : {static_f.total_ms/1e3:7.1f}s")
    m_ship = ship_f.migrations[0]
    print(f"    ship live weights      : {ship_f.total_ms/1e3:7.1f}s  "
          f"(stall {m_ship.duration_ms/1e3:.1f}s hauling state off the "
          f"dead DC)")
    m_ck = next(m for m in ckpt_f.migrations if m.mode == "restore")
    print(f"    checkpoint restore     : {ckpt_f.total_ms/1e3:7.1f}s  "
          f"(stall {m_ck.duration_ms/1e3:.1f}s, replay "
          f"{m_ck.replay_samples:.0f} samples since the last landed "
          f"async write)")
    print(f"    both reacting arms re-ran Algorithm 1 with the dead DC "
          f"excluded ({m_ck.reason}); invariants checked")

    # elastic join: a preempted spot slice comes *back* — opportunistic
    # re-plan (never forced), taken only if the projected gain clears
    # the migration + hysteresis bar
    join = FailureTrace(events=(
        FailureEvent(at_ms=60_000.0, kind="dc_outage", dc="ussc",
                     recover_ms=120_000.0, residual_frac=0.02),))
    heal_f = control.simulate_horizon(
        job_f, fleet_f, control=control.ControlConfig(), failures=join,
        migration=control.MigrationModel(checkpoint=ckp), **kw_f)
    kinds = [m.reason for m in heal_f.migrations]
    print(f"  same outage healing at t=180s: {heal_f.total_ms/1e3:.1f}s, "
          f"re-plan trail: {kinds if kinds else 'none'}")

    # Fig 12-style sweep
    print("\nFig 12 sweep (dc1=600 fixed, dc2 grows):")
    base = best_plan(algorithm1(job, {"dc1": 600}, P=80)).throughput
    for F in range(0, 11, 2):
        b = best_plan(algorithm1(job, {"dc1": 600, "dc2": 60 * F}, P=80))
        used2 = b.partitions.get("dc2", 0)
        print(f"  F={F*10:3d}%  gain={b.throughput/base:5.2f}x  "
              f"D={b.D}  dc2_partitions={used2}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="record the fleet cascade scenario and export "
                         "Chrome trace-event JSON (Perfetto-loadable)")
    main(trace_path=ap.parse_args().trace)
