"""Algorithm 1 — DC selection and what-if performance/cost modeling (§4.5).

Given per-DC GPU availability, the comm/compute ratio C and the partition
count P, sweep the number of DP-cells D, greedily pack PP partitions into
DCs (in the given DC order — cost, distance, or availability), and report
``total_time[D] = PP_time + all_reduce_time``.  Users pick D by
throughput = D·C / total_time[D] (paper §4.5), or run exhaustive what-if
sweeps over DC sets without any deployment.

``get_latency_pp`` uses the closed-form pipeline model validated against
the event simulator (see tests/test_dc_selection.py):
    PP_time = fill + (M−1)·slot + drain
    slot    = max(GPU work per microbatch, WAN channel time per microbatch)
with temporal sharing shrinking the per-transfer time by the cell's DP
factor (C) on the fill/drain paths.  Evaluations are memoized — what-if
sweeps and the D loop revisit the same (partitions, order) points.

Placement-order search: with a heterogeneous *named* topology the DC
order matters (slow pairs must stay off the stage boundaries).  The
original search enumerated every permutation (O(n!), capped at 6 DCs);
the default is now branch-and-bound over partial orders — a partial
placement's cost is lower-bounded by the cheapest boundary links that
could still be appended, the slot term by the boundaries already placed
— which prunes permutations sharing a dominated prefix and lifts the
cap to 12 DCs (8 named DCs search in well under a second).  The
exhaustive search is kept behind ``order_search="exhaustive"`` as the
differential-testing reference: both must return the same best plan.

The port's own copy of ``repro/core/dc_selection.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import units
from repro_torch.core import wan
from repro_torch.core.topology import TopologyMatrix

MAX_SEARCH_DCS = 12  # branch-and-bound order search
MAX_EXHAUSTIVE_DCS = 8  # reference O(n!) search (tests only, realistically)
AUTO_SEARCH_DCS = 10  # auto-enable threshold for named topologies


@dataclasses.dataclass(frozen=True)
class JobModel:
    """Workload constants feeding Algorithm 1.

    ``topology`` (optional) switches the model from a uniform WAN to a
    per-DC-pair ``TopologyMatrix``: every pipeline boundary then pays its
    *own* link's serialization + latency, and Algorithm 1 searches DC
    *orders* so the slow pairs stay off the stage boundaries.  DC names
    resolve to matrix indices via ``topology.dc_names`` when present,
    otherwise by position in the order under evaluation.
    """

    t_fwd_ms: float  # forward time per partition per microbatch
    act_bytes: float  # activation/gradient bytes per boundary
    partition_param_bytes: float  # parameter bytes per partition
    microbatches: int
    recompute: bool = True
    bwd_mult: float = 2.0
    wan_latency_ms: float = 40.0
    multi_tcp: bool = True
    intra_bw_gbps: float = wan.INTRA_DC_GBPS
    topology: Optional[TopologyMatrix] = None

    def pair_link(self, idx_a: int, idx_b: int) -> wan.Link:
        if self.topology is not None:
            return self.topology.link(idx_a, idx_b)
        if idx_a == idx_b:
            return wan.Link(wan.INTRA_DC_LATENCY_MS, self.intra_bw_gbps)
        return wan.wan_link(self.wan_latency_ms, self.multi_tcp)

    def pair_bw_gbps(self, idx_a: int, idx_b: int) -> float:
        """Planning-time bandwidth of the *directed* pair: the worst
        segment of its time-varying schedule when one is attached, else
        the static link rate.  Algorithm 1 prices every boundary by what
        the direction can guarantee across the whole iteration — this is
        what makes placements bandwidth-asymmetric (a link degraded in
        one direction repels only the schedules that would cross it that
        way), not merely latency-aware."""
        if self.topology is not None:
            return self.topology.effective_bw_gbps(idx_a, idx_b)
        return self.pair_link(idx_a, idx_b).bw_gbps

    @property
    def comm_compute_ratio(self) -> float:
        """C — WAN serialization time of one boundary transfer over t_fwd.

        Heterogeneous topologies size C from the *best* WAN pair (by
        worst-segment bandwidth when schedules are attached): the
        placement-order search keeps the slow pairs off the stage
        boundaries, so the best link is what a cell actually crosses —
        sizing from the bottleneck would inflate C until no DC can hold
        a partition (every plan infeasible) on exactly the skewed WANs
        the search handles."""
        if self.topology is not None and self.topology.n_dcs > 1:
            bw = max(
                self.topology.effective_bw_gbps(a, b)
                for a, b in self.topology.wan_pairs()
            )
        else:
            bw = (
                wan.NODE_PAIR_CAP_GBPS
                if self.multi_tcp
                else wan.tcp_single_bw_gbps(self.wan_latency_ms)
            )
        ser_ms = units.serialization_ms(self.act_bytes, bw)
        return ser_ms / self.t_fwd_ms


@dataclasses.dataclass
class PlanEntry:
    D: int
    partitions: Dict[str, int]
    pp_time_ms: float
    allreduce_ms: float
    total_ms: float
    throughput: float  # pipelines·microbatches / ms  (relative units)
    gpus_used: int
    dc_order: Tuple[str, ...] = ()  # placement order the stages follow


def _stage_dc_from_partitions(partitions: Dict[str, int], dc_order: Sequence[str]) -> List[int]:
    stage_dc: List[int] = []
    for i, dc in enumerate(dc_order):
        stage_dc.extend([i] * partitions.get(dc, 0))
    return stage_dc


# --------------------------------------------------------------------------
# closed-form pipeline latency (memoized)
# --------------------------------------------------------------------------

_PP_MEMO: Dict[Tuple, float] = {}
_PP_MEMO_MAX = 200_000
# structural job fingerprints, cached per live JobModel object (the weakref
# identity check guards against id() reuse after garbage collection; the
# JobModel itself is unhashable whenever its topology carries a link dict)
_JOB_KEY_CACHE: Dict[int, Tuple[object, Tuple]] = {}
_JOB_KEY_CACHE_MAX = 4096


def _job_memo_key(job: JobModel) -> Tuple:
    import weakref

    hit = _JOB_KEY_CACHE.get(id(job))
    if hit is not None and hit[0]() is job:
        return hit[1]
    topo = job.topology
    tkey: Optional[Tuple] = None
    if topo is not None:
        tkey = (
            topo.n_dcs,
            tuple(sorted(topo.links.items())),
            # schedules change planning-time bandwidth: topologies that
            # differ only in bw_schedules must not share memo entries
            tuple(sorted(topo.bw_schedules.items())),
            topo.intra_bw_gbps,
            topo.intra_latency_ms,
            topo.default_latency_ms,
            topo.multi_tcp,
            topo.dc_names,
        )
    key = (
        job.t_fwd_ms,
        job.act_bytes,
        job.microbatches,
        job.recompute,
        job.bwd_mult,
        job.wan_latency_ms,
        job.multi_tcp,
        job.intra_bw_gbps,
        tkey,
    )
    if len(_JOB_KEY_CACHE) >= _JOB_KEY_CACHE_MAX:
        _JOB_KEY_CACHE.clear()
    _JOB_KEY_CACHE[id(job)] = (weakref.ref(job), key)
    return key


def get_latency_pp(
    job: JobModel,
    partitions: Dict[str, int],
    dc_order: Sequence[str],
    dp_per_cell: int,
) -> float:
    """Closed-form pipeline latency with temporal bandwidth sharing.

    Heterogeneity-aware: each WAN boundary pays its *own* link's
    serialization and propagation latency, and the steady-state slot is
    set by the slowest boundary (every microbatch must traverse every
    boundary; channels are independent, so the pipeline's rate is the
    bottleneck channel's).  Results are memoized per (job, partitions,
    order, cell): the order search and what-if sweeps re-evaluate the
    same placements many times."""
    key = (
        _job_memo_key(job),
        tuple(sorted(partitions.items())),
        tuple(dc_order),
        dp_per_cell,
    )
    hit = _PP_MEMO.get(key)
    if hit is not None:
        return hit
    val = _latency_pp_impl(job, partitions, dc_order, dp_per_cell)
    if len(_PP_MEMO) >= _PP_MEMO_MAX:
        _PP_MEMO.clear()
    _PP_MEMO[key] = val
    return val


def _pair_terms(
    job: JobModel, idx_a: int, idx_b: int, D: int, hop: float
) -> Tuple[float, float, float]:
    """(fill term, drain term, channel occupancy) of one WAN boundary
    a -> b: activations ride the forward link, gradients the reverse one,
    the scatter/gather hops stream with the WAN send.  Each direction is
    priced at its own *worst-segment* bandwidth (``pair_bw_gbps``) when a
    time-varying schedule is attached — placements must survive the
    slowest hour, and the two directions may degrade independently.  The
    single pricing point shared by the closed form and the
    branch-and-bound search — change the model here and both stay in
    lock-step."""
    fwd = job.pair_link(idx_a, idx_b)
    rev = job.pair_link(idx_b, idx_a)
    ser_f = units.serialization_ms(job.act_bytes, job.pair_bw_gbps(idx_a, idx_b))
    ser_r = units.serialization_ms(job.act_bytes, job.pair_bw_gbps(idx_b, idx_a))
    fill = ser_f / D + 2.0 * hop + fwd.latency_ms
    drain = ser_r / D + 2.0 * hop + rev.latency_ms
    return fill, drain, max(ser_f, ser_r)


def _latency_pp_impl(
    job: JobModel,
    partitions: Dict[str, int],
    dc_order: Sequence[str],
    dp_per_cell: int,
) -> float:
    stage_dc = _stage_dc_from_partitions(partitions, dc_order)
    P = len(stage_dc)
    if P == 0:
        return math.inf
    M = job.microbatches
    t_f = job.t_fwd_ms
    t_b = job.bwd_mult * t_f
    t_r = t_f if job.recompute else 0.0
    D = max(1, dp_per_cell)

    # map a position in dc_order to a topology DC index: by name when the
    # matrix carries names (unknown names are an error — a silent
    # positional fallback would price the wrong link), by position in the
    # given order otherwise
    if job.topology is not None and job.topology.dc_names:
        idx = [job.topology.index_of(dc) for dc in dc_order]
    else:
        idx = list(range(len(dc_order)))

    intra_bw = (
        job.topology.intra_bw_gbps if job.topology is not None else job.intra_bw_gbps
    )
    hop = units.serialization_ms(job.act_bytes * (D - 1) / D, intra_bw)
    intra_ms = units.serialization_ms(job.act_bytes, intra_bw)

    # temporal sharing: channel occupancy ser/D; scatter/gather hops stream
    # with the WAN send and only add delivery delay (see _pair_terms)
    wan_fill_ms = 0.0  # per-boundary fill terms (activation direction)
    wan_drain_ms = 0.0  # per-boundary drain terms (gradient direction)
    max_ser = 0.0  # slowest channel's per-microbatch occupancy
    n_intra = 0
    for a, b in zip(stage_dc, stage_dc[1:]):
        if a == b:
            n_intra += 1
            continue
        fill, drain, ser = _pair_terms(job, idx[a], idx[b], D, hop)
        wan_fill_ms += fill
        wan_drain_ms += drain
        max_ser = max(max_ser, ser)

    # steady-state slot: per-microbatch GPU work vs per-microbatch WAN
    # channel occupancy of the bottleneck boundary (the cell's channel
    # carries D transfers of ser/D each per microbatch index => ser)
    slot = max(t_f + t_r + t_b, max_ser)
    fill = P * t_f + wan_fill_ms + n_intra * intra_ms
    drain = P * (t_r + t_b) + wan_drain_ms + n_intra * intra_ms
    return fill + (M - 1) * slot + drain


def get_latency_dp(job: JobModel, n_replicas: int) -> float:
    """All-reduce across the DP replicas of one layer — intra-DC ring
    (§4.2: replicas of a layer always live in the same DC)."""
    return wan.allreduce_ms(job.partition_param_bytes, n_replicas, job.intra_bw_gbps)


def _pack_partitions(
    num_gpu: Dict[str, int], order: Sequence[str], P: int, gpus_per_partition: int
) -> Tuple[Dict[str, int], int]:
    part_left = P
    partitions: Dict[str, int] = {}
    for dc in order:
        pp_gpu = num_gpu[dc] // gpus_per_partition
        assigned = min(part_left, pp_gpu)
        partitions[dc] = assigned
        part_left -= assigned
        if part_left == 0:
            break
    return partitions, part_left


# --------------------------------------------------------------------------
# placement-order search: branch-and-bound over partial orders
# --------------------------------------------------------------------------


def _bnb_best_order(
    job: JobModel,
    num_gpu: Dict[str, int],
    P: int,
    dc_order: Sequence[str],
    cell: int,
    gpus_per_partition: int,
    incumbent: Optional[Sequence[str]] = None,
) -> Optional[Tuple[str, ...]]:
    """Best placement order for one D (None = infeasible for this D).

    Search over *used-DC prefixes* only: once P partitions are packed the
    relative order of the remaining DCs is irrelevant (they hold no
    stage), and zero-capacity DCs never hold a stage — two symmetry
    classes the exhaustive permutation scan re-visits factorially often.
    A partial order is cut when a lower bound on its completion — the
    boundary terms already placed, plus the fewest possible future WAN
    boundaries priced at the cheapest remaining link, plus the (M−1)·slot
    term of the boundaries placed so far — cannot beat the incumbent.
    Children are expanded in ``dc_order`` sequence and the incumbent only
    replaced on strict improvement, so ties resolve to the same
    (lexicographically first) order the exhaustive reference returns.

    ``incumbent`` warm-starts the search with a known-good order (the
    control plane's currently-deployed placement): its cost becomes the
    initial bound, so partial orders dominated by the deployed plan are
    pruned immediately, and — because replacement requires *strict*
    improvement — a tie returns the incumbent itself, keeping the
    re-planner from proposing a cost-equal migration."""
    topo = job.topology
    assert topo is not None and topo.dc_names, "order search needs a named topology"
    caps = {dc: num_gpu.get(dc, 0) // gpus_per_partition for dc in dc_order}
    usable = [dc for dc in dc_order if caps[dc] > 0]
    if sum(caps[dc] for dc in usable) < P:
        return None

    M = job.microbatches
    t_f = job.t_fwd_ms
    t_b = job.bwd_mult * t_f
    t_r = t_f if job.recompute else 0.0
    D = max(1, cell)
    comp_slot = t_f + t_r + t_b
    const = P * t_f + P * (t_r + t_b)
    intra_bw = topo.intra_bw_gbps
    hop = units.serialization_ms(job.act_bytes * (D - 1) / D, intra_bw)
    intra_cost = 2.0 * units.serialization_ms(job.act_bytes, intra_bw)  # fill+drain

    idx = {dc: topo.index_of(dc) for dc in usable}
    pair_cost: Dict[Tuple[str, str], float] = {}
    pair_ser: Dict[Tuple[str, str], float] = {}
    for a in usable:
        for b in usable:
            if a == b:
                continue
            fill, drain, ser = _pair_terms(job, idx[a], idx[b], D, hop)
            pair_cost[(a, b)] = fill + drain
            pair_ser[(a, b)] = ser
    cheapest_pair = min(pair_cost.values()) if pair_cost else 0.0

    best_cost = math.inf
    best_order: Optional[Tuple[str, ...]] = None

    if incumbent is not None:
        # evaluate the deployed order through the same packing/cost walk
        # the dfs uses; an infeasible incumbent (fleet shrank) seeds nothing
        prefix: List[str] = []
        placed = 0
        acc = acc_ser = 0.0
        for dc in incumbent:
            if placed >= P:
                break
            if dc not in idx or dc in prefix:
                continue
            k = min(caps[dc], P - placed)
            acc += (k - 1) * intra_cost
            if prefix:
                acc += pair_cost[(prefix[-1], dc)]
                acc_ser = max(acc_ser, pair_ser[(prefix[-1], dc)])
            prefix.append(dc)
            placed += k
        if placed >= P:
            best_cost = const + acc + (M - 1) * max(comp_slot, acc_ser)
            best_order = tuple(prefix)

    def boundary_lb(left: int, remaining: List[str]) -> float:
        """Cheapest possible cost of the `left` boundaries still to come:
        at least `fewest DCs that can hold them` WAN hops, the rest
        intra-DC."""
        if left <= 0:
            return 0.0
        rem_caps = sorted((caps[dc] for dc in remaining), reverse=True)
        need, n_more = left, 0
        for c in rem_caps:
            if need <= 0:
                break
            need -= c
            n_more += 1
        if cheapest_pair >= intra_cost:
            return n_more * cheapest_pair + (left - n_more) * intra_cost
        return left * min(cheapest_pair, intra_cost)

    def dfs(order: List[str], used: set, placed: int, acc: float, acc_ser: float):
        nonlocal best_cost, best_order
        # ties (within float noise, relative) keep the earlier — i.e.
        # lexicographically-first — order, matching the exhaustive scan
        if placed >= P:
            total = const + acc + (M - 1) * max(comp_slot, acc_ser)
            if best_order is None or total < best_cost - 1e-9 * (1.0 + best_cost):
                best_cost = total
                best_order = tuple(order)
            return
        left = P - placed
        remaining = [dc for dc in usable if dc not in used]
        if sum(caps[dc] for dc in remaining) < left:
            return
        if best_order is not None:
            lb = const + acc + boundary_lb(left, remaining) \
                + (M - 1) * max(comp_slot, acc_ser)
            if lb >= best_cost - 1e-9 * (1.0 + best_cost):
                return
        last = order[-1] if order else None
        for dc in remaining:
            k = min(caps[dc], left)
            step = (k - 1) * intra_cost
            ser = acc_ser
            if last is not None:
                step += pair_cost[(last, dc)]
                ser = max(ser, pair_ser[(last, dc)])
            order.append(dc)
            used.add(dc)
            dfs(order, used, placed + k, acc + step, ser)
            order.pop()
            used.remove(dc)

    dfs([], set(), 0, 0.0, 0.0)
    if best_order is None:
        return None
    rest = [dc for dc in dc_order if dc not in best_order]
    return best_order + tuple(rest)


# --------------------------------------------------------------------------
# Algorithm 1
# --------------------------------------------------------------------------


def algorithm1(
    job: JobModel,
    num_gpu: Dict[str, int],
    P: int,
    *,
    C: Optional[int] = None,
    D_max: Optional[int] = None,
    dc_order: Optional[Sequence[str]] = None,
    search_orders: Optional[bool] = None,
    order_search: str = "bnb",
    incumbent_order: Optional[Sequence[str]] = None,
    exclude_dcs: Optional[Sequence[str]] = None,
) -> List[PlanEntry]:
    """Paper Algorithm 1. Returns one PlanEntry per DP-cell count D.

    With a heterogeneous *named* ``job.topology`` every DC *placement
    order* is evaluated per D and the fastest wins — on a skewed WAN the
    slow pair must not become a stage boundary, which a fixed
    availability-sorted order cannot guarantee.  The search needs DC
    names on the matrix (fleet keys must resolve to fixed topology
    sites; permuting a positional mapping would re-site the fleet).
    ``order_search`` picks the engine: "bnb" (default) prunes partial
    orders with admissible lower bounds and handles up to 12 DCs;
    "exhaustive" enumerates permutations (the differential-testing
    reference, ≤ 8 DCs) — both return the same best plan.

    ``incumbent_order`` (bnb only) warm-starts every per-D search with
    the currently-deployed placement: the re-planner
    (``repro_torch.core.control``) passes the live plan's order so the search
    starts from a tight bound and ties resolve to "stay put".

    ``exclude_dcs`` plans over the *surviving* set: the named DCs are
    removed from the fleet (and from any explicit ``dc_order``) before
    anything is packed — the forced-failover path of the control plane
    (``repro_torch.core.failures``) re-runs Algorithm 1 with the dead DC
    excluded rather than trusting degraded link pricing to route a
    placement off GPUs that no longer exist.  ``D_max`` (when left
    automatic) and the availability order follow the surviving fleet.
    """
    if order_search not in ("bnb", "exhaustive"):
        raise ValueError(f"unknown order_search {order_search!r}")
    if exclude_dcs:
        dead = set(exclude_dcs)
        num_gpu = {dc: g for dc, g in num_gpu.items() if dc not in dead}
        if not num_gpu:
            raise ValueError(f"exclude_dcs={sorted(dead)} leaves no fleet")
        if dc_order is not None:
            dc_order = [dc for dc in dc_order if dc not in dead]
        if incumbent_order is not None:
            incumbent_order = [dc for dc in incumbent_order if dc not in dead]
    explicit_order = dc_order is not None
    if dc_order is None:  # default: decreasing GPU availability (§4.5)
        dc_order = sorted(num_gpu, key=lambda d: -num_gpu[d])
    if C is None:
        C = max(1, round(job.comm_compute_ratio))
    total_gpus = sum(num_gpu.values())
    if D_max is None:
        D_max = max(1, total_gpus // (C * P))
    named = (
        job.topology is not None
        and job.topology.dc_names
        and all(dc in job.topology.dc_names for dc in dc_order)
    )
    if search_orders is None:
        # an explicitly supplied order (cost, distance, ... — §4.5) is a
        # caller decision; only auto-search the default availability order
        search_orders = (
            bool(named) and not explicit_order and len(dc_order) <= AUTO_SEARCH_DCS
        )
    if search_orders:
        if not named:
            raise ValueError(
                "search_orders needs a topology with dc_names covering every "
                "fleet DC (a positional mapping cannot be permuted)"
            )
        cap_dcs = MAX_SEARCH_DCS if order_search == "bnb" else MAX_EXHAUSTIVE_DCS
        if len(dc_order) > cap_dcs:
            raise ValueError(
                f"{order_search} order search is capped at {cap_dcs} DCs "
                f"(got {len(dc_order)}); pass an explicit dc_order instead"
            )

    orders: Optional[List[Tuple[str, ...]]] = None
    if not (search_orders and order_search == "bnb"):
        if search_orders:
            orders = [tuple(o) for o in itertools.permutations(dc_order)]
        else:
            orders = [tuple(dc_order)]
    plans: List[PlanEntry] = []
    for D in range(1, D_max + 1):
        if orders is None:
            best = _plan_for_order_bnb(job, num_gpu, P, C, D, dc_order,
                                       incumbent=incumbent_order)
        else:
            best = None
            for order in orders:
                entry = _plan_entry(job, num_gpu, P, C, D, order)
                if best is None or entry.total_ms < best.total_ms:
                    best = entry
        plans.append(best)
    return plans


def _plan_entry(
    job: JobModel,
    num_gpu: Dict[str, int],
    P: int,
    C: int,
    D: int,
    order: Tuple[str, ...],
) -> PlanEntry:
    partitions, part_left = _pack_partitions(num_gpu, order, P, D * C)
    if part_left > 0:
        pp_time = math.inf
        ar = 0.0
    else:
        pp_time = get_latency_pp(job, partitions, order, C)
        ar = get_latency_dp(job, D * C)
    total = pp_time + ar
    thr = (D * C * job.microbatches) / total if math.isfinite(total) else 0.0
    return PlanEntry(
        D=D,
        partitions=dict(partitions),
        pp_time_ms=pp_time,
        allreduce_ms=ar,
        total_ms=total,
        throughput=thr,
        gpus_used=D * C * sum(partitions.values()),
        dc_order=order,
    )


def _plan_for_order_bnb(
    job: JobModel,
    num_gpu: Dict[str, int],
    P: int,
    C: int,
    D: int,
    dc_order: Sequence[str],
    incumbent: Optional[Sequence[str]] = None,
) -> PlanEntry:
    order = _bnb_best_order(job, num_gpu, P, dc_order, C, D * C,
                            incumbent=incumbent)
    if order is None:  # infeasible: report the input order, like exhaustive
        return _plan_entry(job, num_gpu, P, C, D, tuple(dc_order))
    return _plan_entry(job, num_gpu, P, C, D, order)


def best_plan(plans: List[PlanEntry]) -> PlanEntry:
    return max(plans, key=lambda p: p.throughput)


def what_if(
    job: JobModel,
    scenarios: Dict[str, Dict[str, int]],
    P: int,
    *,
    C: Optional[int] = None,
    gpu_cost_per_hour: float = 2.0,
) -> Dict[str, Dict]:
    """Cost/performance what-if sweep across candidate DC sets (§4.5):
    for each scenario, the best plan, its throughput, and the $/iteration
    estimate — all without any deployment."""
    out: Dict[str, Dict] = {}
    for name, gpus in scenarios.items():
        plans = algorithm1(job, gpus, P, C=C)
        best = best_plan(plans)
        iter_hours = best.total_ms / 3.6e6
        out[name] = {
            "best_D": best.D,
            "throughput": best.throughput,
            "total_ms": best.total_ms,
            "gpus_used": best.gpus_used,
            "cost_per_iteration": best.gpus_used * gpu_cost_per_hour * iter_hours,
            "partitions": best.partitions,
        }
    return out
