"""Heterogeneous WAN topologies — per-DC-pair latency/bandwidth matrices.

The paper's testbed (§6.1) and every real multi-DC WAN have a *different*
latency/bandwidth for every DC pair (Fig 5: 2 ms us-east↔us-east vs 95 ms
us-east↔se-asia), while the original ``GeoTopology`` modelled a single
uniform ``wan_latency_ms``/``multi_tcp`` for all pairs.  ``TopologyMatrix``
generalizes it: an explicit per-pair ``wan.Link`` table (asymmetric pairs
allowed), with the same ``link(dc_a, dc_b)`` / ``intra_bw_gbps`` interface
the simulator, the Atlas scheduler (``repro_torch.core.temporal``) and Algorithm
1 (``repro_torch.core.dc_selection``) consume — so a ``TopologyMatrix`` drops in
anywhere a ``GeoTopology`` was accepted.

Presets model the paper's Azure testbed plus synthetic skewed/star/chain
WANs used by the scheduler tests and benchmarks.

The port's own copy of ``repro/core/topology.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core import wan

Pair = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class TopologyMatrix:
    """Per-DC-pair WAN model.

    ``links`` maps a directed ``(src, dst)`` DC pair to its ``wan.Link``;
    a missing ``(a, b)`` falls back to ``(b, a)`` (symmetric networks need
    only one triangle), and pairs absent from both directions use the
    uniform default built from ``default_latency_ms``/``multi_tcp``.

    ``bw_schedules`` optionally attaches a time-varying
    ``wan.BandwidthSchedule`` to a directed WAN pair (same reverse-pair
    fallback as ``links``; asymmetric conditions need both directions).
    A pair without a schedule keeps its static ``Link.bw_gbps`` forever —
    ``bandwidth_schedule`` then returns ``None`` so engines can keep the
    memoized constant-transfer fast path.
    """

    n_dcs: int
    links: Mapping[Pair, wan.Link] = dataclasses.field(default_factory=dict)
    intra_bw_gbps: float = wan.INTRA_DC_GBPS
    intra_latency_ms: float = wan.INTRA_DC_LATENCY_MS
    default_latency_ms: float = 40.0
    multi_tcp: bool = True
    dc_names: Tuple[str, ...] = ()
    name: str = ""
    bw_schedules: Mapping[Pair, wan.BandwidthSchedule] = dataclasses.field(
        default_factory=dict
    )

    def __post_init__(self):
        assert self.n_dcs >= 1
        for (a, b), l in self.links.items():
            assert 0 <= a < self.n_dcs and 0 <= b < self.n_dcs and a != b, (a, b)
            assert l.bw_gbps > 0 and l.latency_ms >= 0, l
        for (a, b), sched in self.bw_schedules.items():
            assert 0 <= a < self.n_dcs and 0 <= b < self.n_dcs and a != b, (a, b)
            assert isinstance(sched, wan.BandwidthSchedule), sched
        if self.dc_names:
            assert len(self.dc_names) == self.n_dcs

    # --- the interface the simulator/scheduler consume -------------------
    def link(self, dc_a: int, dc_b: int) -> wan.Link:
        if not (0 <= dc_a < self.n_dcs and 0 <= dc_b < self.n_dcs):
            raise IndexError(
                f"DC pair ({dc_a}, {dc_b}) outside topology with {self.n_dcs} DCs"
            )
        if dc_a == dc_b:
            return wan.Link(self.intra_latency_ms, self.intra_bw_gbps)
        l = self.links.get((dc_a, dc_b))
        if l is None:
            l = self.links.get((dc_b, dc_a))
        if l is None:
            l = wan.wan_link(self.default_latency_ms, self.multi_tcp)
        return l

    def is_wan(self, dc_a: int, dc_b: int) -> bool:
        return dc_a != dc_b

    def bandwidth_schedule(
        self, dc_a: int, dc_b: int
    ) -> Optional[wan.BandwidthSchedule]:
        """Time-varying bandwidth of the directed ``dc_a -> dc_b`` link,
        or ``None`` when the pair is static (intra-DC pairs always are)."""
        if dc_a == dc_b:
            return None
        s = self.bw_schedules.get((dc_a, dc_b))
        if s is None:
            s = self.bw_schedules.get((dc_b, dc_a))
        return s

    def time_varying(self) -> bool:
        """Does any WAN pair carry a non-flat bandwidth schedule?"""
        return any(not s.is_flat() for s in self.bw_schedules.values())

    def effective_bw_gbps(self, dc_a: int, dc_b: int) -> float:
        """Planning-time bandwidth of the directed pair: the *worst
        segment* of its schedule when one is attached, else the static
        link rate.  Placement decisions price a link by what it can
        guarantee, not by its best hour."""
        sched = self.bandwidth_schedule(dc_a, dc_b)
        if sched is not None:
            return sched.min_bw_gbps()
        return self.link(dc_a, dc_b).bw_gbps

    # --- schedule attachment ---------------------------------------------
    def with_bandwidth_schedules(
        self, schedules: Mapping[Pair, wan.BandwidthSchedule]
    ) -> "TopologyMatrix":
        """A copy with ``schedules`` attached (replacing any existing)."""
        return dataclasses.replace(self, bw_schedules=dict(schedules))

    def with_trace_schedules(
        self,
        *,
        hours: float = 24.0,
        samples_per_hour: int = 60,
        seed: int = 0,
    ) -> "TopologyMatrix":
        """Attach a Fig-7 measured-style trace schedule to every directed
        WAN pair.  The seed folds in the pair (and, inside the trace
        generator, the link's full-precision latency and bandwidth), so
        distinct pairs fluctuate independently while a fixed topology
        stays deterministic."""
        scheds = {
            (a, b): wan.BandwidthSchedule.from_trace(
                self.link(a, b),
                hours=hours,
                samples_per_hour=samples_per_hour,
                seed=seed * 10007 + a * self.n_dcs + b,
            )
            for a, b in self.wan_pairs()
        }
        return self.with_bandwidth_schedules(scheds)

    def with_rate_multipliers(
        self, mults: Mapping[Pair, float]
    ) -> "TopologyMatrix":
        """The *contended* view of this WAN: every directed pair in
        ``mults`` delivers ``mult ×`` its nominal rate — what one job of
        a fleet observes after the channel allocator (``repro_torch.core
        .fleet``) grants it a fraction of each shared channel.  Latencies
        and pairs absent from ``mults`` are unchanged; an empty/identity
        ``mults`` returns ``self`` so the uncontended path keeps object
        identity (a single-job fleet must be differentially identical to
        ``control.simulate_horizon`` on the live topology).

        Every directed WAN link (and every scheduled direction) is
        materialized explicitly in the copy: the reverse-pair fallback of
        ``links``/``bw_schedules`` would otherwise alias a scaled entry
        onto its unscaled reverse direction."""
        eff = {p: m for p, m in mults.items() if m != 1.0}
        if not eff:
            return self
        assert all(m > 0.0 for m in eff.values()), eff
        links: Dict[Pair, wan.Link] = {}
        scheds: Dict[Pair, wan.BandwidthSchedule] = {}
        for a, b in self.wan_pairs():
            m = eff.get((a, b), 1.0)
            link = self.link(a, b)
            links[(a, b)] = (
                link if m == 1.0 else wan.Link(link.latency_ms, link.bw_gbps * m)
            )
            sched = self.bandwidth_schedule(a, b)
            if sched is not None:
                scheds[(a, b)] = sched.scaled(m)
        return dataclasses.replace(
            self,
            links=links,
            bw_schedules=scheds,
            name=(self.name or "topology") + "+contended",
        )

    def snapshot(self, t_ms: float, window_ms: float = 0.0) -> "TopologyMatrix":
        """The WAN as *observed* at wall time ``t_ms``: a static matrix
        whose link bandwidths are what each schedule actually delivers —
        the rate in force at ``t_ms``, or the mean over the trailing
        ``[t_ms - window_ms, t_ms)`` window when ``window_ms > 0`` (a
        short window smooths trace jitter without hiding an outage).
        Schedules are dropped: the re-planner (``repro_torch.core.control``)
        plans on current conditions, not on a trace it has no forecast
        for.  Latencies and unscheduled pairs are unchanged."""
        links: Dict[Pair, wan.Link] = dict(self.links)
        for a, b in self.wan_pairs():
            sched = self.bandwidth_schedule(a, b)
            if sched is None:
                continue
            if window_ms > 0.0 and t_ms > 0.0:
                bw = sched.mean_bw_gbps(max(0.0, t_ms - window_ms), t_ms)
            else:
                bw = sched.bw_at(t_ms)
            links[(a, b)] = wan.Link(self.link(a, b).latency_ms, bw)
        return dataclasses.replace(
            self,
            links=links,
            bw_schedules={},
            name=(self.name or "topology") + f"@{t_ms:g}ms",
        )

    # --- helpers ---------------------------------------------------------
    def index_of(self, dc_name: str, fallback: Optional[int] = None) -> int:
        if self.dc_names and dc_name in self.dc_names:
            return self.dc_names.index(dc_name)
        if fallback is None:
            raise KeyError(dc_name)
        return fallback

    def wan_pairs(self) -> Sequence[Pair]:
        return [(a, b) for a in range(self.n_dcs) for b in range(self.n_dcs) if a != b]

    def bottleneck(self) -> wan.Link:
        """Slowest (lowest-bandwidth; ties: highest-latency) WAN link."""
        return min(
            (self.link(a, b) for a, b in self.wan_pairs()),
            key=lambda l: (l.bw_gbps, -l.latency_ms),
        )

    def best_link(self) -> wan.Link:
        """Fastest (highest-bandwidth; ties: lowest-latency) WAN link."""
        return max(
            (self.link(a, b) for a, b in self.wan_pairs()),
            key=lambda l: (l.bw_gbps, -l.latency_ms),
        )

    # --- constructors ----------------------------------------------------
    @classmethod
    def uniform(
        cls,
        n_dcs: int,
        wan_latency_ms: float = 40.0,
        multi_tcp: bool = True,
        **kw,
    ) -> "TopologyMatrix":
        return cls(
            n_dcs=n_dcs,
            default_latency_ms=wan_latency_ms,
            multi_tcp=multi_tcp,
            name=kw.pop("name", f"uniform{n_dcs}@{wan_latency_ms:g}ms"),
            **kw,
        )

    @classmethod
    def from_latency(
        cls,
        latency_ms: Sequence[Sequence[float]],
        multi_tcp: bool = True,
        **kw,
    ) -> "TopologyMatrix":
        """Square per-pair latency matrix -> per-pair links, bandwidth from
        the TCP model (multi-TCP saturates the node-pair cap; single-TCP is
        cwnd-limited by each pair's RTT — Table 1)."""
        n = len(latency_ms)
        links: Dict[Pair, wan.Link] = {}
        for a in range(n):
            assert len(latency_ms[a]) == n, "latency matrix must be square"
            for b in range(n):
                if a == b:
                    continue
                links[(a, b)] = wan.wan_link(float(latency_ms[a][b]), multi_tcp)
        return cls(n_dcs=n, links=links, multi_tcp=multi_tcp, **kw)

    @classmethod
    def from_links(cls, n_dcs: int, links: Mapping[Pair, wan.Link], **kw) -> "TopologyMatrix":
        return cls(n_dcs=n_dcs, links=dict(links), **kw)


# ---------------------------------------------------------------------------
# presets
# ---------------------------------------------------------------------------


def azure_testbed(multi_tcp: bool = True) -> TopologyMatrix:
    """The paper's Azure WAN (Fig 5 cities): us-east, us-south-central,
    us-west, se-asia.  Pairwise latencies from the measured distances;
    intra-US pairs are short, trans-Pacific pairs dominate."""
    #           use  ussc usw  asia
    lat = [
        [0.0, 16.0, 34.0, 95.0],
        [16.0, 0.0, 20.0, 105.0],
        [34.0, 20.0, 0.0, 85.0],
        [95.0, 105.0, 85.0, 0.0],
    ]
    return TopologyMatrix.from_latency(
        lat,
        multi_tcp=multi_tcp,
        dc_names=("us-east", "us-south-central", "us-west", "se-asia"),
        name="azure-testbed",
    )


def skewed_3dc(
    fast_ms: float = 10.0,
    slow_ms: float = 150.0,
    multi_tcp: bool = True,
) -> TopologyMatrix:
    """Three DCs where exactly one pair (0<->2) is much slower — the
    minimal heterogeneous WAN: placement must keep the slow pair off the
    pipeline's stage boundaries."""
    lat = [
        [0.0, fast_ms, slow_ms],
        [fast_ms, 0.0, fast_ms],
        [slow_ms, fast_ms, 0.0],
    ]
    # the slow pair is also single-TCP-limited: long-haul cwnd collapse
    links: Dict[Pair, wan.Link] = {}
    for a in range(3):
        for b in range(3):
            if a == b:
                continue
            slow = {a, b} == {0, 2}
            links[(a, b)] = wan.wan_link(lat[a][b], multi_tcp and not slow)
    return TopologyMatrix.from_links(
        3, links, dc_names=("dc0", "dc1", "dc2"), name="skewed-3dc"
    )


def star(n_dcs: int = 4, hub_ms: float = 15.0, multi_tcp: bool = True) -> TopologyMatrix:
    """Hub-and-spoke: DC 0 is the hub; spoke<->spoke traffic transits the
    hub (2x latency, same node-pair cap)."""
    links: Dict[Pair, wan.Link] = {}
    for a in range(n_dcs):
        for b in range(n_dcs):
            if a == b:
                continue
            ms = hub_ms if 0 in (a, b) else 2.0 * hub_ms
            links[(a, b)] = wan.wan_link(ms, multi_tcp)
    return TopologyMatrix.from_links(n_dcs, links, name=f"star{n_dcs}")


def chain(n_dcs: int = 4, hop_ms: float = 20.0, multi_tcp: bool = True) -> TopologyMatrix:
    """Linear chain (e.g. DCs along a coast): latency grows with hop
    distance, bandwidth of distant pairs decays to the single-TCP law."""
    links: Dict[Pair, wan.Link] = {}
    for a in range(n_dcs):
        for b in range(n_dcs):
            if a == b:
                continue
            d = abs(a - b)
            links[(a, b)] = wan.wan_link(d * hop_ms, multi_tcp and d == 1)
    return TopologyMatrix.from_links(n_dcs, links, name=f"chain{n_dcs}")


PRESETS = {
    "azure": azure_testbed,
    "skewed": skewed_3dc,
    "star": star,
    "chain": chain,
}


def preset(name: str, **kw) -> TopologyMatrix:
    if name.startswith("uniform"):
        return TopologyMatrix.uniform(int(name[len("uniform"):] or 3), **kw)
    return PRESETS[name](**kw)
