"""WAN transport model — paper §3/§4.1.

Reproduces Table 1 (single-TCP bandwidth vs latency), Fig 5 (multi-TCP
scaling to the ~5 Gbps per-node-pair hypervisor cap) and the transfer-time
arithmetic used throughout the simulator and Algorithm 1.

Single-connection TCP throughput is inversely proportional to RTT
(cwnd-limited); we calibrate the constant to the paper's Table 1:
    10 ms -> 1220 Mbps   20 ms -> 600   30 ms -> 396   40 ms -> 293
(products 12.2, 12.0, 11.9, 11.7 Gbit·ms — an almost perfect K/RTT law).

The port's own copy of ``repro/core/wan.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import zlib
from bisect import bisect_right
from typing import Optional, Sequence, Tuple

from repro_torch import units

# calibration constants (paper Table 1 / Fig 5 / §4.1)
TCP_THROUGHPUT_K = 12.0  # single-connection bw ≈ K / latency_ms; K in Gbit/s·ms
SINGLE_CONN_MAX_GBPS = 1.22  # Table 1 @ 10 ms; NIC-side cap for short RTT
NODE_PAIR_CAP_GBPS = 5.0  # hypervisor rate limit (paper §4.1, AWS/Azure)
INTRA_DC_GBPS = 100.0  # paper §6.1 testbed intra-DC cap
INTRA_DC_LATENCY_MS = 0.1
PAPER_TABLE1 = {10: 1220.0, 20: 600.0, 30: 396.0, 40: 293.0}  # latency->Mbps


def tcp_single_bw_gbps(latency_ms: float) -> float:
    """Achievable single-TCP-connection bandwidth (Gbit/s) over the WAN."""
    if latency_ms <= 0:
        return SINGLE_CONN_MAX_GBPS
    return min(SINGLE_CONN_MAX_GBPS, TCP_THROUGHPUT_K / latency_ms)


def tcp_multi_bw_gbps(latency_ms: float, num_connections: int) -> float:
    """Aggregate bandwidth with ``num_connections`` parallel TCP flows —
    linear scaling until the per-node-pair hypervisor cap (paper Fig 5)."""
    return min(NODE_PAIR_CAP_GBPS, num_connections * tcp_single_bw_gbps(latency_ms))


def connections_for_cap(latency_ms: float) -> int:
    """How many connections Atlas spawns to saturate the node-pair cap."""
    single = tcp_single_bw_gbps(latency_ms)
    n = 1
    while n * single < NODE_PAIR_CAP_GBPS and n < 1024:
        n += 1
    return n


@dataclasses.dataclass(frozen=True)
class Link:
    """A (directed) node-pair path between two DCs (or within one)."""

    latency_ms: float
    bw_gbps: float

    def transfer_ms(self, nbytes: float) -> float:
        return self.latency_ms + units.serialization_ms(nbytes, self.bw_gbps)


def wan_link(latency_ms: float, multi_tcp: bool) -> Link:
    bw = NODE_PAIR_CAP_GBPS if multi_tcp else tcp_single_bw_gbps(latency_ms)
    return Link(latency_ms=latency_ms, bw_gbps=bw)


def intra_dc_link() -> Link:
    return Link(latency_ms=INTRA_DC_LATENCY_MS, bw_gbps=INTRA_DC_GBPS)


# ---------------------------------------------------------------------------
# time-varying bandwidth (paper Fig 7: measured 24-h inter-DC traces)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BandwidthSchedule:
    """Piecewise-constant bandwidth of one *directed* link over time.

    ``bw_gbps[i]`` is in force on ``[times_ms[i], times_ms[i+1])``; the
    last segment extends to infinity, and ``times_ms[0]`` must be 0.  A
    transfer that spans a segment boundary integrates bytes across the
    segments (``transfer_ms``) — there is no memoizable constant transfer
    time on a time-varying link.

    ``period_ms`` makes the profile wrap around: the pattern on
    ``[0, period_ms)`` repeats forever (day 2 of a 24-h diurnal trace
    looks like day 1, not like its last sample frozen in time).
    ``diurnal``/``from_trace`` set it to their natural cycle; ``flat``/
    ``step``/``outage`` model one-shot events and do not.

    Built from a measured/synthetic sample trace (``from_samples`` /
    ``from_trace``) or from analytic profiles (``flat`` / ``step`` /
    ``outage`` / ``diurnal``).  Attach to ``TopologyMatrix.bw_schedules``
    to drive the simulator, scheduler, validator and Algorithm 1.
    """

    times_ms: Tuple[float, ...]
    bw_gbps: Tuple[float, ...]
    period_ms: Optional[float] = None

    def __post_init__(self):
        assert len(self.times_ms) == len(self.bw_gbps) >= 1
        assert self.times_ms[0] == 0.0, "first segment must start at t=0"
        for a, b in zip(self.times_ms, self.times_ms[1:]):
            assert b > a, "segment starts must be strictly increasing"
        assert all(bw > 0 for bw in self.bw_gbps), "bandwidth must be positive"
        if self.period_ms is not None:
            assert self.period_ms > self.times_ms[-1], (
                "period must exceed the last segment start"
            )
            # whole-cycle capacity at rate_mult=1, precomputed once: the
            # periodic transfer loop must not re-sum every segment of a
            # 1440-sample trace per priced transfer (object.__setattr__
            # because the dataclass is frozen; not a field, so eq/hash
            # semantics are untouched)
            n = len(self.times_ms)
            object.__setattr__(
                self,
                "_cycle_bits",
                sum(
                    units.window_bits(
                        (self.times_ms[j + 1] if j + 1 < n else self.period_ms)
                        - self.times_ms[j],
                        self.bw_gbps[j],
                    )
                    for j in range(n)
                ),
            )

    # --- queries ----------------------------------------------------------
    def is_flat(self) -> bool:
        return all(bw == self.bw_gbps[0] for bw in self.bw_gbps)

    def bw_at(self, t_ms: float) -> float:
        """Bandwidth (Gbit/s) in force at time ``t_ms`` (clamped to 0)."""
        t = max(0.0, t_ms)
        if self.period_ms is not None:
            t = t % self.period_ms
        i = bisect_right(self.times_ms, t) - 1
        return self.bw_gbps[i]

    def min_bw_gbps(self) -> float:
        """Worst-segment bandwidth — the planning-time pessimistic rate."""
        return min(self.bw_gbps)

    def max_bw_gbps(self) -> float:
        return max(self.bw_gbps)

    def min_bw_over(self, t0_ms: float, t1_ms: float) -> float:
        """Lowest rate in force anywhere on ``[t0_ms, t1_ms)`` — the
        pointwise capacity floor the fleet invariant checker compares
        aggregate channel reservations against."""
        t0 = max(0.0, t0_ms)
        assert t1_ms > t0, (t0_ms, t1_ms)
        lo = float("inf")
        for bw, _s0, s1 in self._segments_from(t0):
            lo = min(lo, bw)
            if s1 >= t1_ms:
                break
        return lo

    def scaled(self, mult: float) -> "BandwidthSchedule":
        """This schedule with every segment's rate multiplied by
        ``mult`` — the *contended* view of a shared channel: a job
        granted a fair-share fraction of the link sees the same shape
        (segments, period) at ``mult ×`` the rate.  ``mult == 1``
        returns ``self`` so uncontended paths keep object identity
        (engine memo keys and schedule-dedup rely on it)."""
        if mult == 1.0:
            return self
        assert mult > 0.0, mult
        return BandwidthSchedule(
            self.times_ms,
            tuple(bw * mult for bw in self.bw_gbps),
            self.period_ms,
        )

    def transfer_ms(self, nbytes: float, start_ms: float, rate_mult: float = 1.0) -> float:
        """Serialization time of ``nbytes`` starting at ``start_ms``,
        integrating the bits across segment boundaries.  ``rate_mult``
        scales the rate (Atlas temporal sharing sends at D× node-pair
        bandwidth).  On a flat schedule this reduces to the static
        ``bytes·8 / bw`` formula exactly."""
        rem = units.bytes_to_bits(nbytes)
        t = max(0.0, start_ms)
        if self.period_ms is None:
            i = bisect_right(self.times_ms, t) - 1
            n = len(self.times_ms)
            while True:
                bw = self.bw_gbps[i] * rate_mult
                if i + 1 >= n:
                    return (t - start_ms) + units.bits_serialization_ms(rem, bw)
                seg_ms = self.times_ms[i + 1] - t
                cap_bits = units.window_bits(seg_ms, bw)
                if rem <= cap_bits:
                    return (t - start_ms) + units.bits_serialization_ms(rem, bw)
                rem -= cap_bits
                t = self.times_ms[i + 1]
                i += 1
        # periodic profile: walk segments cyclically, skipping whole
        # cycles in O(1) so a transfer many cycles long stays cheap
        period = self.period_ms
        n = len(self.times_ms)
        base = (t // period) * period
        tau = t - base
        i = bisect_right(self.times_ms, tau) - 1
        cycle_bits = self._cycle_bits * rate_mult
        while True:
            bw = self.bw_gbps[i] * rate_mult
            nxt = self.times_ms[i + 1] if i + 1 < n else period
            cap_bits = units.window_bits(nxt - tau, bw)
            if rem <= cap_bits:
                return (base + tau - start_ms) + units.bits_serialization_ms(rem, bw)
            rem -= cap_bits
            tau = nxt
            i += 1
            if i >= n:
                base += period
                tau = 0.0
                i = 0
                if rem > cycle_bits:
                    k = int(rem // cycle_bits)
                    rem -= k * cycle_bits
                    base += k * period

    def _segments_from(self, t_ms: float):
        """Yield ``(bw_gbps, seg_start_abs, seg_end_abs)`` from ``t_ms``
        on (the caller breaks out; the last segment of an aperiodic
        schedule ends at +inf, a periodic one yields forever)."""
        import math

        t = max(0.0, t_ms)
        n = len(self.times_ms)
        if self.period_ms is None:
            i = bisect_right(self.times_ms, t) - 1
            while True:
                end = self.times_ms[i + 1] if i + 1 < n else math.inf
                yield self.bw_gbps[i], t, end
                t = end
                i += 1
        else:
            period = self.period_ms
            base = (t // period) * period
            tau = t - base
            i = bisect_right(self.times_ms, tau) - 1
            while True:
                nxt = self.times_ms[i + 1] if i + 1 < n else period
                yield self.bw_gbps[i], base + tau, base + nxt
                tau = nxt
                i += 1
                if i >= n:
                    base += period
                    tau = 0.0
                    i = 0

    def bits_sent(
        self, nbytes: float, start_ms: float, until_ms: float, rate_mult: float = 1.0
    ) -> float:
        """Bits of an ``nbytes`` transfer begun at ``start_ms`` that are
        on the wire by ``until_ms`` (capped at the transfer size) — the
        preemption primitive: integrate the rate over the elapsed window
        instead of assuming any single segment's bandwidth."""
        total = units.bytes_to_bits(nbytes)
        t0 = max(0.0, start_ms)
        if until_ms <= t0:
            return 0.0
        sent = 0.0
        for bw, s0, s1 in self._segments_from(t0):
            hi = min(s1, until_ms)
            sent += units.window_bits(hi - max(s0, t0), bw, rate_mult)
            if sent >= total:
                return total
            if s1 >= until_ms:
                break
        return sent

    def preempt(
        self, nbytes: float, start_ms: float, at_ms: float, rate_mult: float = 1.0
    ) -> Tuple[float, float]:
        """Cut an in-flight transfer at ``at_ms``: the bits already sent
        are kept, the remainder re-integrates at whatever rate rules
        from ``at_ms`` on (``transfer_ms(remaining, at_ms)``).  Returns
        ``(sent_bytes, remaining_bytes)``.  Splitting at any point and
        resuming immediately reproduces the unsplit ``transfer_ms``
        exactly — the differential identity the tests pin down."""
        sent = units.bits_to_bytes(self.bits_sent(nbytes, start_ms, at_ms, rate_mult))
        return sent, nbytes - sent

    def mean_bw_gbps(self, t0_ms: float, t1_ms: float) -> float:
        """Average bandwidth actually delivered over ``[t0_ms, t1_ms)`` —
        what the drift detector compares against the plan's assumption."""
        t0 = max(0.0, t0_ms)
        assert t1_ms > t0, (t0_ms, t1_ms)
        acc = 0.0
        for bw, s0, s1 in self._segments_from(t0):
            hi = min(s1, t1_ms)
            acc += (hi - max(s0, t0)) * bw
            if s1 >= t1_ms:
                break
        return acc / (t1_ms - t0)

    def constant_over(self, t0_ms: float, t1_ms: float) -> bool:
        """Is the rate constant over ``[t0_ms, t1_ms)``?  (The horizon
        simulator may reuse an iteration result only inside such a
        window.)"""
        if self.is_flat():
            return True
        for _bw, _s0, s1 in self._segments_from(max(0.0, t0_ms)):
            return s1 >= t1_ms
        return False

    # --- constructors -----------------------------------------------------
    @classmethod
    def flat(cls, bw_gbps: float) -> "BandwidthSchedule":
        return cls((0.0,), (float(bw_gbps),))

    @classmethod
    def from_samples(
        cls,
        samples_gbps: Sequence[float],
        sample_ms: float,
        *,
        period_ms: Optional[float] = None,
    ) -> "BandwidthSchedule":
        """A measured trace, one sample per ``sample_ms`` — consecutive
        equal samples are coalesced into one segment.  ``period_ms``
        (typically ``len(samples) * sample_ms``) wraps the trace so
        horizons longer than the measurement replay it cyclically."""
        assert samples_gbps and sample_ms > 0
        times = [0.0]
        bws = [float(samples_gbps[0])]
        for k, s in enumerate(samples_gbps[1:], start=1):
            if s != bws[-1]:
                times.append(k * sample_ms)
                bws.append(float(s))
        return cls(tuple(times), tuple(bws), period_ms)

    @classmethod
    def from_trace(
        cls,
        link: Link,
        *,
        hours: float = 24.0,
        samples_per_hour: int = 60,
        seed: int = 0,
    ) -> "BandwidthSchedule":
        """The Fig-7 AR(1) stability trace of ``link`` as a schedule,
        wrapping at the trace length (day 2 replays day 1 instead of
        holding the last sample forever)."""
        trace = bandwidth_trace_for_link(
            link, hours=hours, samples_per_hour=samples_per_hour, seed=seed
        )
        return cls.from_samples(
            trace, 3.6e6 / samples_per_hour, period_ms=hours * 3.6e6
        )

    @classmethod
    def step(cls, bw0_gbps: float, bw1_gbps: float, at_ms: float) -> "BandwidthSchedule":
        """One step change at ``at_ms`` (e.g. a 2:1 degradation)."""
        return cls((0.0, float(at_ms)), (float(bw0_gbps), float(bw1_gbps)))

    @classmethod
    def outage(
        cls,
        bw_gbps: float,
        start_ms: float,
        end_ms: float,
        degraded_gbps: float,
    ) -> "BandwidthSchedule":
        """Nominal bandwidth with a degraded window [start, end) — link
        failures reroute over slow paths rather than dropping to zero."""
        assert 0.0 < start_ms < end_ms
        return cls(
            (0.0, float(start_ms), float(end_ms)),
            (float(bw_gbps), float(degraded_gbps), float(bw_gbps)),
        )

    @classmethod
    def diurnal(
        cls,
        peak_gbps: float,
        trough_gbps: float,
        period_ms: float = 24 * 3.6e6,
        steps: int = 24,
        cycles: int = 1,
    ) -> "BandwidthSchedule":
        """Piecewise-constant approximation of a diurnal cosine: capacity
        peaks mid-cycle (off-peak hours) and bottoms at the cycle edges.
        The schedule wraps at ``cycles * period_ms`` — diurnal congestion
        repeats every day, it does not freeze at the last step."""
        import math

        assert steps >= 2 and cycles >= 1
        mid = (peak_gbps + trough_gbps) / 2.0
        amp = (peak_gbps - trough_gbps) / 2.0
        times, bws = [], []
        for c in range(cycles):
            for k in range(steps):
                times.append(c * period_ms + k * period_ms / steps)
                phase = 2.0 * math.pi * (k + 0.5) / steps
                bws.append(mid - amp * math.cos(phase))
        return cls(tuple(times), tuple(bws), cycles * period_ms)


# ---------------------------------------------------------------------------
# analytic communication times (paper §3 footnotes)
# ---------------------------------------------------------------------------


def bandwidth_trace_gbps(
    latency_ms: float,
    *,
    hours: float = 24.0,
    samples_per_hour: int = 60,
    seed: int = 0,
    multi_tcp: bool = True,
) -> "list[float]":
    """Paper Fig 7: 24-h bandwidth stability between Azure DCs.

    WANs are well-provisioned; the paper measured a coefficient of
    variation of just 0.8% (US-East↔SE-Asia) and 2.3% (US-East↔US-West) —
    counter-intuitively, the *longer* path is steadier.  We model CoV as
    decreasing with distance (long-haul paths are dedicated/underutilized)
    and emit a deterministic AR(1) trace around the mean.
    """
    link = Link(latency_ms, NODE_PAIR_CAP_GBPS if multi_tcp else tcp_single_bw_gbps(latency_ms))
    return bandwidth_trace_for_link(
        link, hours=hours, samples_per_hour=samples_per_hour, seed=seed
    )


def bandwidth_trace_for_link(
    link: Link,
    *,
    hours: float = 24.0,
    samples_per_hour: int = 60,
    seed: int = 0,
) -> "list[float]":
    """Fig-7 stability trace for an arbitrary (heterogeneous) link: a
    deterministic AR(1) fluctuation around the link's bandwidth with CoV
    decreasing in distance (~2.3% short-haul, ~0.8% long-haul).

    The RNG seed folds in the link's full-precision latency AND its
    bandwidth: two heterogeneous links that merely share an integer
    latency (or a single-TCP vs multi-TCP pair at the same RTT) must not
    emit correlated fluctuation patterns.  Deterministic for a fixed
    (link, seed)."""
    import math
    import random

    cov = 0.023 * math.exp(-link.latency_ms / 80.0) + 0.008
    link_key = zlib.crc32(f"{link.latency_ms!r}|{link.bw_gbps!r}".encode())
    rng = random.Random(seed * 100003 + link_key)
    n = int(hours * samples_per_hour)
    out = []
    x = 0.0
    x_std = 0.1 / math.sqrt(1 - 0.9**2)  # stationary std of the AR(1)
    for _ in range(n):
        x = 0.9 * x + 0.1 * rng.gauss(0.0, 1.0)
        out.append(link.bw_gbps * (1.0 + cov * x / x_std))
    return out


def trace_cov(trace: "list[float]") -> float:
    m = sum(trace) / len(trace)
    var = sum((x - m) ** 2 for x in trace) / len(trace)
    return (var ** 0.5) / m


# --- §6.7: semantics-altering compression (the paper's negative result) ---

COMPRESSION_RATIO = 0.25  # SVD/Top-K activation compression factor
COMPRESSION_COMPUTE_MULT = 2.0  # extra compute to reach the same loss (§6.7)


def allreduce_ms(param_bytes: float, n_nodes: int, bw_gbps: float) -> float:
    """Ring all-reduce time (paper §3.1 footnote 1): 4·P·(N−1)/(N·BW),
    with P in bytes fp16 already accounted by the caller's byte count —
    the paper's factor 4 = 2 traversals × 2 bytes/param; here we take raw
    bytes and use the 2·(N−1)/N traversal volume."""
    if n_nodes <= 1:
        return 0.0
    vol = 2.0 * param_bytes * (n_nodes - 1) / n_nodes
    return units.serialization_ms(vol, bw_gbps)


def activation_bytes(micro_batch: int, seq_len: int, hidden: int, bytes_per: int = 2) -> float:
    """Paper §3.2 footnote 2: activation (and gradient) size = B·L·H."""
    return float(micro_batch) * seq_len * hidden * bytes_per
