"""BubbleTea — prefill-as-a-service in training bubbles (paper §5).

Components:
  * ``PrefillLatencyModel`` — deterministic prefill-duration / TTFT model
    for an inference model served PP-sharded over training GPUs (Fig 14):
    compute + per-stage pipeline hops + the weight-swap penalty that makes
    high PP degrees *win* for large prefills (PP=p keeps model_bytes/p per
    GPU resident in the small BubbleTea memory budget; PP=1 must stream
    non-resident layers over PCIe once compute saturates).
  * ``ArrivalProcess`` / ``PromptMix`` — deterministic (seeded) production
    traffic: a diurnal-modulated Poisson stream, optionally Markov-
    modulated (on/off bursts, an MMPP-2), with a prompt-length mixture
    and an SLO-tier mixture.  One continuous arrival-ordered stream feeds
    ``BubbleTeaController.submit`` across re-plan epochs.
  * ``BubbleTeaController`` — receives prefill requests from the inference
    controller, places them into *reserved* bubble windows of a training
    pipeline (same-rank GPUs across DP-cells, same DC — §5.1), never
    concurrent with training compute, and hands the KV cache to a decode
    GPU (Splitwise-style).  Admission is SLO-*tier* aware: each request
    carries a tier whose TTFT budget gates its placement, and acceptance
    and TTFT percentiles are reported per tier.  Requests that do not fit
    any bubble are rejected back to the dedicated inference fleet.
  * KV-handoff pricing protocol (``KVQuote``) — when the decode DC is not
    the prefill DC the KV cache is real WAN traffic; a pricer object
    (``price``/``commit``) quotes the transfer so the controller can fold
    it into TTFT *before* admission.  ``LocalKVHandoff`` is the same-DC
    NVLink default; ``repro_torch.core.fleet.KVFlows`` prices the transfer at
    contended (residual) bandwidth on the shared fleet WAN and records it
    in the reservation ledger.

The controller consumes bubbles produced by ``repro_torch.core.simulator`` /
``repro_torch.core.temporal`` — the same bubble-consolidation property Atlas
§4.3 advertises is what gives BubbleTea long contiguous windows.

The port's own copy of ``repro/core/bubbletea.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import random
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch import obs, units

# hardware constants (A100 80GB testbed, paper §6)
GPU_TFLOPS = 312.0  # A100 bf16 dense
PREFILL_EFFICIENCY = 0.55  # achieved fraction of peak during prefill
PCIE_GBPS_BYTES = 64.0  # one-way PCIe gen5 (paper §5 fn. 4), GB/s
NVLINK_GBPS_BYTES = 100.0  # effective KV-transfer bandwidth intra-node
# the three constants below are calibrated so the TTFT model hits the
# paper's two Fig 14 anchors: PP=8 inflates TTFT by +29% at 512 tokens;
# PP=1 is +67% over PP=8 at 8K tokens (see EXPERIMENTS.md §Fig14)
BASE_OVERHEAD_MS = 29.0  # tokenization + queueing + launch
PIPE_HOP_MS = 3.2  # per-stage activation hop + kernel relaunch
SATURATION_TOKENS = 2048  # prompt length beyond which compute saturates
SWAP_OVERLAP = 0.34  # fraction of swap hidden under compute


@dataclasses.dataclass(frozen=True)
class InferenceModelSpec:
    name: str
    num_params: float  # e.g. 8e9 for Llama3-8B
    bytes_per_param: float = 2.0  # fp16
    kv_bytes_per_token: float = 131072.0  # 2·L·Hkv·dh·2B (llama3-8b GQA)
    mem_budget_gb: float = 2.0  # BubbleTea per-GPU weight budget (§5.1)

    @property
    def model_bytes(self) -> float:
        return self.num_params * self.bytes_per_param


@dataclasses.dataclass(frozen=True)
class PrefillLatencyModel:
    model: InferenceModelSpec
    gpu_tflops: float = GPU_TFLOPS

    def compute_ms(self, prompt_tokens: int) -> float:
        flops = 2.0 * self.model.num_params * prompt_tokens
        return flops / (self.gpu_tflops * 1e12 * PREFILL_EFFICIENCY) * 1e3

    def swap_ms(self, prompt_tokens: int, pp_degree: int) -> float:
        """Weight-streaming penalty (§6.6): with PP=p each GPU must hold
        model_bytes/p; bytes beyond the resident budget stream over PCIe
        once per compute wave and only partially overlap."""
        per_gpu = self.model.model_bytes / pp_degree
        budget = units.gb_to_bytes(self.model.mem_budget_gb)
        non_resident_total = max(0.0, per_gpu - budget) * pp_degree
        if non_resident_total <= 0.0:
            return 0.0
        waves = max(1, -(-prompt_tokens // SATURATION_TOKENS))
        if prompt_tokens < SATURATION_TOKENS:
            return 0.0  # streaming fully hidden under unsaturated compute
        stream_ms = units.serialization_ms_gbytes(non_resident_total, PCIE_GBPS_BYTES)
        return waves * stream_ms * (1.0 - SWAP_OVERLAP)

    def prefill_ms(self, prompt_tokens: int, pp_degree: int) -> float:
        """End-to-end prefill duration on `pp_degree` stages."""
        return (
            self.compute_ms(prompt_tokens)
            + (pp_degree - 1) * PIPE_HOP_MS
            + self.swap_ms(prompt_tokens, pp_degree)
        )

    def ttft_ms(self, prompt_tokens: int, pp_degree: int, queue_ms: float = 0.0) -> float:
        kv_ms = units.serialization_ms_gbytes(
            prompt_tokens * self.model.kv_bytes_per_token, NVLINK_GBPS_BYTES
        )
        return BASE_OVERHEAD_MS + queue_ms + self.prefill_ms(prompt_tokens, pp_degree) + kv_ms


# ---------------------------------------------------------------------------
# production traffic: seeded arrival processes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PromptMix:
    """Discrete prompt-length mixture (production traces are heavy on
    short prompts with a long tail of large contexts)."""

    lengths: Tuple[int, ...] = (128, 256, 512, 1024, 2048, 4096, 8192)
    weights: Tuple[float, ...] = (0.25, 0.22, 0.18, 0.15, 0.10, 0.06, 0.04)

    def __post_init__(self):
        assert len(self.lengths) == len(self.weights) and self.lengths
        assert all(w >= 0 for w in self.weights) and sum(self.weights) > 0


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Deterministic (seeded) request-arrival generator.

    Base process is Poisson at ``rate_per_s``, modulated two ways:

      * diurnal — the rate swings sinusoidally by ``±diurnal_amplitude``
        over ``diurnal_period_ms`` (production traffic's day/night wave);
      * bursty — an on/off Markov modulation (an MMPP-2): exponential
        dwells of ``mean_off_ms`` at the base rate and ``mean_on_ms`` at
        ``burst_rate_mult ×`` the base rate.  Disabled unless
        ``burst_rate_mult > 1`` and both dwell means are positive.

    Generation uses thinning against the peak rate, driven by a single
    ``random.Random(seed)`` stream, so the trace is a pure function of
    the dataclass fields — two processes with equal fields emit
    identical arrival-ordered ``PrefillRequest`` lists.
    """

    rate_per_s: float
    horizon_ms: float
    seed: int = 0
    diurnal_amplitude: float = 0.0  # 0..1 fraction of the base rate
    diurnal_period_ms: float = 86_400_000.0
    burst_rate_mult: float = 1.0
    mean_on_ms: float = 0.0
    mean_off_ms: float = 0.0

    def __post_init__(self):
        assert self.rate_per_s > 0 and self.horizon_ms > 0
        assert 0.0 <= self.diurnal_amplitude <= 1.0
        assert self.burst_rate_mult >= 1.0

    @property
    def _bursty(self) -> bool:
        return (self.burst_rate_mult > 1.0
                and self.mean_on_ms > 0.0 and self.mean_off_ms > 0.0)

    def rate_at(self, t_ms: float, burst_on: bool = False) -> float:
        """Instantaneous rate in requests/ms."""
        lam = self.rate_per_s / 1e3
        lam *= 1.0 + self.diurnal_amplitude * math.sin(
            2.0 * math.pi * t_ms / self.diurnal_period_ms
        )
        if burst_on:
            lam *= self.burst_rate_mult
        return lam

    def generate(
        self,
        prompts: Optional[PromptMix] = None,
        tiers: Optional[Mapping[str, float]] = None,
        req_id0: int = 0,
    ) -> List["PrefillRequest"]:
        """Materialize the trace: arrival-ordered ``PrefillRequest``s with
        prompt lengths drawn from ``prompts`` and (optionally) SLO tiers
        drawn from the ``tiers`` share mapping (tier name → share)."""
        prompts = prompts or PromptMix()
        rng = random.Random(self.seed)
        peak = (self.rate_per_s / 1e3) * (1.0 + self.diurnal_amplitude)
        peak *= self.burst_rate_mult if self._bursty else 1.0
        tier_names: Optional[List[str]] = None
        tier_weights: Optional[List[float]] = None
        if tiers:
            tier_names = list(tiers.keys())
            tier_weights = [float(tiers[n]) for n in tier_names]
        out: List[PrefillRequest] = []
        on = False
        flip_at = rng.expovariate(1.0 / self.mean_off_ms) if self._bursty else math.inf
        t = 0.0
        rid = req_id0
        while True:
            t += rng.expovariate(peak)
            if t >= self.horizon_ms:
                break
            while t >= flip_at:  # advance the on/off modulating chain
                on = not on
                dwell = self.mean_on_ms if on else self.mean_off_ms
                flip_at += rng.expovariate(1.0 / dwell)
            if rng.random() * peak > self.rate_at(t, on):
                continue  # thinned
            tier = None
            if tier_names:
                tier = rng.choices(tier_names, weights=tier_weights)[0]
            out.append(PrefillRequest(
                req_id=rid,
                arrival_ms=t,
                prompt_tokens=rng.choices(prompts.lengths, weights=prompts.weights)[0],
                tier=tier,
            ))
            rid += 1
        return out


# ---------------------------------------------------------------------------
# KV-handoff pricing protocol
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVQuote:
    """Priced KV-cache handoff for one prefill (prefill DC → decode DC).

    ``kv_ms`` is the admission-relevant term: time from KV-ready (prefill
    completion) to fully landed at the decode side, including any channel
    queueing.  ``payload`` is pricer-private state consumed by
    ``commit`` (e.g. the residual-rate segments to reserve)."""

    prompt_tokens: int
    src_dc: Optional[int]
    ready_ms: float
    start_ms: float  # when bytes start moving (>= ready_ms under queueing)
    done_ms: float
    kv_ms: float
    payload: object = None


class LocalKVHandoff:
    """Same-DC handoff over NVLink — the pre-fleet default pricing, as a
    pricer object so the controller has one code path."""

    def __init__(self, model: InferenceModelSpec):
        self.model = model

    def price(self, prompt_tokens: int, src_dc: Optional[int],
              ready_ms: float) -> KVQuote:
        kv_ms = units.serialization_ms_gbytes(
            prompt_tokens * self.model.kv_bytes_per_token, NVLINK_GBPS_BYTES
        )
        return KVQuote(prompt_tokens, src_dc, ready_ms, ready_ms,
                       ready_ms + kv_ms, kv_ms)

    def commit(self, quote: KVQuote) -> None:
        pass  # nothing reserved off-node


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PrefillRequest:
    req_id: int
    arrival_ms: float
    prompt_tokens: int
    tier: Optional[str] = None  # SLO class; None → controller default SLO


@dataclasses.dataclass
class Placement:
    req_id: int
    pipeline: int
    start_ms: float
    duration_ms: float
    ttft_ms: float
    queue_ms: float
    tier: Optional[str] = None
    kv_ms: float = 0.0
    src_dc: Optional[int] = None


@dataclasses.dataclass
class _Window:
    start: float
    end: float


class BubbleTeaController:
    """Admission control + placement of prefills into training bubbles.

    ``pipelines``: list of per-inference-pipeline bubble interval lists.
    Each inference pipeline is formed by same-rank GPUs across DP-cells in
    one DC (paper §5.1); its usable windows are the *intersection* of its
    member GPUs' training bubbles, which the caller computes (for PP=1 the
    member is a single GPU and windows are its raw bubbles).

    Requests must arrive in nondecreasing ``arrival_ms`` order: windows
    that ended before the current arrival are pruned (a per-pipeline live
    cursor), so first-fit scans live windows only instead of degrading
    linearly in dead windows over a long trace.

    ``ttft_slo_ms`` (paper §5: prefills ride bubbles only if the TTFT SLO
    still holds) enables admission control: a request whose *earliest*
    feasible placement already blows the SLO — queue delay included — is
    rejected back to the dedicated inference fleet instead of being
    placed late.  ``tiers`` generalizes this to per-request SLO classes:
    a mapping tier-name → TTFT budget (ms); a request's ``tier`` selects
    its budget (falling back to ``ttft_slo_ms`` for untiered requests),
    and acceptance/TTFT percentiles are reported per tier.

    ``kv`` + ``pipeline_dc`` wire in WAN-priced KV handoff: ``kv`` is a
    pricer with ``price(prompt_tokens, src_dc, ready_ms) → KVQuote`` and
    ``commit(quote)`` (see ``KVQuote``; ``repro_torch.core.fleet.KVFlows`` is
    the contended-WAN implementation), and ``pipeline_dc[pi]`` names the
    DC hosting pipeline ``pi`` (§5.1: every member GPU of an inference
    pipeline sits in one DC).  The quoted ``kv_ms`` replaces the NVLink
    term in TTFT *before* the SLO gate, so a request whose KV cache
    would crawl over a contended channel is rejected up front; admission
    then walks feasible placements in start order and takes the earliest
    one whose tier SLO holds (with heterogeneous KV cost, a later local
    placement may pass where the earliest cross-WAN one cannot).
    """

    def __init__(
        self,
        pipelines: Sequence[Sequence[Tuple[float, float]]],
        latency_model: PrefillLatencyModel,
        pp_degree: int = 1,
        guard_ms: float = 1.0,
        ttft_slo_ms: Optional[float] = None,
        tiers: Optional[Mapping[str, float]] = None,
        pipeline_dc: Optional[Sequence[int]] = None,
        kv: Optional[object] = None,
        clock: Optional[Callable[[], float]] = None,
        tracer: Optional[object] = None,
    ):
        self.lat = latency_model
        # obs tracing (``repro_torch.obs``): placements become spans on the
        # ``prefill`` lane group, admission rejections and WAN KV
        # handoffs become instants — all in sim time
        self.tracer = tracer
        self._tracing = tracer is not None and getattr(tracer, "enabled", False)
        self.pp = pp_degree
        self.guard = guard_ms  # paper §6.5: small residual gap so training
        # resumes without delay
        self.ttft_slo_ms = ttft_slo_ms
        self.tiers = dict(tiers) if tiers else None
        self.kv = kv
        self.windows: List[List[_Window]] = []
        self.pipeline_dc: Optional[List[int]] = None
        self.placements: List[Placement] = []
        self.rejected: List[int] = []
        self.rejected_slo: List[int] = []
        # admission-search profiling is opt-in: ``repro_torch.core`` traces are
        # pure functions of their seeds, so the wall clock only enters
        # when a caller injects one (e.g. ``clock=time.perf_counter``)
        self._clock = clock
        self.search_time_us: List[float] = []
        # per-tier accounting: tier → [offered, placed, slo-rejects, ttfts]
        self._tier_stats: Dict[str, Dict[str, object]] = {}
        self._last_arrival = -math.inf
        self._install(pipelines, pipeline_dc)

    def _install(
        self,
        pipelines: Sequence[Sequence[Tuple[float, float]]],
        pipeline_dc: Optional[Sequence[int]],
    ) -> None:
        # fragments shorter than guard_ms can never host a placement
        # (need = prefill_ms + guard > guard always) — drop them here so
        # first-fit never rescans them (see submit's split, same rule)
        self.windows = [
            sorted((_Window(a, b) for a, b in pipe if b - a > self.guard),
                   key=lambda w: w.start)
            for pipe in pipelines
        ]
        if pipeline_dc is not None:
            assert len(pipeline_dc) == len(self.windows)
            self.pipeline_dc = list(pipeline_dc)
        else:
            self.pipeline_dc = None
        # first window per pipeline that could still serve a request at
        # the latest arrival seen (windows are disjoint and start-sorted,
        # hence end-sorted — everything before the cursor is dead)
        self._live: List[int] = [0] * len(self.windows)

    def reset_windows(
        self,
        bubbles_by_pipeline: Sequence[Sequence[Tuple[float, float]]],
        pipeline_dc: Optional[Sequence[int]] = None,
    ) -> None:
        """Replace the bubble windows wholesale — the control-plane hook.

        After a re-plan epoch (``repro_torch.core.control``) the training
        schedule, and therefore every bubble, is different: stale
        windows would let prefills land inside migration stalls or the
        new schedule's compute.  The caller recomputes the intersected
        bubbles from the new epoch's ``SimResult`` and swaps them in
        (with ``pipeline_dc`` when the placement moved pipelines across
        DCs); live cursors restart at the new windows' heads.
        Accounting (placements, rejections, the arrival-order clock)
        carries over — the controller is one continuous service across
        epochs."""
        self._install(bubbles_by_pipeline, pipeline_dc)

    def _slo_for(self, req: PrefillRequest) -> Optional[float]:
        if req.tier is not None and self.tiers is not None:
            return self.tiers.get(req.tier, self.ttft_slo_ms)
        return self.ttft_slo_ms

    def _tier_of(self, req: PrefillRequest) -> str:
        return req.tier if req.tier is not None else "default"

    def _account(self, req: PrefillRequest, placed: bool, slo_reject: bool,
                 ttft: Optional[float]) -> None:
        s = self._tier_stats.setdefault(
            self._tier_of(req),
            {"offered": 0, "placed": 0, "rejected_slo": 0, "ttfts": []},
        )
        s["offered"] += 1
        if placed:
            s["placed"] += 1
            s["ttfts"].append(ttft)
        elif slo_reject:
            s["rejected_slo"] += 1

    def submit(self, req: PrefillRequest) -> Optional[Placement]:
        """Place a prefill (first-fit over pipelines' live windows) or
        reject (capacity or TTFT SLO)."""
        assert req.arrival_ms >= self._last_arrival, (
            "requests must be submitted in arrival order"
        )
        self._last_arrival = req.arrival_ms
        t0 = self._clock() if self._clock is not None else None
        need = self.lat.prefill_ms(req.prompt_tokens, self.pp) + self.guard
        # earliest feasible placement per pipeline (windows sorted: the
        # first window that fits gives that pipeline's earliest start)
        cands: List[Tuple[float, int, int]] = []  # (start, pipe, idx)
        for pi, wins in enumerate(self.windows):
            lo = self._live[pi]
            while lo < len(wins) and wins[lo].end <= req.arrival_ms + 1e-9:
                lo += 1  # dead: ended before this (and every later) arrival
            self._live[pi] = lo
            for wi in range(lo, len(wins)):
                w = wins[wi]
                start = max(w.start, req.arrival_ms)
                if w.end - start >= need:
                    cands.append((start, pi, wi))
                    break  # windows sorted; first feasible is earliest here
        if t0 is not None:
            self.search_time_us.append((self._clock() - t0) * 1e6)
        if not cands:
            self.rejected.append(req.req_id)
            self._account(req, False, False, None)
            if self._tracing:
                self.tracer.instant(
                    "reject_capacity", obs.CAT_PREFILL, "prefill",
                    "admission", req.arrival_ms,
                    req_id=req.req_id, tier=self._tier_of(req),
                )
            return None
        slo = self._slo_for(req)
        chosen: Optional[Tuple[float, int, int, float, float, Optional[KVQuote]]] = None
        for start, pi, wi in sorted(cands):
            queue = start - req.arrival_ms
            quote: Optional[KVQuote] = None
            if self.kv is not None:
                src = (self.pipeline_dc[pi]
                       if self.pipeline_dc is not None else None)
                ready = start + (need - self.guard)
                quote = self.kv.price(req.prompt_tokens, src, ready)
                ttft = (BASE_OVERHEAD_MS + queue
                        + self.lat.prefill_ms(req.prompt_tokens, self.pp)
                        + quote.kv_ms)
            else:
                ttft = self.lat.ttft_ms(req.prompt_tokens, self.pp,
                                        queue_ms=queue)
            # an infinite quote (permanently saturated KV channel) is an
            # SLO-class rejection even for untiered requests
            if math.isfinite(ttft) and (slo is None or ttft <= slo):
                chosen = (start, pi, wi, queue, ttft, quote)
                break
            # earliest start already blows the SLO through queueing alone
            # only when later starts must too — but KV cost varies by
            # pipeline DC, so keep scanning in start order
        if chosen is None:
            self.rejected.append(req.req_id)
            self.rejected_slo.append(req.req_id)
            self._account(req, False, True, None)
            if self._tracing:
                self.tracer.instant(
                    "reject_slo", obs.CAT_PREFILL, "prefill",
                    "admission", req.arrival_ms,
                    req_id=req.req_id, tier=self._tier_of(req),
                )
            return None
        start, pi, wi, queue, ttft, quote = chosen
        if quote is not None:
            self.kv.commit(quote)
        w = self.windows[pi][wi]
        dur = need - self.guard
        # split the window; fragments under guard_ms can never host a
        # future placement (need > guard always) — drop them instead of
        # leaving them for first-fit to rescan forever
        new = []
        if start - w.start > self.guard:
            new.append(_Window(w.start, start))
        if w.end - (start + need) > self.guard:
            new.append(_Window(start + need, w.end))
        self.windows[pi][wi : wi + 1] = new
        p = Placement(req.req_id, pi, start, dur, ttft, queue,
                      tier=req.tier, kv_ms=quote.kv_ms if quote else 0.0,
                      src_dc=quote.src_dc if quote else None)
        self.placements.append(p)
        self._account(req, True, False, ttft)
        if self._tracing:
            self.tracer.span(
                "prefill", obs.CAT_PREFILL, "prefill", f"pipe{pi}",
                start, start + dur,
                req_id=req.req_id, tier=self._tier_of(req),
                ttft_ms=ttft, queue_ms=queue, kv_ms=p.kv_ms, src_dc=p.src_dc,
            )
            if quote is not None and quote.payload is not None:
                self.tracer.instant(
                    "kv_handoff", obs.CAT_PREFILL, "prefill",
                    "kv", start + dur,
                    req_id=req.req_id, tier=self._tier_of(req),
                    src_dc=quote.src_dc, kv_ms=quote.kv_ms,
                )
        return p

    # -- reporting ---------------------------------------------------------

    def acceptance_rate(self) -> float:
        n = len(self.placements) + len(self.rejected)
        return len(self.placements) / n if n else 0.0

    def slo_rejection_rate(self) -> float:
        n = len(self.placements) + len(self.rejected)
        return len(self.rejected_slo) / n if n else 0.0

    def tier_report(self) -> Dict[str, Dict[str, float]]:
        """Per-tier acceptance and TTFT percentiles (untiered requests
        report under ``"default"``)."""
        out: Dict[str, Dict[str, float]] = {}
        for tier, s in sorted(self._tier_stats.items()):
            ttfts = sorted(s["ttfts"])
            rep = {
                "offered": s["offered"],
                "placed": s["placed"],
                "rejected_slo": s["rejected_slo"],
                "acceptance": s["placed"] / s["offered"] if s["offered"] else 0.0,
            }
            for pc in (50, 95, 99):
                # unit-suffixed key (PR-8 grammar): these are millisecond
                # percentiles, the schema registry enforces the name
                rep[f"ttft_p{pc}_ms"] = _pctl(ttfts, pc / 100.0)
            out[tier] = rep
        return out

    def prefill_busy_ms(self) -> float:
        """End-to-end prefill service time (window occupancy per pipeline)."""
        return sum(p.duration_ms for p in self.placements)

    def prefill_gpu_busy_ms(self) -> float:
        """Aggregate *GPU* busy time the placed prefills add, summed over
        the ``pp`` member stages — the Fig-13 utilization numerator."""
        return sum(
            prefill_stage_busy_ms(p.duration_ms, self.pp) * self.pp
            for p in self.placements
        )


def _pctl(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending list (0.0 when empty)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[i]


def prefill_stage_busy_ms(duration_ms: float, pp_degree: int) -> float:
    """Busy time of *one* stage during a PP-sharded prefill.

    A PP=p prefill occupies the pipeline's window for ``duration_ms``,
    but each of the p stages computes only its own pipeline wave —
    roughly 1/p of the work plus its activation hop — and idles while
    the wave is elsewhere.  Counting the full duration per stage (the
    pre-fix accounting) multiplied the busy time p×, pushing the Fig-13
    utilization past what the bubbles can physically absorb."""
    if pp_degree <= 1:
        return duration_ms
    return min(duration_ms, duration_ms / pp_degree + PIPE_HOP_MS)


def utilization_with_prefills(
    sim_busy_ms: float,
    total_gpu_ms: float,
    controller: BubbleTeaController,
) -> float:
    """GPU utilization after BubbleTea fills bubbles (paper Fig 13).

    The prefill contribution is per-stage pipeline-wave busy time
    (``prefill_stage_busy_ms``) summed over the ``pp`` member stages —
    *not* ``duration × pp``: a PP-sharded prefill reserves every stage's
    window but keeps each stage busy only for its own wave."""
    if total_gpu_ms <= 0.0:
        return 0.0  # zero-length window (e.g. a horizon epoch closed
        # before its first iteration) — no time to be utilized in
    extra = controller.prefill_gpu_busy_ms()
    return min(1.0, (sim_busy_ms + extra) / total_gpu_ms)


def intersect_bubbles(
    bubble_lists: Sequence[Sequence[Tuple[float, float]]],
) -> List[Tuple[float, float]]:
    """Common idle windows across the GPUs forming one inference pipeline."""
    if not bubble_lists:
        return []
    cur = list(bubble_lists[0])
    for nxt in bubble_lists[1:]:
        out = []
        i = j = 0
        nxt = list(nxt)
        while i < len(cur) and j < len(nxt):
            a0, a1 = cur[i]
            b0, b1 = nxt[j]
            lo, hi = max(a0, b0), min(a1, b1)
            if hi > lo:
                out.append((lo, hi))
            if a1 < b1:
                i += 1
            else:
                j += 1
        cur = out
    return cur
