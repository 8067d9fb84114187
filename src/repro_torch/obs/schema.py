"""Registry of every engine-emitted stats key, with units.

``SimResult.stats``, ``HorizonResult.stats`` and ``FleetResult.stats``
are the public accounting surface of the simulator; their key names
follow the units-suffix grammar enforced by ``repro.analysis``
(quantities carry their unit as a ``_ms`` / ``_bits`` / ``_gbps`` /
``_samples`` suffix, counts and fractions carry none).  This module
makes that contract explicit and testable:

* :data:`REGISTRY` — one :class:`StatKey` per known key path, per
  domain (``sim`` / ``horizon`` / ``fleet``).  Dotted paths address
  nesting; a ``*`` segment matches any map key (per-job, per-tier).
* :func:`conformance_errors` — the registry audits *itself*: a key
  registered with unit ``ms`` must end in ``_ms``, a count must *not*
  end in any unit suffix.
* :func:`unregistered_keys` — audits a live stats dict: every key an
  engine actually emitted must be registered (the test suite runs every
  engine and asserts this is empty, so adding a stats key without
  registering its unit fails CI).

The registry describes *names*, not values — value invariants live in
``repro_torch.core.validate``.

The port's own copy of ``repro/obs/schema.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Tuple

#: units that must appear as a ``_<unit>`` suffix on the key's last
#: path segment (or be the entire segment, e.g. ``samples``)
SUFFIX_UNITS = ("ms", "bits", "bytes", "gbps", "samples", "hours")

#: units carrying no suffix requirement — but the name must not *end*
#: in one of the suffix units either (a count named ``foo_ms`` lies)
BARE_UNITS = ("count", "frac", "bool", "str", "enum", "dict", "tuple")


@dataclasses.dataclass(frozen=True)
class StatKey:
    """One registered stats key: its dotted path, unit and meaning."""

    path: str
    unit: str
    description: str

    def __post_init__(self):
        assert self.unit in SUFFIX_UNITS + BARE_UNITS, self.unit


def _k(path: str, unit: str, description: str) -> Tuple[str, StatKey]:
    return path, StatKey(path, unit, description)


#: ``simulate`` — one iteration of one job (``SimResult.stats``)
SIM_STATS: Dict[str, StatKey] = dict([
    _k("engine", "str", "which engine ran (events / atlas / …)"),
    _k("events", "count", "event-heap pops (engine work measure)"),
    _k("fast_forward", "bool", "whether steady-state extrapolation ran"),
    _k("fast_forward_gate", "str", "why fast-forward was gated off"),
    _k("period", "count", "microbatch period K the extrapolation locked"),
    _k("probe_attempts", "count", "fast-forward probe simulations"),
    _k("probe_microbatches", "tuple", "(m1, m2) probe truncation sizes"),
    _k("extrapolated_microbatches", "count", "microbatches synthesized"),
    _k("replicated_pipelines", "count", "replica factor of the baseline path"),
    _k("wan_bits", "dict", "per directed DC pair: bits per iteration"),
])

#: ``HorizonRunner`` / ``simulate_horizon`` (``HorizonResult.stats``)
HORIZON_STATS: Dict[str, StatKey] = dict([
    _k("iter_sims", "count", "iterations priced by a fresh simulation"),
    _k("iter_reused", "count", "iterations reusing a cached simulation"),
    _k("drift_iterations", "count", "iterations with deviation above threshold"),
    _k("drift_fires", "count", "detector fires (hysteresis satisfied)"),
    _k("replans_declined", "count", "re-plans rejected (infeasible / no gain)"),
    _k("replans_noop", "count", "re-plans that kept the deployment"),
    _k("replans_suppressed", "count", "fires suppressed by the cascade guard"),
    _k("replans_forced", "count", "forced failovers (outage / preemption)"),
    _k("fast_forward_gates", "dict", "per gate reason: iterations gated"),
])

#: ``simulate_fleet`` (``FleetResult.stats``)
FLEET_STATS: Dict[str, StatKey] = dict([
    _k("sharing", "enum", "channel sharing mode (temporal / fair)"),
    _k("generations", "count", "demand-segment openings (epoch starts)"),
    _k("cascade_replans_max", "count", "cascade budget (config echo)"),
    _k("cascade_epochs", "count", "cascade epochs closed"),
    _k("cascade_suppressed", "count", "drift fires suppressed fleet-wide"),
    _k("admission_wait_ms", "ms", "total migration admission-barrier wait"),
    _k("floor_grants", "count", "windows priced at the grant floor"),
    _k("demand_probe_sims", "count", "uncontended demand-probe simulations"),
    _k("replans_total", "count", "migrations across all jobs"),
    _k("per_job.*.throttled_iterations", "count", "windows below full rate"),
    _k("per_job.*.throttled_ms", "ms", "wall time spent throttled"),
    _k("per_job.*.total_ms", "ms", "job wall time to sample budget"),
    _k("per_job.*.samples", "samples", "samples the job completed"),
    _k("per_job.*.replans", "count", "migrations this job executed"),
    _k("per_job.*.migration_ms", "ms", "total migration stall"),
    _k("per_job.*.replans_suppressed", "count", "suppressed fires (this job)"),
    _k("prefill.requests_offered", "count", "arrivals inside the horizon"),
    _k("prefill.requests_total", "count", "arrivals in the full trace"),
    _k("prefill.placed", "count", "prefills placed into bubbles"),
    _k("prefill.rejected", "count", "prefills rejected (any reason)"),
    _k("prefill.rejected_slo", "count", "prefills rejected on TTFT SLO"),
    _k("prefill.acceptance", "frac", "placed / offered"),
    _k("prefill.per_tier.*.offered", "count", "tier arrivals offered"),
    _k("prefill.per_tier.*.placed", "count", "tier arrivals placed"),
    _k("prefill.per_tier.*.rejected_slo", "count", "tier SLO rejections"),
    _k("prefill.per_tier.*.acceptance", "frac", "tier placed / offered"),
    _k("prefill.per_tier.*.ttft_p50_ms", "ms", "tier TTFT median"),
    _k("prefill.per_tier.*.ttft_p95_ms", "ms", "tier TTFT p95"),
    _k("prefill.per_tier.*.ttft_p99_ms", "ms", "tier TTFT p99"),
    _k("prefill.prefill_gpu_busy_ms", "ms", "GPU busy time prefills added"),
    _k("prefill.kv_wan_transfers", "count", "KV handoffs over the WAN"),
    _k("prefill.kv_local_transfers", "count", "KV handoffs over NVLink"),
    _k("prefill.kv_wan_bits", "bits", "KV bits shipped over the WAN"),
    _k("prefill.kv_reservations", "count", "KV ledger segments recorded"),
    _k("prefill.host_gpu_ms", "ms", "host GPU-time denominator"),
    _k("prefill.utilization_train", "frac", "training-only utilization"),
    _k("prefill.utilization_with_prefills", "frac", "Fig-13 utilization"),
])

REGISTRY: Dict[str, Dict[str, StatKey]] = {
    "sim": SIM_STATS,
    "horizon": HORIZON_STATS,
    "fleet": FLEET_STATS,
}


def _segment_conforms(segment: str, unit: str) -> bool:
    if unit in SUFFIX_UNITS:
        return segment == unit or segment.endswith(f"_{unit}")
    if unit == "dict":
        # a map may carry its *value* unit as suffix (wan_bits: pair->bits)
        return True
    # other bare units must not carry a misleading quantity suffix
    return not any(
        segment == u or segment.endswith(f"_{u}") for u in SUFFIX_UNITS
    )


def conformance_errors() -> List[str]:
    """Units-suffix violations *inside the registry itself* (empty when
    every registered name matches its declared unit)."""
    errors = []
    for domain, reg in sorted(REGISTRY.items()):
        for path, key in sorted(reg.items()):
            seg = path.rsplit(".", 1)[-1]
            if not _segment_conforms(seg, key.unit):
                errors.append(
                    f"{domain}:{path}: name does not conform to unit "
                    f"{key.unit!r}"
                )
    return errors


def unregistered_keys(stats: Mapping, domain: str) -> List[str]:
    """Key paths present in a live ``stats`` dict but absent from the
    ``domain`` registry.  A path matches its exact registration or a
    ``*``-wildcarded one (map keys); registered ``dict``-unit keys are
    opaque leaves (their keys are data — pair tuples, gate names — not
    schema)."""
    reg = REGISTRY[domain]
    missing: List[str] = []

    def lookup(path: str):
        if path in reg:
            return reg[path]
        parts = path.split(".")
        for i in range(len(parts)):
            wc = parts[:i] + ["*"] + parts[i + 1:]
            cand = ".".join(wc)
            if cand in reg:
                return reg[cand]
        return None

    def walk(node, prefix: str) -> None:
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            key = lookup(path)
            if key is None:
                if isinstance(v, Mapping):
                    walk(v, path)  # maybe only the children are registered
                    continue
                missing.append(path)
                continue
            if key.unit != "dict" and isinstance(v, Mapping):
                walk(v, path)

    walk(stats, "")
    # a dict whose children all failed reports each child; dedupe any
    # parent that is itself unregistered and non-mapping
    return sorted(set(missing))
