"""Sanctioned unit-conversion helpers — the only place conversion
arithmetic is allowed to live.

Every quantity in the simulator carries its unit in its identifier
suffix (``_ms``, ``_s``, ``_bytes``, ``_bits``, ``_gbps``, ...;
see ROADMAP "Static analysis").  Crossing between units requires the
constants 8 (bits per byte), 1e6 (bits/ms per Gbit/s) and 1e9
(bits/s per Gbit/s) — exactly the factors that silently go missing in
WAN cost models.  ``repro.analysis`` forbids those constants next to a
dimensioned operand anywhere in ``repro_torch.core`` *except* inside this
module (rule ``units/inline-conversion``), so a conversion either goes
through a helper below or trips the lint.

Numerical note: each helper preserves the exact floating-point
operation order of the inline expression it replaced, so extracting
the arithmetic is bit-identical — the differential tests against the
frozen ``reference`` engine still compare equal, not merely close.

The port's own copy of ``repro/units.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
from __future__ import annotations

BITS_PER_BYTE = 8.0
#: 1 Gbit/s delivers 1e6 bits per millisecond.
BITS_PER_MS_PER_GBPS = 1e6
#: 1 Gbit/s delivers 1e9 bits per second.
BITS_PER_S_PER_GBPS = 1e9
MS_PER_S = 1e3
MS_PER_HOUR = 3.6e6


def bytes_to_bits(nbytes: float) -> float:
    """Payload size in bits."""
    return nbytes * 8.0


def bits_to_bytes(bits: float) -> float:
    """Payload size in bytes."""
    return bits / 8.0


def gb_to_bytes(size_gb: float) -> float:
    """Decimal gigabytes (1 GB = 1e9 bytes) to bytes."""
    return size_gb * 1e9


def serialization_ms(nbytes: float, bw_gbps: float) -> float:
    """Wire time of ``nbytes`` at ``bw_gbps`` (no propagation latency).

    The canonical ``bytes -> ms`` conversion: x8 for bits, /1e9 for
    seconds at Gbit/s, x1e3 for milliseconds.
    """
    return (nbytes * 8.0) / (bw_gbps * 1e9) * 1e3


def bits_serialization_ms(bits: float, bw_gbps: float) -> float:
    """Wire time of ``bits`` at ``bw_gbps``."""
    return bits / (bw_gbps * 1e9) * 1e3


def serialization_ms_gbytes(nbytes: float, bw_gbytes_per_s: float) -> float:
    """Wire time of ``nbytes`` over a byte-rated local link (GB/s, as
    NVLink/PCIe are quoted) — no x8, the rate is already in bytes."""
    return nbytes / (bw_gbytes_per_s * 1e9) * 1e3


def window_bits(duration_ms: float, bw_gbps: float, rate_mult: float = 1.0) -> float:
    """Link capacity over a window: bits deliverable in ``duration_ms``
    at ``bw_gbps`` (optionally scaled by a contention multiplier)."""
    if rate_mult == 1.0:
        return duration_ms * bw_gbps * 1e6
    return duration_ms * bw_gbps * rate_mult * 1e6


def bits_rate_gbps(bits: float, duration_ms: float) -> float:
    """Mean rate, in Gbit/s, that moves ``bits`` in ``duration_ms``."""
    return bits / duration_ms / 1e6
