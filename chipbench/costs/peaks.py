"""One NVIDIA H100 SXM's published dense peaks at its full 700 W limit (the
H100 data sheet): the yardstick every roofline and MFU of the benchmark
divides by, whatever the card's own power limit (the runs print it beside)."""
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def bound_s(nbytes: float, flops: float) -> tuple:
    """(the least seconds for the work, what binds it: "bytes" or "operations")."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
