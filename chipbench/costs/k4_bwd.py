"""The work of one call of K4's backward (WKV-6's gradients from a zero
state, ``kernels/wkv6.py``, ``csrc/wkv6.cu``, the chunked route), frozen here
from the program's ``bwd_cost`` without the ``S_prev`` workspace.

Bytes: r, k, v and dy read and dr, dk, dv written in the activations' dtype;
the log-decay read and its gradient written in f32; u read and du written.
Operations: the chunked form's tensor-core products at the bf16 rate, per
chunk of 64 steps and warp w of four 756 - 40 w products of 2 x 16 x 8 x 16
operations, and 384 more a chunk but the last for the states.  The bytes
bind it at the benchmark's shapes."""
from chipbench.costs.peaks import bound_s

KERNELS = ["wkv6_bwd_state_kernel", "wkv6_bwd_chunk_kernel", "wkv6_du_kernel"]
CALL = "wkv6_bwd_chunk_kernel"  # launched once a call


def work(B: int, T: int, H: int, D: int, itemsize: int = 2) -> tuple:
    """(bytes, operations) of one call on r, k, v (B, T, H, D)."""
    n = B * T * H * D
    nbytes = 7 * n * itemsize + 2 * n * 4 + 2 * H * D * 4
    chunks = -(-T // 64)
    per_chunk = sum(756 - 40 * w for w in range(4))
    flops = B * H * (chunks * per_chunk + (chunks - 1) * 384) * 2 * 16 * 8 * 16
    return nbytes, flops


def bound(B: int, T: int, H: int, D: int) -> tuple:
    return bound_s(*work(B, T, H, D))
