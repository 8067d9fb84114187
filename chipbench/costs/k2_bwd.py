"""The work of one call of K2's backward (causal flash attention's gradients,
``kernels/flash_attention.py``, ``csrc/flash_attention_bwd.cu``), frozen here
from the program's ``bwd_cost`` without its row-sum workspace: what the
mathematics needs, whatever kernels compute it.

Bytes: q, k, v, o and dO read and dq, dk, dv written, once each, in the
activations' dtype; the forward's log-sum-exp (B, H, T) f32 read.
Operations: five products of 2 D operations a (query, key) pair that causal
attention keeps (S and dP, dV, dS to dQ and to dK), at the bf16 rate."""
from chipbench.costs.peaks import bound_s

KERNELS = ["flash_bwd_rowsum_kernel", "flash_bwd_wg_dkdv_kernel", "flash_bwd_wg_dq_kernel"]
CALL = "flash_bwd_wg_dq_kernel"  # launched once a call


def causal_pairs(T: int) -> int:
    return T * (T + 1) // 2


def work(B: int, T: int, H: int, D: int, itemsize: int = 2) -> tuple:
    """(bytes, operations) of one call on q, k, v (B, T, H, D), causal."""
    nbytes = 8 * B * T * H * D * itemsize + B * H * T * 4
    flops = 5 * 2 * D * B * H * causal_pairs(T)
    return nbytes, flops


def bound(B: int, T: int, H: int, D: int) -> tuple:
    return bound_s(*work(B, T, H, D))
