"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

The tests run on the CPU: inputs are made with numpy from a seed and handed to
both the JAX reference and the port, and the port runs with ``device="cpu"``,
where its kernels' wrappers use their plain PyTorch versions.
"""
import numpy as np
import torch

# the suite runs in several worker processes at once; one thread each
torch.set_num_threads(1)

# f32: both sides compute in f32 and differ by the order of their sums.
# bf16: one rounding of the output to bf16 (relative 2**-8) on top of that.
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def tol(dtype_name: str) -> dict:
    return BF16_TOL if dtype_name == "bfloat16" else F32_TOL


def to_torch(a: np.ndarray, dtype_name: str = "float32") -> torch.Tensor:
    """numpy -> torch, through f32 for bf16 (numpy has no bf16)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype_name == "bfloat16" else t


def to_jax(a: np.ndarray, dtype_name: str = "float32"):
    import jax.numpy as jnp

    return jnp.asarray(a, dtype=jnp.bfloat16) if dtype_name == "bfloat16" else jnp.asarray(a)


def as_f32(x) -> np.ndarray:
    """A torch tensor or a JAX array as an f32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def numpy_tree(tree):
    """A JAX parameter tree as a nested dict of numpy arrays (bf16 as f32, exact)."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def reference_params(ref_cfg, seed: int = 0):
    """(JAX params, the same as a numpy tree) of the reference model for ``ref_cfg``."""
    import jax
    from repro.models.transformer import build_model

    params = build_model(ref_cfg).init(jax.random.PRNGKey(seed))
    return params, numpy_tree(params)
