"""PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Same structure and names as the JAX package, which stays the reference; this
package imports ``torch`` and nothing of ``jax`` or ``repro``.  Entry points
run on ``cuda`` unless the caller asks for the CPU (see ``device.py``).
"""
