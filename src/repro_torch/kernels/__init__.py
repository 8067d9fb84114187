"""Hopper kernels written by hand in CUDA C++ (``csrc/``), built by ``build``.

Modules: rmsnorm, flash_attention, decode_attention: each holds the kernel's
wrapper, its plain PyTorch version and a launch counter; ``ref`` re-exports the
plain versions under the reference's names and ``ops`` holds the model-layout
entry points.
"""
