"""Parallelism across ranks: the placement plan, the counted transport and the cross-pod pipeline."""
