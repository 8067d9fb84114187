"""Checkpoints of the train state, in the reference's on-disk format (``repro/ckpt``)."""
