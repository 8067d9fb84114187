"""AdamW with the reference's schedule, clipping and accumulation (``repro/optim``)."""
