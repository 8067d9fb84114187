"""The reference's five examples (``examples/``) as the port's own: each runs
as ``python -m repro_torch.examples.<name>`` and on the card unless the CPU is
asked for (``device="cpu"`` / ``--device cpu``).  Their A100 and "paper"
figures are the simulator's model of the paper's testbed, never this card's."""
