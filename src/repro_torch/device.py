"""Where an entry point runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(arg: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card, and raises where there is none: the port never
    carries on on the CPU unasked.  ``"cpu"`` is what the tests pass."""
    if arg is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and found none; pass device='cpu' "
                "(--device cpu) to run the plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(arg)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {arg!r} was asked for and there is no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
