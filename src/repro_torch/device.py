"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device, what: str = "repro_torch") -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``.  Raises
    where CUDA is asked for and absent — the port never falls back to the
    CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the card by default and CUDA is not available "
            "here; pass device='cpu' to run on the CPU")
    return dev
