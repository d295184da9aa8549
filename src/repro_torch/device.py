"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Asking for ``cuda`` (explicitly or by default) on a
    machine without a card raises: the port never falls back to the CPU
    on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' (--device cpu) to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:     # so it compares equal to tensor.device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
