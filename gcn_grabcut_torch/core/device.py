"""Device selection for the port's public entry points.

Entry points run on the card by default.  Without CUDA they raise unless
the caller asked for the CPU explicitly (``device="cpu"``): there is no
silent CPU fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:   # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
