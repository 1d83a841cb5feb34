"""Where the port's entry points run: the card unless the caller asks for
another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` (the current CUDA device) by default; raises if a CUDA
    device is asked for and there is none (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
