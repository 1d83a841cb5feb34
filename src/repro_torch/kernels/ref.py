"""Plain PyTorch versions of the ported kernels (the correctness references).

Each function is the semantic specification its Hopper kernel is held
against on the card, and what a wrapper computes for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch


def gemm(a: torch.Tensor, b: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B with f32 accumulation, cast once to ``out_dtype``
    (default ``a.dtype``) — the ``ame_gemm`` oracle."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)
