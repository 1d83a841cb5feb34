"""Dispatch between the hand-written kernels and their plain versions.

Port of ``repro/kernels/ops.py``.  ``use_kernel`` takes the place of
``use_pallas``.  A CPU tensor always takes the plain version; a CUDA
tensor with ``use_kernel=True`` launches the kernel, or the call raises.
There is no fallback from a failed build or launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ame_gemm import ame_gemm


def gemm(a: torch.Tensor, b: torch.Tensor, *, use_kernel: bool = False,
         out_dtype: Optional[torch.dtype] = None, **blocks) -> torch.Tensor:
    """C = A @ B via the output-stationary kernel or its plain version."""
    if use_kernel and a.is_cuda:
        return ame_gemm(a, b, out_dtype=out_dtype, **blocks)
    return ref.gemm(a, b, out_dtype=out_dtype)
