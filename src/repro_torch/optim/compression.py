"""Gradient compression with error feedback (port of
``repro.optim.compression``).

The compressed sync halves the bytes of a cross-group gradient reduce
(f32 -> bf16) while error feedback keeps the optimizer trajectory
unbiased: the quantization residual of step t is added back into step
t+1's gradient before compression, so errors do not accumulate.

``psum_compressed``, the mean-reduce of the compressed payload over a
process group, belongs to the mesh half of the training port (ROADMAP
queue 1, item 9) and is not here yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.adamw import tree_map


def init_state(grads_shapes):
    """Error-feedback residual buffer, one bf16 zero tensor per gradient
    leaf (anything with ``shape`` and ``device``)."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.bfloat16,
                                          device=g.device), grads_shapes)


def compress(g: torch.Tensor, ef: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (bf16 payload, new error-feedback residual)."""
    corrected = g.float() + ef.float()
    q = corrected.to(torch.bfloat16)
    new_ef = (corrected - q.float()).to(torch.bfloat16)
    return q, new_ef


def compress_tree(grads, ef_state):
    """:func:`compress` leaf by leaf; returns (payloads, residuals)."""
    pairs = tree_map(compress, grads, ef_state)
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)
