"""Gradient compression with error feedback (port of
``repro.optim.compression``).

The compressed sync halves the bytes of a cross-group gradient reduce
(f32 -> bf16) while error feedback keeps the optimizer trajectory
unbiased: the quantization residual of step t is added back into step
t+1's gradient before compression, so errors do not accumulate.

:func:`psum_compressed` is the mean-reduce of the compressed payload over
a process group (the reference's over a ``shard_map`` axis):

    grads, ef = psum_compressed(grads, ef_state, group)

g + ef -> bf16 -> all-reduce (sum) over the group -> f32 / group size,
ef' = (g + ef) - Q.  As in the reference, no training step calls it
(``launch/steps.make_train_step`` does not read
``policy.grad_compression``); it is a function of its own.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

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


def psum_compressed(grads, ef_state, group=None):
    """Compressed mean-reduce of ``grads`` over the process ``group`` (the
    default world): returns ``(mean, new_ef)``, the mean in f32.

    The bf16 payloads are summed by the backend in bf16 (``gloo`` and
    ``nccl`` both reduce bf16); the reference's ``psum`` of bf16 payloads
    lowers on the CPU to an f32 sum rounded once to bf16, so the two means
    may differ by the bf16 roundings of the partial sums."""
    q, ef = compress_tree(grads, ef_state)
    n = dist.get_world_size(group)

    def mean(x):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x.float() / n
    return tree_map(mean, q), ef
