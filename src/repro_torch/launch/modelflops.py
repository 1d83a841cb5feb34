"""Analytic MODEL_FLOPS per cell (port of ``repro.launch.modelflops``):
6*N*D train / 2*N*D inference, with N_active for MoE — the roofline's
'useful compute' yardstick."""
from __future__ import annotations

import math

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.params import param_shapes
from repro_torch.optim.adamw import tree_leaves


def active_params(cfg: ArchConfig) -> int:
    """Non-embedding parameters, with routed experts scaled by top_k/E."""
    total = 0
    for pstr, leaf in tree_leaves(param_shapes(cfg)):
        n = math.prod(leaf.shape)
        if "embed/table" in pstr or "head/w" in pstr:
            continue
        if cfg.moe and "experts/" in pstr:
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return total


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Whole-step useful FLOPs (all ranks)."""
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch        # decode: one token per seq
