"""Core AME-PIM layer: the paper's contribution, ported to PyTorch.

Layers:
  isa      — AME + Aquabolt-XL PIM instruction sets, Table-1 mapping
  pim      — strict lock-step interpreter of one pseudo-channel
  pep      — the four PEP microkernels + tile memory layout (§3.2)
  cost     — calibrated cycle model (59.4 FLOP/cycle mfmacc headline, §4)
  engine   — AMEEngine: AME architectural state, pointer table, fast
             order-exact execution for ONE pseudo-channel (the leaf
             executor; multi-channel execution lives in the runtime)

Port of ``repro/core``: ``isa``, ``pim``, ``pep`` and ``cost`` are numpy and
Python, copied; the engine's numerics are torch ops on its device.
"""
from repro_torch.core.isa import (
    AMECSRState,
    AMEOp,
    AME_TO_PIM,
    PIMInstr,
    PIMOpcode,
    ROWNUM,
    TILE_MAX_COLS,
    THEORETICAL_PEAK_FLOP_PER_CYCLE,
    UnsupportedOnPIM,
)
from repro_torch.core.engine import (
    AMEEngine,
    InstrRecord,
    ShardSpan,
    TileHandle,
    ew_on_engine,
    ew_on_engine_batched,
    ew_tiles,
    gemm_on_engine,
    gemm_on_engine_batched,
    gemm_tiles,
)
from repro_torch.core.cost import (
    PEPCostReport,
    elementwise_cost,
    ew_shard_cost,
    gemm_shard_cost,
    max_tile_mfmacc,
    mfmacc_cost,
    saturated_flop_per_cycle,
)

__all__ = [
    "AMECSRState", "AMEOp", "AME_TO_PIM", "PIMInstr", "PIMOpcode",
    "ROWNUM", "TILE_MAX_COLS", "THEORETICAL_PEAK_FLOP_PER_CYCLE",
    "UnsupportedOnPIM", "AMEEngine", "InstrRecord", "ShardSpan",
    "TileHandle", "ew_on_engine", "ew_on_engine_batched", "ew_tiles",
    "gemm_on_engine", "gemm_on_engine_batched", "gemm_tiles",
    "PEPCostReport", "elementwise_cost", "ew_shard_cost", "gemm_shard_cost",
    "max_tile_mfmacc", "mfmacc_cost", "saturated_flop_per_cycle",
]
