"""Cycle-cost model for PEP execution on Aquabolt-XL (paper §4).

Two models, both analytic:

* **ISA model** — cycles = DRAM column commands issued (each command retires
  one PIM instruction step; JUMPs are zero-cycle, paper §2.3.3).  This is the
  upper bound implied purely by the instruction mix of Listing 1.

* **Bus-calibrated model** — the paper measures from the bus side of the
  FPGA PIM_kernel and reports 59.4 FLOP/cycle for mfmacc at 128x4096 tiles
  (14.9 GFLOP/s at 250 MHz).  The MAC-PEP pass is 26 commands for 2048
  useful FLOP per pseudo-channel => the ISA model would give 78.8
  FLOP/cycle; the measurement implies ~34.5 effective cycles per pass.  We
  model the gap as a per-pass overhead ``eta`` (even<->odd bank turnaround +
  command-stream gaps observed from the bus), calibrated once:

      2048 / (26 + eta) = 59.4  =>  eta ~= 8.5

  and applied uniformly to all PEPs ("largely uniform execution latency
  across PEP types", paper §4.2).

Setup costs: CRF programming + mode transitions per AME instruction
(SETUP_CRF) and per-PEP-launch re-trigger/row-activate (SETUP_INVOKE);
chosen such that setup is <1% of runtime at max tile size (paper §4.2) and
dominates at small tiles (paper Fig 9).

These costs are the single source of per-op busy time for *both*
execution models of the runtime scheduler: the serialized barrier-per-op
mode and the async dependency-aware timeline
(the runtime's timeline module) consume identical per-channel cycle
charges — the timeline only decides *when* each busy interval starts
(``max(dep retire, channel free, link free)``), never what it costs, so
start/retire times inherit the calibration unchanged.  The setup-
dominated small-tile regime (Fig 9) is also why the async decode DAG
wins: decode-shaped matmuls pay launch floors per channel, so running
independent ops on disjoint channel groups removes serialized floors
without inflating per-op work.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.isa import (
    AAM_BLOCKS,
    JUMP_MAX_ITERS,
    PIM_FREQ_HZ,
    ROWNUM,
    THEORETICAL_PEAK_FLOP_PER_CYCLE,
    TILE_MAX_COLS,
)
from repro_torch.core.pep import (
    COMMANDS_PER_PASS,
    FLOPS_PER_PASS,
    SUB_PROLOGUE_COMMANDS,
    ew_invocations,
    mac_invocations,
)

#: calibrated per-pass bus overhead (cycles) — see module docstring
ETA_BUS = 8.5
#: one-time cost per AME instruction: CRF broadcast-program + mode transitions
SETUP_CRF = 128
#: per PEP launch: AB-PIM re-trigger + row activation
SETUP_INVOKE = 64


@dataclasses.dataclass(frozen=True)
class PEPCostReport:
    """Cost of one AME instruction executed via PEP launches."""

    kind: str
    launches: int
    passes: int
    commands: int          # ISA-model cycles (column commands)
    cycles: float          # bus-calibrated cycles incl. setup
    flops: int             # useful FLOPs (paper counts MAC as 2)

    @property
    def flop_per_cycle(self) -> float:
        return self.flops / self.cycles

    @property
    def flop_per_cycle_isa(self) -> float:
        return self.flops / self.commands

    @property
    def gflops(self) -> float:
        return self.flop_per_cycle * PIM_FREQ_HZ / 1e9

    @property
    def seconds(self) -> float:
        return self.cycles / PIM_FREQ_HZ


def _report(kind: str, launches: int, passes: int, flops: int,
            extra_cmds: int = 0, eta: float = ETA_BUS) -> PEPCostReport:
    cmds = passes * COMMANDS_PER_PASS[kind] + extra_cmds
    cycles = (cmds + passes * eta
              + launches * SETUP_INVOKE + SETUP_CRF)
    return PEPCostReport(kind=kind, launches=launches, passes=passes,
                         commands=cmds, cycles=cycles, flops=flops)


def elementwise_cost(kind: str, m: int, c: int, eta: float = ETA_BUS) -> PEPCostReport:
    """mfadd/mfmul/mfsub on an (m x c) tile pair.

    Rows < 128 waste SIMD lanes (parallel width is fixed, paper §3.2.3):
    commands do not shrink with m, only useful FLOPs do.
    """
    assert kind in ("add", "mul", "sub")
    launches = ew_invocations(c)
    passes = sum(p for _, p in launches)
    flops = m * c  # one FLOP per element
    extra = SUB_PROLOGUE_COMMANDS * len(launches) if kind == "sub" else 0
    return _report(kind, len(launches), passes, flops, extra_cmds=extra,
                   eta=eta)


def mfmacc_cost(m: int, k: int, n: int, eta: float = ETA_BUS) -> PEPCostReport:
    """mfmacc: acc(m x n) += A(m x k) @ B(k x n); m <= 128 rows in lock-step."""
    invs = mac_invocations(k, n)
    passes = sum(i.passes for i in invs)
    flops = 2 * m * k * n
    return _report("mac", len(invs), passes, flops, eta=eta)


# ---------------------------------------------------------------------------
# Closed-form whole-shard costs (the analytic fast path)
#
# The runtime's blocked walk tiles a shard (rows, ks, ns) into <=128 x 4096
# (x <=128) engine tiles; each axis takes at most TWO distinct tile sizes
# (the full block and one ragged edge), so the whole walk collapses to <=8
# tile classes.  Per class the per-tile cost is computed once and scaled by
# the class count — O(1) per shard instead of O(#tiles).
#
# Exactness: every per-tile ``cycles`` is a multiple of 0.5 (commands and
# setup are integers, passes * ETA_BUS a half-integer), so count * cycles
# and the class sums are exact in binary floating point — the closed form
# equals the generator walk's running sum bit-for-bit, which the test
# suite asserts with ``==`` across ragged shapes.
# ---------------------------------------------------------------------------


def _axis_classes(size: int, block: int):
    """Tile sizes along one blocked axis as [(tile_size, count)] — the full
    block plus at most one ragged edge."""
    full, rem = divmod(size, block)
    out = []
    if full:
        out.append((block, full))
    if rem:
        out.append((rem, 1))
    return out


def _scale(rep: PEPCostReport, count: int) -> PEPCostReport:
    return PEPCostReport(kind=rep.kind, launches=rep.launches * count,
                         passes=rep.passes * count,
                         commands=rep.commands * count,
                         cycles=rep.cycles * count, flops=rep.flops * count)


def _merge(kind: str, parts) -> PEPCostReport:
    return PEPCostReport(kind=kind,
                         launches=sum(p.launches for p in parts),
                         passes=sum(p.passes for p in parts),
                         commands=sum(p.commands for p in parts),
                         cycles=sum(p.cycles for p in parts),
                         flops=sum(p.flops for p in parts))


def gemm_shard_cost(rows: int, ks: int, ns: int,
                    eta: float = ETA_BUS) -> PEPCostReport:
    """Total cost of the blocked-GEMM walk over a (rows, ks, ns) shard.

    Equals ``sum(mfmacc_cost(tile) for tile in gemm_tiles(rows, ks, ns))``
    exactly, without walking the tiles.
    """
    parts = []
    for msz, mc in _axis_classes(rows, ROWNUM):
        for ksz, kc in _axis_classes(ks, TILE_MAX_COLS):
            for nsz, nc in _axis_classes(ns, ROWNUM):
                parts.append(_scale(mfmacc_cost(msz, ksz, nsz, eta=eta),
                                    mc * kc * nc))
    return _merge("mac", parts)


def ew_shard_cost(kind: str, rows: int, cols: int,
                  eta: float = ETA_BUS) -> PEPCostReport:
    """Total cost of the blocked element-wise walk over a (rows, cols)
    shard; equals the per-tile sum over ``ew_tiles(rows, cols)`` exactly."""
    parts = []
    for msz, mc in _axis_classes(rows, ROWNUM):
        for csz, cc in _axis_classes(cols, TILE_MAX_COLS):
            parts.append(_scale(elementwise_cost(kind, msz, csz, eta=eta),
                                mc * cc))
    return _merge(kind, parts)


def max_tile_mfmacc() -> PEPCostReport:
    """The paper's headline point: 128x4096 tiles => C(128x128) += A @ B."""
    return mfmacc_cost(128, 4096, 128)


def saturated_flop_per_cycle(kind: str) -> float:
    """Asymptotic FLOP/cycle of a PEP (ignoring setup) — Fig 9's plateau."""
    per_pass = COMMANDS_PER_PASS[kind] + ETA_BUS
    return FLOPS_PER_PASS[kind] / per_pass


def summary() -> Dict[str, float]:
    """Key calibration numbers, checked against the paper in benchmarks."""
    head = max_tile_mfmacc()
    return {
        "mfmacc_flop_per_cycle_saturated": saturated_flop_per_cycle("mac"),
        "mfmacc_flop_per_cycle_maxtile": head.flop_per_cycle,
        "mfmacc_gflops_maxtile": head.gflops,
        "mfmacc_launches_maxtile": head.launches,
        "theoretical_peak": THEORETICAL_PEAK_FLOP_PER_CYCLE,
        "add_flop_per_cycle_saturated": saturated_flop_per_cycle("add"),
        "sub_flop_per_cycle_saturated": saturated_flop_per_cycle("sub"),
        "setup_share_maxtile": (head.launches * SETUP_INVOKE + SETUP_CRF)
        / head.cycles,
    }
