"""AMEEngine — executes AME instructions on the PIM model (paper §3.2/3.3).

Port of ``repro/core/engine.py``.  The engine holds the AME architectural
state (tile registers tr0-tr3, accumulation registers acc0-acc3, the
mtilem/k/n CSRs) and the paper's pointer table: registers are
*memory-resident* handles, and data-movement instructions (load/store/
move/transpose/pack/slide) resolve to pointer/layout updates, not copies
(paper §3.2.6).

Numeric execution uses the fast torch path below, on the engine's device —
vectorized but *order-exact* with the hardware: FP16 rounding after the
multiplier and adder stages, k walked in ascending order per output column,
exactly like the MAC-PEP.  It is cross-validated bit-exactly against the
strict interpreter (:mod:`repro_torch.core.pim`) in the test suite.  Tiles
are float16 tensors; a numpy operand is rounded to FP16 by numpy (directly,
as the reference does), a tensor by ``.to(float16)``.  The executors return
float16 tensors on the engine's device where the reference returns numpy.

Cost accounting uses :mod:`repro_torch.core.cost`; every instruction
returns and accumulates a :class:`PEPCostReport`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cost as cost_mod
from repro_torch.core.isa import (
    AMECSRState,
    AMEOp,
    ROWNUM,
    TILE_MAX_COLS,
    UnsupportedOnPIM,
    pim_mapping,
)
from repro_torch.launch.device import resolve_device

F16 = torch.float16


# ---------------------------------------------------------------------------
# Fast, order-exact numeric semantics
# ---------------------------------------------------------------------------


def _ew_add(a, b):
    return a.to(F16) + b.to(F16)


def _ew_mul(a, b):
    return a.to(F16) * b.to(F16)


def _ew_sub(a, b):
    # emulated: a + (-1)*b, with FP16 rounding after the MUL stage (SUB-PEP)
    nb = b.to(F16) * -1.0
    return a.to(F16) + nb


def _mac_outer(acc, a, b):
    """acc(m,n) += A(m,k) @ B(k,n), FP16, ascending-k outer products.

    One step == one MAC instruction's effect across all columns: the MAC
    is a fused multiply-accumulate (paper §2.3.1), so the product+add round
    *once* at register writeback — modeled as exact f32 arithmetic (the
    product of two FP16 values is exact in f32) rounded to FP16 per k-step.
    Bit-exact with the strict interpreter.
    """
    a = a.to(F16).float()
    b = b.to(F16).float()
    out = acc.to(F16)
    for kk in range(a.shape[1]):
        out = (out.float() + a[:, kk, None] * b[None, kk, :]).to(F16)
    return out


# ---------------------------------------------------------------------------
# Memory-resident register handles + pointer table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TileHandle:
    """A tile/accumulator register: pointer-table entry + layout metadata.

    ``data`` is the logical (rows, cols) array; ``transposed`` marks a
    pending zero-copy transpose (mld.t / mmov.t) that downstream consumers
    fold into their access pattern; ``row_off``/``col_off`` implement slide
    and pack as view updates.
    """

    data: torch.Tensor
    transposed: bool = False
    row_off: int = 0
    col_off: int = 0

    def resolve(self) -> torch.Tensor:
        d = self.data
        if self.transposed:
            d = d.T
        if self.row_off or self.col_off:
            d = d[self.row_off:, self.col_off:]
        return d

    @property
    def shape(self) -> Tuple[int, int]:
        r, c = self.data.shape
        if self.transposed:
            r, c = c, r
        return (r - self.row_off, c - self.col_off)


@dataclasses.dataclass(frozen=True)
class InstrRecord:
    """One executed AME arithmetic instruction, with its active tile shape.

    Enough to regenerate the exact PEP launch decomposition (and hence the
    command trace) after the fact: ``kind`` in {add, mul, sub, mac}; for
    element-wise ops ``n`` is 1 and ``k`` is the column count.
    """

    kind: str
    m: int
    k: int
    n: int = 1


@dataclasses.dataclass(frozen=True)
class ShardSpan:
    """Aggregated record of one whole-shard batched/analytic execution.

    The fast paths charge a shard's cost in one step instead of walking
    tiles, so the instruction stream holds one span per shard; the trace
    emitter expands it back into the identical per-tile
    :class:`InstrRecord` sequence via :meth:`records` — command traces are
    byte-for-byte the same as the per-tile walk's.

    ``kind`` is ``"mac"`` (``cols`` = K extent, ``ns`` = N extent) or an
    element-wise kind (``cols`` = column extent, ``ns`` unused).
    """

    kind: str
    rows: int
    cols: int
    ns: int = 1

    def records(self):
        """The per-tile instruction records of the blocked walk, in engine
        dispatch order."""
        if self.kind == "mac":
            for i0, i1, j0, j1, c0, c1 in gemm_tiles(self.rows, self.cols,
                                                     self.ns):
                yield InstrRecord("mac", i1 - i0, c1 - c0, j1 - j0)
        else:
            for i0, i1, c0, c1 in ew_tiles(self.rows, self.cols):
                yield InstrRecord(self.kind, i1 - i0, c1 - c0)


class AMEEngine:
    """Executes the AME instruction subset of paper Table 1 on HBM-PIM.

    The engine models exactly ONE pseudo-channel — the leaf executor.
    Multi-pseudo-channel execution lives one layer up in the runtime,
    which partitions operands across per-channel engines and reports
    makespan, rather than scaling FLOPs in place.  ``device`` holds the
    tiles and runs the numerics: the current CUDA device by default,
    ``"cpu"`` when asked for.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.csr = AMECSRState()
        self.tr: Dict[int, Optional[TileHandle]] = {i: None for i in range(4)}
        self.acc: Dict[int, Optional[TileHandle]] = {i: None for i in range(4)}
        self.total_cycles = 0.0
        self.total_flops = 0
        self.total_commands = 0
        self.log: List[cost_mod.PEPCostReport] = []
        # per-instruction records (InstrRecord) or whole-shard spans
        # (ShardSpan) from the batched executors, in dispatch order
        self.instrs: List[object] = []

    # -- configuration (msettile*) ------------------------------------------

    def msettilem(self, m: int) -> int:
        return self.csr.msettilem(m)

    def msettilek(self, k: int) -> int:
        return self.csr.msettilek(k)

    def msettilen(self, n: int) -> int:
        return self.csr.msettilen(n)

    def mrelease(self) -> None:
        for i in range(4):
            self.tr[i] = None
            self.acc[i] = None

    # -- load/store & misc: pointer-table ops, zero cycle charge ------------

    def _f16(self, x) -> torch.Tensor:
        """``x`` as a float16 tensor on the engine's device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=F16)
        return torch.from_numpy(np.array(x, dtype=np.float16)).to(self.device)

    def mld(self, reg: int, a) -> None:
        a = self._f16(a)
        assert a.ndim == 2 and a.shape[0] <= ROWNUM and a.shape[1] <= TILE_MAX_COLS, \
            f"tile {tuple(a.shape)} exceeds {ROWNUM}x{TILE_MAX_COLS}"
        self.tr[reg] = TileHandle(a)

    def mld_t(self, reg: int, a) -> None:
        """Transposed load — resolved by pointer/layout update (§3.2.6)."""
        self.tr[reg] = TileHandle(self._f16(a), transposed=True)

    def mld_acc(self, reg: int, a) -> None:
        self.acc[reg] = TileHandle(self._f16(a))

    def mst(self, reg: int) -> torch.Tensor:
        return self.acc[reg].resolve()

    def mmov(self, dst: int, src: int) -> None:
        self.tr[dst] = dataclasses.replace(self.tr[src])

    def mslide(self, reg: int, rows: int = 0, cols: int = 0) -> None:
        h = self.tr[reg]
        self.tr[reg] = dataclasses.replace(h, row_off=h.row_off + rows,
                                           col_off=h.col_off + cols)

    def mbc_v(self, reg: int, v, rows: int) -> None:
        """Broadcast a row vector to all tile rows (mbc.v)."""
        v = self._f16(v)
        self.tr[reg] = TileHandle(v[None, :].expand(rows, v.shape[-1]))

    # -- arithmetic ----------------------------------------------------------

    def _active_mk(self, h: TileHandle) -> Tuple[int, int]:
        r, c = h.shape
        return min(r, self.csr.mtilem), min(c, self.csr.mtilek)

    def _charge(self, rep: cost_mod.PEPCostReport,
                rec: InstrRecord) -> cost_mod.PEPCostReport:
        self.total_cycles += rep.cycles
        self.total_flops += rep.flops
        self.total_commands += rep.commands
        self.log.append(rep)
        self.instrs.append(rec)
        return rep

    def _ew(self, op: AMEOp, kind: str, fn, dst: int, a: int, b) -> cost_mod.PEPCostReport:
        pim_mapping(op)  # raises UnsupportedOnPIM for max/min/widening
        ha = self.tr[a]
        m, k = self._active_mk(ha)
        av = ha.resolve()[:m, :k]
        if isinstance(b, int):                       # .mm form
            bv = self.tr[b].resolve()[:m, :k]
        else:                                        # .mv.i form: row vector
            bv = self._f16(b)[None, :k].expand(m, k)
        self.acc[dst] = TileHandle(fn(av, bv))
        return self._charge(cost_mod.elementwise_cost(kind, m, k),
                            InstrRecord(kind, m, k))

    def mfadd(self, dst: int, a: int, b) -> cost_mod.PEPCostReport:
        op = AMEOp.MFADD_MM if isinstance(b, int) else AMEOp.MFADD_MV
        return self._ew(op, "add", _ew_add, dst, a, b)

    def mfsub(self, dst: int, a: int, b) -> cost_mod.PEPCostReport:
        op = AMEOp.MFSUB_MM if isinstance(b, int) else AMEOp.MFSUB_MV
        return self._ew(op, "sub", _ew_sub, dst, a, b)

    def mfmul(self, dst: int, a: int, b) -> cost_mod.PEPCostReport:
        op = AMEOp.MFMUL_MM if isinstance(b, int) else AMEOp.MFMUL_MV
        return self._ew(op, "mul", _ew_mul, dst, a, b)

    def mfmax(self, dst: int, a: int, b) -> cost_mod.PEPCostReport:
        pim_mapping(AMEOp.MFMAX_MM if isinstance(b, int) else AMEOp.MFMAX_MV)
        raise AssertionError("unreachable")

    def mfmin(self, dst: int, a: int, b) -> cost_mod.PEPCostReport:
        pim_mapping(AMEOp.MFMIN_MM if isinstance(b, int) else AMEOp.MFMIN_MV)
        raise AssertionError("unreachable")

    def mfmacc(self, dst: int, a: int, b: int,
               widen: bool = False) -> cost_mod.PEPCostReport:
        """acc(dst) += tr(a) @ tr(b) — the reduction-free outer-product path."""
        if widen:
            pim_mapping(AMEOp.MFMACC_WIDEN)
        pim_mapping(AMEOp.MFMACC)
        ha, hb = self.tr[a], self.tr[b]
        m = min(ha.shape[0], self.csr.mtilem)
        k = min(ha.shape[1], hb.shape[0], self.csr.mtilek)
        n = min(hb.shape[1], self.csr.mtilen)
        av = ha.resolve()[:m, :k]
        bv = hb.resolve()[:k, :n]
        acc = self.acc[dst]
        if acc is None or acc.shape != (m, n):
            acc = TileHandle(torch.zeros((m, n), dtype=F16,
                                         device=self.device))
        self.acc[dst] = TileHandle(_mac_outer(acc.resolve()[:m, :n], av, bv))
        return self._charge(cost_mod.mfmacc_cost(m, k, n),
                            InstrRecord("mac", m, k, n))


# ---------------------------------------------------------------------------
# Single-channel blocked execution (the runtime's leaf executors)
#
# Multi-channel GEMM/GEMV lives in the runtime: the scheduler partitions
# operands across per-channel engines and calls these walkers per shard.
# ---------------------------------------------------------------------------


def gemm_tiles(m: int, k: int, n: int):
    """The blocked-GEMM tile walk: (i0, i1, j0, j1, c0, c1) in engine order.

    Shared between the numeric executor (:func:`gemm_on_engine`) and the
    runtime's analytic cost path so both charge identical ledgers.
    """
    bm, bk, bn = ROWNUM, TILE_MAX_COLS, ROWNUM
    for i0 in range(0, m, bm):
        i1 = min(i0 + bm, m)
        for j0 in range(0, n, bn):
            j1 = min(j0 + bn, n)
            for c0 in range(0, k, bk):
                c1 = min(c0 + bk, k)
                yield i0, i1, j0, j1, c0, c1


def ew_tiles(m: int, c: int):
    """Blocked element-wise tile walk: (i0, i1, c0, c1) in engine order."""
    for i0 in range(0, m, ROWNUM):
        i1 = min(i0 + ROWNUM, m)
        for c0 in range(0, c, TILE_MAX_COLS):
            c1 = min(c0 + TILE_MAX_COLS, c)
            yield i0, i1, c0, c1


def gemm_on_engine(eng: AMEEngine, a, b) -> torch.Tensor:
    """C = A @ B as AME mfmacc tiles on ONE pseudo-channel engine.

    Blocks A (M,K) and B (K,N) into <=128x4096 tiles and walks them
    sequentially, charging the engine's cycle/FLOP ledger.  Every output
    element's accumulation order is ascending-k regardless of the M/N
    blocking, so any output-space partition of a larger problem is
    bit-exact with a single-engine run.  Returns float16 on the engine's
    device.
    """
    a, b = eng._f16(a), eng._f16(b)
    m, k = a.shape
    k2, n = b.shape
    assert k == k2
    out = torch.zeros((m, n), dtype=F16, device=eng.device)
    last_ij = None
    for i0, i1, j0, j1, c0, c1 in gemm_tiles(m, k, n):
        if (i0, j0) != last_ij:
            if last_ij is not None:
                li, lj = last_ij
                out[li:li + ROWNUM, lj:lj + ROWNUM] = eng.mst(0)
            eng.acc[0] = None
            eng.msettilem(i1 - i0)
            eng.msettilen(j1 - j0)
            last_ij = (i0, j0)
        eng.msettilek(c1 - c0)
        eng.mld(0, a[i0:i1, c0:c1])
        # B block enters as an (n x k) tile register consumed through
        # the pointer table's transposed view (mld.t, paper §3.2.6) —
        # this is what produces the K-major dense scalar layout the
        # MAC-PEP broadcasts from.
        eng.mld_t(1, b[c0:c1, j0:j1].T)
        eng.mfmacc(0, 0, 1)
    if last_ij is not None:
        li, lj = last_ij
        out[li:li + ROWNUM, lj:lj + ROWNUM] = eng.mst(0)
    return out


def ew_on_engine(eng: AMEEngine, kind: str, a, b) -> torch.Tensor:
    """Element-wise ``a <op> b`` blocked over ONE pseudo-channel engine;
    float16 on the engine's device."""
    a, b = eng._f16(a), eng._f16(b)
    assert a.shape == b.shape and kind in ("add", "sub", "mul")
    m, c = a.shape
    out = torch.zeros((m, c), dtype=F16, device=eng.device)
    for i0, i1, c0, c1 in ew_tiles(m, c):
        eng.msettilem(i1 - i0)
        eng.msettilek(c1 - c0)
        eng.mld(0, a[i0:i1, c0:c1])
        eng.mld(1, b[i0:i1, c0:c1])
        getattr(eng, f"mf{kind}")(0, 0, 1)
        out[i0:i1, c0:c1] = eng.mst(0)
    return out


# ---------------------------------------------------------------------------
# Batched whole-shard executors (the numeric fast path)
#
# One vectorized fold per shard instead of one engine instruction per
# <=128x4096 tile.  Bit-exactness with the per-tile walk (property-tested):
#
# * GEMM — every output element's value is a left fold over ascending k of
#   ``RN16(RN32(acc + a_ik * b_kj))`` (the MAC-PEP's per-column-command FP16
#   writeback; the f16*f16 product is exact in f32).  The blocked walk only
#   *partitions* those per-element chains across tiles — the chain itself
#   never observes M/N blocking, and K chunk boundaries add no rounding
#   because the accumulator register is already FP16 at every step.  A
#   single fold over the full ascending-k axis therefore reproduces each
#   chain bit-for-bit while vectorizing over the whole (m, n) output.
# * Element-wise — no accumulation at all; a whole-shard fused op is
#   trivially the tiled result.
#
# Cost is charged via the closed-form shard aggregate (core.cost), which
# equals the per-instruction sum exactly; the instruction stream gets one
# ShardSpan that the trace emitter re-expands per tile.
# ---------------------------------------------------------------------------


def gemm_on_engine_batched(eng: AMEEngine, a, b) -> torch.Tensor:
    """C = A @ B on ONE pseudo-channel engine, whole shard in one fold.

    Charges the same ledger totals as :func:`gemm_on_engine` (closed-form
    aggregate; one log entry, one :class:`ShardSpan` instruction record)
    and returns a bit-identical result.

    N == 1 (skinny GEMV) shards delegate to the per-tile walk, as the
    reference does, so their log and instruction records are the walk's
    per-tile entries on both sides.  Both strategies are bit-exact.
    """
    a, b = eng._f16(a), eng._f16(b)
    m, k = a.shape
    k2, n = b.shape
    assert k == k2
    if n == 1:
        return gemm_on_engine(eng, a, b)
    # the whole shard is one mfmacc-semantics fold: _mac_outer with a zero
    # accumulator, so the load-bearing rounding recipe lives in ONE place
    out = _mac_outer(torch.zeros((m, n), dtype=F16, device=eng.device), a, b)
    agg = cost_mod.gemm_shard_cost(m, k, n)
    eng._charge(agg, ShardSpan("mac", m, k, n))
    return out


def ew_on_engine_batched(eng: AMEEngine, kind: str, a, b) -> torch.Tensor:
    """Element-wise ``a <kind> b`` on ONE engine, whole shard in one call."""
    a, b = eng._f16(a), eng._f16(b)
    assert a.shape == b.shape and kind in ("add", "sub", "mul")
    m, c = a.shape
    fn = {"add": _ew_add, "sub": _ew_sub, "mul": _ew_mul}[kind]
    out = fn(a, b)
    agg = cost_mod.ew_shard_cost(kind, m, c)
    eng._charge(agg, ShardSpan(kind, m, c))
    return out
