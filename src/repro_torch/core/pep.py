"""PIM Execution Primitives (paper §3.2, Listing 1) and tile memory layout.

A PEP is a CRF-resident microkernel of native PIM instructions, executed in
AB-PIM mode by all 8 PIM units of a pseudo-channel in lock-step.  This module
builds the four PEPs of the paper —

* ``ADD-PEP`` / ``MUL-PEP``  (Listing 1a): element-wise ops on 128x2048 tiles,
  256 loop passes over 128x8 windows (24 column commands per pass).
* ``SUB-PEP``  (Listing 1b): subtraction emulated as ``a + (-1)*b`` via SRF_M
  (no native SUB), 32 commands per pass plus an 8-command prologue.
* ``MAC-PEP``  (Listing 1c): the reduction-free outer-product GEMM step —
  per pass, 8 scalars of B are double-broadcast (bank -> SRF_A -> GRF_A, 16
  commands) and MAC'd against 8 columns of A into the accumulator column
  held in GRF_B[0] (26 commands per pass).

Tile layout (paper §3.2.1): a tile has up to ROWNUM=128 rows; row ``r`` lives
in even bank ``r // 16``, SIMD lane ``r % 16``; within a bank the tile is
column-major, so block ``base + c`` of bank ``u`` holds rows ``16u..16u+15``
of column ``c``.  Accumulators use the same layout in the odd banks.

The second MAC operand is stored K-major dense (one column of B = K
consecutive FP16 scalars), matching the listings' 2-byte AAM stride; the
paper leaves tr1's placement implicit — its transposed-load (``mld.t``) +
pointer-table machinery (§3.2.6) produces exactly this layout.  We place the
dense region in even bank 0 and use the broadcast fill routing of §2.3.2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.isa import (
    AAM_BLOCKS,
    JUMP_MAX_ITERS,
    PIM_UNITS,
    PIMInstr,
    PIMOpcode,
    Operand,
    OperandSpace,
    ROWNUM,
    SIMD_LANES,
)
from repro_torch.core.pim import PIMChannel

# symbolic base-address names (resolved per loop pass from the command stream)
BT0, BT1, BA0 = "bt0", "bt1", "ba0"
ZERO_BLOCK = "zero"          # reserved all-zeros block (even banks)
MINUS_ONE_BLOCK = "m1"       # reserved -1.0 vector block (even bank 0)

EB = OperandSpace.EVEN_BANK
OB = OperandSpace.ODD_BANK
GA = OperandSpace.GRF_A
GB = OperandSpace.GRF_B
SA = OperandSpace.SRF_A
SM = OperandSpace.SRF_M


def _op(space, index=0, **kw) -> Operand:
    return Operand(space=space, index=index, **kw)


# ---------------------------------------------------------------------------
# PEP program builders (CRF contents)
# ---------------------------------------------------------------------------


def build_ew_pep(op: PIMOpcode, iters: int) -> List[PIMInstr]:
    """ADD-PEP / MUL-PEP (Listing 1a): dst = A <op> B on 128 x 8*iters."""
    assert op in (PIMOpcode.ADD, PIMOpcode.MUL)
    return [
        PIMInstr(PIMOpcode.FILL, dst=_op(GA, step=1),
                 src0=_op(EB, base=BT0, step=1), aam=True),
        PIMInstr(op, dst=_op(GB, step=1),
                 src0=_op(EB, base=BT1, step=1), src1=_op(GA, step=1),
                 aam=True),
        PIMInstr(PIMOpcode.MOV, dst=_op(OB, base=BA0, step=1),
                 src0=_op(GB, step=1), aam=True),
        PIMInstr(PIMOpcode.JUMP, jump_iters=iters - 1, jump_target=0),
        PIMInstr(PIMOpcode.EXIT),
    ]


def build_sub_pep(iters: int) -> List[PIMInstr]:
    """SUB-PEP (Listing 1b): dst = A - B as A + (-1)*B via SRF_M."""
    return [
        # prologue: fill all eight SRF_M entries with -1.0 (broadcast routing)
        PIMInstr(PIMOpcode.FILL, dst=_op(SM, step=1),
                 src0=_op(EB, base=MINUS_ONE_BLOCK, step=1, broadcast=True),
                 aam=True),
        # loop body (jump_target = 1)
        PIMInstr(PIMOpcode.FILL, dst=_op(GA, step=1),
                 src0=_op(EB, base=BT0, step=1), aam=True),
        PIMInstr(PIMOpcode.MUL, dst=_op(GB, step=1),
                 src0=_op(EB, base=BT1, step=1), src1=_op(SM, step=1),
                 aam=True),
        PIMInstr(PIMOpcode.ADD, dst=_op(GB, step=1),
                 src0=_op(GA, step=1), src1=_op(GB, step=1), aam=True),
        PIMInstr(PIMOpcode.MOV, dst=_op(OB, base=BA0, step=1),
                 src0=_op(GB, step=1), aam=True),
        PIMInstr(PIMOpcode.JUMP, jump_iters=iters - 1, jump_target=1),
        PIMInstr(PIMOpcode.EXIT),
    ]


def build_mac_pep(iters: int) -> List[PIMInstr]:
    """MAC-PEP (Listing 1c): one outer-product accumulation step per pass.

    Pass ``t`` computes  acc[:, j] += sum_{i<8} A[:, k0+i] * B[k0+i, j]
    with the 8 B-scalars double-broadcast (bank -> SRF_A -> GRF_A) because
    SRF_M cannot source the MAC in AAM (paper §3.2.5).
    """
    return [
        PIMInstr(PIMOpcode.FILL, dst=_op(GB, 0), src0=_op(OB, base=BA0)),
        PIMInstr(PIMOpcode.FILL, dst=_op(SA, step=1),
                 src0=_op(EB, base=BT1, step=1, broadcast=True), aam=True),
        PIMInstr(PIMOpcode.ADD, dst=_op(GA, step=1),
                 src0=_op(EB, base=ZERO_BLOCK), src1=_op(SA, step=1),
                 aam=True),
        PIMInstr(PIMOpcode.MAC, dst=_op(GB, 0),
                 src0=_op(EB, base=BT0, step=1), src1=_op(GA, step=1),
                 aam=True),
        PIMInstr(PIMOpcode.MOV, dst=_op(OB, base=BA0), src0=_op(GB, 0)),
        PIMInstr(PIMOpcode.JUMP, jump_iters=iters - 1, jump_target=0),
        PIMInstr(PIMOpcode.EXIT),
    ]


#: column commands per loop pass (Listing 1 instruction mix)
COMMANDS_PER_PASS = {
    "add": 3 * AAM_BLOCKS,        # fill + add + mov           = 24
    "mul": 3 * AAM_BLOCKS,        # fill + mul + mov           = 24
    "sub": 4 * AAM_BLOCKS,        # fill + mul + add + mov     = 32
    "mac": 2 + 3 * AAM_BLOCKS,    # fill/mov + srf+bcast+mac   = 26
}
#: useful FLOPs per loop pass per pseudo-channel
FLOPS_PER_PASS = {
    "add": AAM_BLOCKS * SIMD_LANES * PIM_UNITS,        # 1024
    "mul": AAM_BLOCKS * SIMD_LANES * PIM_UNITS,        # 1024
    "sub": AAM_BLOCKS * SIMD_LANES * PIM_UNITS,        # 1024 (the -1 mul is overhead)
    "mac": 2 * AAM_BLOCKS * SIMD_LANES * PIM_UNITS,    # 2048 (MAC = 2 FLOP/lane)
}
SUB_PROLOGUE_COMMANDS = AAM_BLOCKS  # SRF_M init


# ---------------------------------------------------------------------------
# Tile layout <-> dense matrices
# ---------------------------------------------------------------------------


def tile_to_banks(banks: np.ndarray, base: int, tile: np.ndarray) -> None:
    """Write dense ``tile`` (M<=128, C) into bank storage at block ``base``."""
    m, c = tile.shape
    assert m <= ROWNUM, f"tile rows {m} exceed ROWNUM {ROWNUM}"
    full = np.zeros((ROWNUM, c), np.float16)
    full[:m] = tile.astype(np.float16)
    # (128, C) -> (8 banks, 16 lanes, C) -> per bank column-major blocks
    per_bank = full.reshape(PIM_UNITS, SIMD_LANES, c)
    banks[:, base:base + c, :] = np.swapaxes(per_bank, 1, 2)


def banks_to_tile(banks: np.ndarray, base: int, m: int, c: int) -> np.ndarray:
    """Read a dense (m, c) tile back from bank storage at block ``base``."""
    blk = banks[:, base:base + c, :]                    # (8, c, 16)
    return np.swapaxes(blk, 1, 2).reshape(ROWNUM, c)[:m]


def scalars_to_bank0(banks: np.ndarray, base: int, flat: np.ndarray) -> None:
    """Write a dense FP16 scalar run into even bank 0 starting at ``base``."""
    n = flat.size
    nblk = math.ceil(n / SIMD_LANES)
    buf = np.zeros(nblk * SIMD_LANES, np.float16)
    buf[:n] = flat.astype(np.float16).ravel()
    banks[0, base:base + nblk, :] = buf.reshape(nblk, SIMD_LANES)


# ---------------------------------------------------------------------------
# Invocation decomposition (paper §3.2.5 / §4.2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MacInvocation:
    """One MAC-PEP launch: ``passes`` loop passes starting at global pass
    ``start`` of the (j-outer, k-inner) schedule."""

    start: int
    passes: int


def mac_pass_coords(t: int, k: int) -> Tuple[int, int]:
    """Global pass ``t`` -> (output column j, k-base k0)."""
    kc = math.ceil(k / AAM_BLOCKS)
    return t // kc, (t % kc) * AAM_BLOCKS


def mac_invocations(k: int, n: int) -> List[MacInvocation]:
    """Decompose a (128 x k x n) mfmacc into MAC-PEP launches.

    Passes walk columns j outer / k inner (FP16 accumulation order is
    exactly the hardware's); a launch is a run of <= JUMP_MAX_ITERS=256
    consecutive passes, so a single launch covers 128x2048x1 GEMV *or*
    128x8x256 GEMM (paper §3.2.5), and the paper's max tiles (K=4096,
    N=128) need the quoted 256 launches.
    """
    kc = math.ceil(k / AAM_BLOCKS)          # k-chunks of 8 per column
    total = kc * n
    out: List[MacInvocation] = []
    t = 0
    while t < total:
        passes = min(JUMP_MAX_ITERS, total - t)
        out.append(MacInvocation(start=t, passes=passes))
        t += passes
    return out


def ew_invocations(c: int) -> List[Tuple[int, int]]:
    """Element-wise launches: (col0, passes) with 8 columns per pass."""
    cc = math.ceil(c / AAM_BLOCKS)
    out = []
    i = 0
    while i < cc:
        passes = min(JUMP_MAX_ITERS, cc - i)
        out.append((i * AAM_BLOCKS, passes))
        i += passes
    return out


# ---------------------------------------------------------------------------
# Strict execution drivers (run Listing 1 on the reference interpreter)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ChannelMemoryMap:
    """Block bases of the reserved regions and tile/acc registers."""

    zero: int = 0                  # all-zeros block
    minus_one: int = 1             # -1.0 vector block
    b_scalars: int = 2             # dense K-major region for the MAC B operand
    tiles: Tuple[int, ...] = ()    # tr0..tr3 bases (even banks)
    accs: Tuple[int, ...] = ()     # acc0..acc3 bases (odd banks)


def init_channel(nblocks: int, b_region_blocks: int = 2048,
                 n_tiles: int = 2, tile_cols: int = 2048) -> Tuple[PIMChannel, ChannelMemoryMap]:
    ch = PIMChannel(nblocks=nblocks)
    mm = ChannelMemoryMap()
    mm = dataclasses.replace(
        mm,
        tiles=tuple(mm.b_scalars + b_region_blocks + i * tile_cols
                    for i in range(n_tiles)),
        accs=tuple(i * tile_cols for i in range(n_tiles)),
    )
    ch.state.even_banks[:, mm.zero, :] = 0.0
    ch.state.even_banks[0, mm.minus_one, :] = np.float16(-1.0)
    return ch, mm


def run_ew_strict(ch: PIMChannel, mm: ChannelMemoryMap, kind: str,
                  a_base: int, b_base: int, acc_base: int, cols: int) -> int:
    """Run ADD/MUL/SUB-PEP launches covering ``cols`` columns; ret commands."""
    total = 0
    for col0, passes in ew_invocations(cols):
        if kind == "sub":
            crf = build_sub_pep(passes)
        else:
            crf = build_ew_pep(PIMOpcode.ADD if kind == "add" else PIMOpcode.MUL,
                               passes)

        def bases(t: int, _c0=col0) -> Dict[str, int]:
            c = _c0 + t * AAM_BLOCKS
            return {BT0: a_base + c, BT1: b_base + c, BA0: acc_base + c,
                    MINUS_ONE_BLOCK: mm.minus_one, ZERO_BLOCK: mm.zero}

        total += ch.run(crf, bases, setup_bases={MINUS_ONE_BLOCK: mm.minus_one})
    return total


def run_mac_strict(ch: PIMChannel, mm: ChannelMemoryMap,
                   a_base: int, acc_base: int, k: int, n: int) -> int:
    """Run MAC-PEP launches for acc(128 x n) += A(128 x k) @ B(k x n).

    B must already be resident K-major dense at ``mm.b_scalars`` (the
    pointer-table/mld.t layout).  Returns column commands issued.
    """
    total = 0
    for inv in mac_invocations(k, n):
        crf = build_mac_pep(inv.passes)

        def bases(t: int, _inv=inv) -> Dict[str, int]:
            j, k0 = mac_pass_coords(_inv.start + t, k)
            saddr = j * k + k0               # scalar index of B[k0, j]
            return {
                BA0: acc_base + j,
                BT0: a_base + k0,
                BT1: mm.b_scalars + saddr // SIMD_LANES,
                BT1 + "_lane": saddr % SIMD_LANES,
                ZERO_BLOCK: mm.zero,
            }

        total += ch.run(crf, bases)
    return total
