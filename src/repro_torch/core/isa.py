"""AME and Aquabolt-XL PIM instruction-set definitions.

Two ISAs live here, mirroring the paper's §2.3 and §2.4:

* The **PIM ISA** — the minimal per-pseudo-channel instruction set of Samsung
  Aquabolt-XL (arithmetic ADD/MUL/MAD/MAC, data movement MOV/FILL, control
  NOP/JUMP/EXIT), executed by the 8 PIM units of a pseudo-channel in lock-step,
  one instruction per DRAM column command in AB-PIM mode.

* The **AME ISA** — the T-Head RISC-V Attached Matrix Extension subset the
  paper maps onto PIM: tile registers tr0-tr3, accumulation registers
  acc0-acc3, mtilem/k/n CSRs, element-wise mfadd/mfsub/mfmul, matrix
  mfmacc, and the load/store/move family resolved via a pointer table.

The paper's Table 1 mapping (which AME ops are PIM-supported) is encoded in
:data:`AME_TO_PIM` and enforced by :class:`UnsupportedOnPIM`.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Hardware constants (paper §2.1 / Table 2)
# ---------------------------------------------------------------------------

SIMD_LANES = 16          #: FP16 lanes per PIM unit
PIM_UNITS = 8            #: PIM units per pseudo-channel (16 banks / 2)
EVEN_BANKS = PIM_UNITS   #: one even bank per PIM unit
ODD_BANKS = PIM_UNITS    #: one odd bank per PIM unit
GRF_REGS = 8             #: 256-bit registers in each of GRF_A / GRF_B
SRF_REGS = 8             #: scalar registers in each of SRF_A / SRF_M
CRF_ENTRIES = 32         #: microkernel slots (32 x 32-bit)
JUMP_MAX_ITERS = 256     #: 255-iteration counter => at most 256 loop passes
AAM_BLOCKS = 8           #: address-aligned mode: 8 consecutive 16xFP16 blocks
PIM_FREQ_HZ = 250e6      #: DRAM-core / PIM-unit / FPGA-bus frequency (250 MHz)
PSEUDO_CHANNELS = 16     #: PIM pseudo-channels per HBM stack (4 dies x 4)

# AME implementation-defined constants (paper Table 2)
ELEN = 16                            #: element size, bits (FP16)
ROWNUM = 128                         #: rows per tile = EVEN_BANKS * SIMD_LANES
TRLEN = 2 ** 16                      #: tile-register row length, bits
TILE_MAX_COLS = 4096                 #: TRLEN / ELEN
ALEN = 2 ** 23                       #: accumulation register size, bits
NUM_TILE_REGS = 4                    #: tr0-tr3
NUM_ACC_REGS = 4                     #: acc0-acc3
PEAK_FLOP_PER_CYCLE = 2 * SIMD_LANES * PIM_UNITS * 0.5  # nominal MAC peak...

# A MAC = 2 FLOP per lane per cycle across 8 units -> 256; the paper quotes a
# usable theoretical peak of 128 FLOP/cycle per pseudo-channel because each
# lane's multiplier+adder pair retires one MAC per *command* and commands
# interleave with data movement; we keep the paper's figure.
THEORETICAL_PEAK_FLOP_PER_CYCLE = 128.0


class PIMOpcode(enum.Enum):
    """Native Aquabolt-XL PIM opcodes (paper §2.3)."""

    ADD = "add"
    MUL = "mul"
    MAD = "mad"
    MAC = "mac"
    MOV = "mov"
    FILL = "fill"
    NOP = "nop"
    JUMP = "jump"
    EXIT = "exit"


ARITH_OPCODES = (PIMOpcode.ADD, PIMOpcode.MUL, PIMOpcode.MAD, PIMOpcode.MAC)
MOVE_OPCODES = (PIMOpcode.MOV, PIMOpcode.FILL)


class OperandSpace(enum.Enum):
    """Where a PIM operand lives."""

    GRF_A = "grf_a"
    GRF_B = "grf_b"
    SRF_A = "srf_a"
    SRF_M = "srf_m"
    EVEN_BANK = "even_bank"
    ODD_BANK = "odd_bank"
    ZERO = "zero"          # the reserved zero_vector region (paper Listing 1c)


@dataclasses.dataclass(frozen=True)
class Operand:
    """A PIM operand reference.

    ``index`` selects a register (GRF/SRF) or a 256-bit block address
    (banks; block-granular addressing — a block is 16 consecutive FP16).
    For SRF fills from a bank, ``lane`` selects the FP16 scalar inside the
    block.  ``broadcast=True`` marks the paper's single-bank-to-all-units
    broadcast routing (§2.3.2).  Bank operands are offset by the symbolic
    base ``base`` (resolved from the host command stream per loop pass —
    AAM) and advance by ``step`` per AAM sub-command (the listings' ``32*i``
    byte stride is one 256-bit block, i.e. ``step=1``; SRF scalar fills use
    the ``2*i`` byte stride, i.e. lane ``step=1``).
    """

    space: OperandSpace
    index: int = 0
    lane: Optional[int] = None
    broadcast: bool = False
    base: str = ""
    step: int = 0

    def __repr__(self) -> str:  # compact, for program listings
        s = self.space.value
        loc = f"{self.base}+{self.index}" if self.base else f"{self.index}"
        if self.lane is not None:
            return f"{s}[{loc}.{self.lane}]"
        return f"{s}[{loc}]" + ("!bcast" if self.broadcast else "")


@dataclasses.dataclass(frozen=True)
class PIMInstr:
    """One 32-bit PIM instruction (decoded form).

    ``aam`` marks address-aligned mode: the instruction is retired by 8
    consecutive column commands, the b-th advancing every bank-space operand
    by ``aam_stride`` blocks and every register operand index by 1.
    """

    op: PIMOpcode
    dst: Optional[Operand] = None
    src0: Optional[Operand] = None
    src1: Optional[Operand] = None
    aam: bool = False
    aam_stride: int = 1
    jump_iters: int = 0       # JUMP: number of *additional* passes (<= 255)
    jump_target: int = 0      # CRF index to jump back to

    def commands(self) -> int:
        """DRAM column commands needed to retire this instruction once."""
        if self.op is PIMOpcode.JUMP:
            return 0  # zero-cycle predecoded jump (paper §2.3.3)
        return AAM_BLOCKS if self.aam else 1

    def __repr__(self) -> str:
        if self.op is PIMOpcode.JUMP:
            return f"jump x{self.jump_iters} -> {self.jump_target}"
        parts = [self.op.value]
        for o in (self.dst, self.src0, self.src1):
            if o is not None:
                parts.append(repr(o))
        if self.aam:
            parts.append(f"(aam x{AAM_BLOCKS}, stride {self.aam_stride})")
        return " ".join(parts)


# ---------------------------------------------------------------------------
# AME instruction surface (T-Head proposal subset used by the paper)
# ---------------------------------------------------------------------------


class AMEOp(enum.Enum):
    # configuration
    MSETTILEM = "msettilem"
    MSETTILEK = "msettilek"
    MSETTILEN = "msettilen"
    MRELEASE = "mrelease"
    # element-wise arithmetic (matrix-matrix and matrix-vector forms)
    MFADD_MM = "mfadd.h.mm"
    MFADD_MV = "mfadd.h.mv.i"
    MFSUB_MM = "mfsub.h.mm"
    MFSUB_MV = "mfsub.h.mv.i"
    MFMUL_MM = "mfmul.h.mm"
    MFMUL_MV = "mfmul.h.mv.i"
    MFMAX_MM = "mfmax.h.mm"
    MFMAX_MV = "mfmax.h.mv.i"
    MFMIN_MM = "mfmin.h.mm"
    MFMIN_MV = "mfmin.h.mv.i"
    # matrix multiplication
    MFMACC = "mfmacc.h"
    MFMACC_WIDEN = "mfmacc.s.h"   # FP16 -> FP32 widening form
    # load/store & misc (pointer-table resolved, paper §3.2.6)
    MLD = "mld"
    MST = "mst"
    MLD_T = "mld.t"               # transposed load
    MMOV = "mmov.mm"
    MBC = "mbc.v"                 # broadcast
    MPACK = "mpack"
    MSLIDE = "mslide"


#: Paper Table 1 — AME arithmetic/matrix ops -> native PIM opcode sequence.
#: ``None`` means "Not supported" on Aquabolt-XL.
AME_TO_PIM = {
    AMEOp.MFADD_MM: (PIMOpcode.ADD,),
    AMEOp.MFADD_MV: (PIMOpcode.ADD,),
    AMEOp.MFSUB_MM: (PIMOpcode.MUL, PIMOpcode.ADD),
    AMEOp.MFSUB_MV: (PIMOpcode.MUL, PIMOpcode.ADD),
    AMEOp.MFMUL_MM: (PIMOpcode.MUL,),
    AMEOp.MFMUL_MV: (PIMOpcode.MUL,),
    AMEOp.MFMAX_MM: None,
    AMEOp.MFMAX_MV: None,
    AMEOp.MFMIN_MM: None,
    AMEOp.MFMIN_MV: None,
    AMEOp.MFMACC: (PIMOpcode.MAC,),
    AMEOp.MFMACC_WIDEN: None,
}


class UnsupportedOnPIM(NotImplementedError):
    """AME operation with no Aquabolt-XL mapping (paper Table 1)."""


def pim_mapping(op: AMEOp) -> Tuple[PIMOpcode, ...]:
    """The PIM opcode sequence implementing ``op``, or raise."""
    seq = AME_TO_PIM.get(op, ())
    if seq is None:
        raise UnsupportedOnPIM(
            f"{op.value}: no native PIM mapping (no comparison/widening "
            "support in the Aquabolt-XL datapath — paper Table 1)")
    return seq


@dataclasses.dataclass
class AMECSRState:
    """AME configuration CSRs (paper §2.4.1).

    mtilem/k/n bound the *active* tile shape of subsequent instructions;
    msettile* clamps against the implementation constants (Table 2) the way
    a real implementation reports back the granted dimension.
    """

    mtilem: int = ROWNUM
    mtilek: int = TILE_MAX_COLS
    mtilen: int = ROWNUM

    def msettilem(self, m: int) -> int:
        self.mtilem = max(1, min(int(m), ROWNUM))
        return self.mtilem

    def msettilek(self, k: int) -> int:
        self.mtilek = max(1, min(int(k), TILE_MAX_COLS))
        return self.mtilek

    def msettilen(self, n: int) -> int:
        self.mtilen = max(1, min(int(n), TILE_MAX_COLS))
        return self.mtilen
