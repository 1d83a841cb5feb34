"""Strict functional model of one Aquabolt-XL PIM pseudo-channel.

This is the *reference interpreter*: it executes CRF programs one DRAM column
command at a time, for all 8 PIM units in lock-step, with FP16 rounding after
every multiplier/adder stage — exactly the execution model of paper §2.1-2.3.
It is deliberately numpy (not a tensor program): the fast, vectorized path
in :mod:`repro_torch.core.engine` is cross-validated against this
interpreter on small shapes, then used for real tile sizes.

Memory model
------------
Each bank is an array of 256-bit *blocks* (16 FP16 lanes).  Bank operands are
addressed as ``bases[op.base] + op.index (+ b*op.step in AAM step b)`` where
``bases`` is the per-loop-iteration base-address table supplied by the host
command stream — this mirrors address-aligned mode (AAM), where operand
addresses are derived from the column command itself rather than from the
instruction encoding.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.isa import (
    AAM_BLOCKS,
    EVEN_BANKS,
    GRF_REGS,
    ODD_BANKS,
    PIM_UNITS,
    PIMInstr,
    PIMOpcode,
    Operand,
    OperandSpace,
    SIMD_LANES,
    SRF_REGS,
)

F16 = np.float16


def f16(x: np.ndarray) -> np.ndarray:
    """Round to FP16 — models one datapath pipeline stage's output latch."""
    return np.asarray(x, dtype=F16)


@dataclasses.dataclass
class ChannelState:
    """Architectural state of one pseudo-channel."""

    even_banks: np.ndarray  # (PIM_UNITS, nblocks, 16) f16
    odd_banks: np.ndarray   # (PIM_UNITS, nblocks, 16) f16
    grf_a: np.ndarray       # (PIM_UNITS, GRF_REGS, 16) f16
    grf_b: np.ndarray       # (PIM_UNITS, GRF_REGS, 16) f16
    srf_a: np.ndarray       # (PIM_UNITS, SRF_REGS) f16
    srf_m: np.ndarray       # (PIM_UNITS, SRF_REGS) f16

    @classmethod
    def zeros(cls, nblocks: int) -> "ChannelState":
        return cls(
            even_banks=np.zeros((PIM_UNITS, nblocks, SIMD_LANES), F16),
            odd_banks=np.zeros((PIM_UNITS, nblocks, SIMD_LANES), F16),
            grf_a=np.zeros((PIM_UNITS, GRF_REGS, SIMD_LANES), F16),
            grf_b=np.zeros((PIM_UNITS, GRF_REGS, SIMD_LANES), F16),
            srf_a=np.zeros((PIM_UNITS, SRF_REGS), F16),
            srf_m=np.zeros((PIM_UNITS, SRF_REGS), F16),
        )


class PIMChannel:
    """Lock-step interpreter for CRF microkernel programs (AB-PIM mode)."""

    def __init__(self, nblocks: int = 4096):
        self.state = ChannelState.zeros(nblocks)
        self.commands_issued = 0  # column commands == bus-side cycles (ISA model)

    # -- operand access ----------------------------------------------------

    def _bank(self, space: OperandSpace) -> np.ndarray:
        if space is OperandSpace.EVEN_BANK:
            return self.state.even_banks
        if space is OperandSpace.ODD_BANK:
            return self.state.odd_banks
        raise ValueError(space)

    def _resolve(self, op: Operand, bases: Dict[str, int], b: int) -> int:
        base = bases.get(getattr(op, "base", ""), 0) if hasattr(op, "base") else 0
        return base + op.index + b * getattr(op, "step", 0)

    def _read_vec(self, op: Operand, bases: Dict[str, int], b: int) -> np.ndarray:
        """Read a 16-lane vector operand for every unit: (PIM_UNITS, 16)."""
        s = self.state
        if op.space is OperandSpace.ZERO:
            return np.zeros((PIM_UNITS, SIMD_LANES), F16)
        if op.space is OperandSpace.GRF_A:
            return s.grf_a[:, op.index + b * op.step]
        if op.space is OperandSpace.GRF_B:
            return s.grf_b[:, op.index + b * op.step]
        if op.space is OperandSpace.SRF_A:
            return np.repeat(s.srf_a[:, op.index + b * op.step, None],
                             SIMD_LANES, axis=1)
        if op.space is OperandSpace.SRF_M:
            return np.repeat(s.srf_m[:, op.index + b * op.step, None],
                             SIMD_LANES, axis=1)
        if op.space in (OperandSpace.EVEN_BANK, OperandSpace.ODD_BANK):
            blk = self._resolve(op, bases, b)
            banks = self._bank(op.space)
            if op.broadcast:  # single source bank routed to every unit
                return np.repeat(banks[0, blk][None], PIM_UNITS, axis=0)
            return banks[:, blk]
        raise ValueError(op.space)

    def _write_vec(self, op: Operand, bases: Dict[str, int], b: int,
                   val: np.ndarray) -> None:
        s = self.state
        if op.space is OperandSpace.GRF_A:
            s.grf_a[:, op.index + b * op.step] = val
        elif op.space is OperandSpace.GRF_B:
            s.grf_b[:, op.index + b * op.step] = val
        elif op.space in (OperandSpace.EVEN_BANK, OperandSpace.ODD_BANK):
            self._bank(op.space)[:, self._resolve(op, bases, b)] = val
        else:
            raise ValueError(f"cannot write vector to {op.space}")

    # -- execution ---------------------------------------------------------

    def _exec_once(self, ins: PIMInstr, bases: Dict[str, int], b: int) -> None:
        s = self.state
        if ins.op is PIMOpcode.FILL:
            dst = ins.dst
            if dst.space in (OperandSpace.SRF_A, OperandSpace.SRF_M):
                # scalar fill: one FP16 lane of a bank block, broadcast-routable.
                # The listings' 2-byte stride = one lane per AAM sub-command.
                src = ins.src0
                blk = self._resolve(src, bases, 0)
                lane = ((src.lane or 0) + bases.get(src.base + "_lane", 0)
                        + b * src.step)
                blk += lane // SIMD_LANES
                lane = lane % SIMD_LANES
                banks = self._bank(src.space)
                tgt = s.srf_a if dst.space is OperandSpace.SRF_A else s.srf_m
                idx = dst.index + b * dst.step
                if src.broadcast:
                    tgt[:, idx] = banks[0, blk, lane]  # one bank -> all units
                else:
                    tgt[:, idx] = banks[:, blk, lane]
            else:
                self._write_vec(dst, bases, b, self._read_vec(ins.src0, bases, b))
        elif ins.op is PIMOpcode.MOV:
            self._write_vec(ins.dst, bases, b, self._read_vec(ins.src0, bases, b))
        elif ins.op is PIMOpcode.ADD:
            a = self._read_vec(ins.src0, bases, b)
            c = self._read_vec(ins.src1, bases, b)
            self._write_vec(ins.dst, bases, b, f16(a.astype(F16) + c.astype(F16)))
        elif ins.op is PIMOpcode.MUL:
            a = self._read_vec(ins.src0, bases, b)
            c = self._read_vec(ins.src1, bases, b)
            self._write_vec(ins.dst, bases, b, f16(a * c))
        elif ins.op is PIMOpcode.MAD:
            # fused multiply-add (paper §2.3.1): single rounding at writeback
            a = self._read_vec(ins.src0, bases, b).astype(np.float32)
            c = self._read_vec(ins.src1, bases, b).astype(np.float32)
            d = self._read_vec(ins.dst, bases, b).astype(np.float32)
            self._write_vec(ins.dst, bases, b, f16(a * c + d))
        elif ins.op is PIMOpcode.MAC:
            # fused multiply-accumulate: exact product + add, one rounding
            a = self._read_vec(ins.src0, bases, b).astype(np.float32)
            c = self._read_vec(ins.src1, bases, b).astype(np.float32)
            acc = self._read_vec(ins.dst, bases, b).astype(np.float32)
            self._write_vec(ins.dst, bases, b, f16(acc + a * c))
        elif ins.op is PIMOpcode.NOP:
            pass
        else:
            raise ValueError(ins.op)

    def run(self, crf: List[PIMInstr],
            iter_bases: Callable[[int], Dict[str, int]],
            setup_bases: Optional[Dict[str, int]] = None) -> int:
        """Execute a CRF program to EXIT; returns column commands issued.

        ``iter_bases(t)`` supplies the host-driven base-address table for
        loop pass ``t`` (AAM semantics).  Instructions before the JUMP
        target index use ``setup_bases`` (one-time prologue, e.g. SUB-PEP's
        SRF_M initialization).
        """
        setup_bases = setup_bases or {}
        pc = 0
        t = 0                      # loop pass index
        jump_remaining: Optional[int] = None
        commands = 0
        loop_start = next((i.jump_target for i in crf
                           if i.op is PIMOpcode.JUMP), 0)
        while pc < len(crf):
            ins = crf[pc]
            if ins.op is PIMOpcode.EXIT:
                break
            if ins.op is PIMOpcode.JUMP:
                if jump_remaining is None:
                    jump_remaining = ins.jump_iters
                if jump_remaining > 0:
                    jump_remaining -= 1
                    t += 1
                    pc = ins.jump_target
                else:
                    pc += 1
                continue  # zero-cycle jump
            bases = setup_bases if pc < loop_start else iter_bases(t)
            reps = AAM_BLOCKS if ins.aam else 1
            for b in range(reps):
                self._exec_once(ins, bases, b)
                commands += 1
            pc += 1
        self.commands_issued += commands
        return commands
