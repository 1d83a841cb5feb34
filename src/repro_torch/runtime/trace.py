"""HBM-PIMulator-compatible command-trace emission and parsing.

Any runtime execution (numeric or analytic) can be dumped as a ``.trace``
file: one line per DRAM column command, in the line grammar of the
HBM-PIMulator trace format (yang2919/HBM-PIMulator), so traces can be fed
to trace-driven simulators and cross-checked against both the cost model
and the strict interpreter (:mod:`repro_torch.core.pim`) — the emitter derives
per-pass base addresses from the *same* schedule functions
(:func:`repro_torch.core.pep.mac_pass_coords`, the ``run_*_strict`` base
tables), so command counts match the strict interpreter exactly.

Line grammar::

    # comment
    AB W                          -- enter AB-PIM mode (one per PEP launch)
    W CFR "<idx>" <OPCODE>        -- program one CRF slot
    W MEM <ch> <bank> <row>       -- one 32-byte host->PIM transaction
    R MEM <ch> <bank> <row>       -- one 32-byte PIM->host transaction
    PIM <OP> [DST] [SRC0] [SRC1]  -- one column command of PEP execution

Operand rendering: ``GRF_A`` index i -> ``GRF,i``; ``GRF_B`` -> ``GRF,8+i``
(GRF_B occupies the upper CRF encoding half); ``SRF_A`` -> ``SRF,i``;
``SRF_M`` -> ``SRF,8+i``; even-bank block a -> ``BANK,2a``; odd-bank block
a -> ``BANK,2a+1`` (even/odd banks interleave in the bank address bits).

JUMP and EXIT issue zero column commands (paper §2.3.3) and are not
emitted; a trace's ``PIM`` line count therefore equals the engine ledger's
``commands`` — the round-trip property the tests pin.

Multi-stack clusters add comment-shaped marker lines (external replay
tools skip them; :func:`parse_trace` round-trips them):

    # STACK <s>                   -- following channels belong to stack s
    # HOSTLINK <kind> <bytes>     -- inter-stack bytes over the host link
                                     (kind: xstack | drain, plus the
                                     fault-injection kinds retry |
                                     reupload | degrade — degrade's count
                                     slot carries extra cycles, not bytes)
    # LINK <s>                    -- switched topology only: following
                                     HOSTLINK lines belong to stack s's
                                     private link (lines before any
                                     # LINK are the switch uplink's)
    # MIGRATE <layer> <expert> <src> <dst> <bytes>
                                  -- routed-MoE expert migration: the
                                     expert's weights moved src -> dst
                                     stack (the matching reupload bytes
                                     are HOSTLINK traffic)
    # SPILL <channel> <bytes>     -- residency evicted under a capacity
                                     bound (re-shipped on next use)

Fault injection (:mod:`repro_torch.faults`) adds two more replay-neutral
markers on the affected channel's stream::

    # FAULT <channel> <cycle>     -- fail-stop injected at that cycle
    # RECOVER <channel> <bytes>   -- recovery traffic landed here (lost
                                     shards re-shipped / pinned outputs
                                     replayed from the last host copy)

A single-stack cluster emits none of these (no ``# STACK 0``), so its
trace is byte-identical to a bare :class:`PIMStack`'s; ``# SPILL`` lines
appear on bare stacks too when a capacity bound evicts.

Async-mode runtimes (``PIMRuntime(async_mode=True)``) additionally wrap
each op's per-channel events in timestamped markers from the timeline
scheduler::

    # TSTART <channel> <op_id> <cycles>   -- the op's busy interval opens
    # TEND <channel> <op_id> <cycles>     -- ... and retires

Both are comment-shaped (external replay skips them) and round-trip
through :func:`parse_trace` (``op_starts`` / ``op_ends``); they carry
*schedule* only, never commands, so :func:`strip_timestamps` recovers a
serialized run's trace byte-for-byte when the op stream is the same.

Traces are *expanded* (one line per command): dump small ops, not the
benchmark sweep shapes.
"""
from __future__ import annotations

import collections
import dataclasses
import re
from typing import Dict, List, Optional

from repro_torch.core.engine import InstrRecord, ShardSpan
from repro_torch.core.isa import (
    AAM_BLOCKS,
    GRF_REGS,
    Operand,
    OperandSpace,
    PIMInstr,
    PIMOpcode,
    SIMD_LANES,
    SRF_REGS,
)
from repro_torch.core.pep import (
    BA0,
    BT0,
    BT1,
    MINUS_ONE_BLOCK,
    ZERO_BLOCK,
    ChannelMemoryMap,
    build_ew_pep,
    build_mac_pep,
    build_sub_pep,
    ew_invocations,
    mac_invocations,
    mac_pass_coords,
)
from repro_torch.runtime.device import PIMStack, transfer_cycles

#: fixed block bases used for trace address resolution (mirrors
#: :func:`repro_torch.core.pep.init_channel` with its default region sizes)
_MM = ChannelMemoryMap(tiles=(2 + 2048, 2 + 2048 + 2048), accs=(0, 2048))

#: 32-byte transactions per notional 1 KB DRAM row (HBM-PIMulator's
#: 5-bit column field)
_COLS_PER_ROW = 32
_BANKS = 16

HEADER = """\
# AME-PIM runtime command trace (HBM-PIMulator line grammar)
#
# AB W                          -- enter AB-PIM mode (one per PEP launch)
# W CFR "[CFR_id]" [opcode]     -- CRF microkernel programming
# R/W MEM [channel] [bank] [row]-- one 32-byte host<->PIM transaction
# PIM [OP] [DST] [SRC0] [SRC1]  -- one column command of PEP execution
#
# operands: (GRF, id) (SRF, id) (BANK, block address)
# GRF 0-7 = GRF_A, GRF 8-15 = GRF_B; SRF 0-7 = SRF_A, SRF 8-15 = SRF_M
# BANK 2a = even-bank block a, BANK 2a+1 = odd-bank block a
# JUMP/EXIT are zero-command (predecoded) and do not appear.
# "# RESIDENT [channel] [bytes]" marks an operand shard reused in place
# (zero bus transactions); comment-shaped so external replay ignores it.
# "# KVAPPEND [channel] [bytes]" / "# KVEVICT [channel] [bytes]" mark
# paged-KV-cache page writes/evictions the same way (the append's real
# traffic is the adjacent MEM writes; the evict charges nothing now —
# the re-ship is real MEM traffic when the page is next needed)."""


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------


def _render(op: Operand, bases: Dict[str, int], b: int) -> str:
    step = op.index + b * op.step
    if op.space is OperandSpace.GRF_A:
        return f"GRF,{step}"
    if op.space is OperandSpace.GRF_B:
        return f"GRF,{GRF_REGS + step}"
    if op.space is OperandSpace.SRF_A:
        return f"SRF,{step}"
    if op.space is OperandSpace.SRF_M:
        return f"SRF,{SRF_REGS + step}"
    if op.space is OperandSpace.ZERO:
        return "BANK,0"
    addr = bases.get(op.base, 0) + op.index + b * op.step
    if op.space is OperandSpace.EVEN_BANK:
        return f"BANK,{2 * addr}"
    if op.space is OperandSpace.ODD_BANK:
        return f"BANK,{2 * addr + 1}"
    raise ValueError(op.space)


def _pim_lines(ins: PIMInstr, bases: Dict[str, int]) -> List[str]:
    """Expand one CRF instruction into its column-command trace lines."""
    if ins.op in (PIMOpcode.JUMP, PIMOpcode.EXIT):
        return []
    reps = AAM_BLOCKS if ins.aam else 1
    out = []
    for b in range(reps):
        parts = [f"PIM {ins.op.value.upper()}"]
        for o in (ins.dst, ins.src0, ins.src1):
            if o is not None:
                parts.append(_render(o, bases, b))
        out.append(" ".join(parts))
    return out


def _expand_launch(lines: List[str], crf: List[PIMInstr],
                   iter_bases, passes: int,
                   setup_bases: Optional[Dict[str, int]] = None) -> None:
    """One PEP launch: mode switch, CRF programming, then every pass."""
    lines.append("AB W")
    for idx, ins in enumerate(crf):
        lines.append(f'W CFR "{idx}" {ins.op.value.upper()}')
    loop_start = next((i.jump_target for i in crf
                       if i.op is PIMOpcode.JUMP), 0)
    for ins in crf[:loop_start]:                    # one-time prologue
        lines.extend(_pim_lines(ins, setup_bases or {}))
    for t in range(passes):
        bases = iter_bases(t)
        for ins in crf[loop_start:]:
            lines.extend(_pim_lines(ins, bases))


def _expand_mac(lines: List[str], rec: InstrRecord) -> None:
    a_base, acc_base = _MM.tiles[0], _MM.accs[0]
    for inv in mac_invocations(rec.k, rec.n):
        def bases(t: int, _inv=inv) -> Dict[str, int]:
            j, k0 = mac_pass_coords(_inv.start + t, rec.k)
            saddr = j * rec.k + k0
            return {BA0: acc_base + j, BT0: a_base + k0,
                    BT1: _MM.b_scalars + saddr // SIMD_LANES,
                    ZERO_BLOCK: _MM.zero}
        _expand_launch(lines, build_mac_pep(inv.passes), bases, inv.passes)


def _expand_ew(lines: List[str], rec: InstrRecord) -> None:
    a_base, b_base, acc_base = _MM.tiles[0], _MM.tiles[1], _MM.accs[0]
    for col0, passes in ew_invocations(rec.k):
        if rec.kind == "sub":
            crf = build_sub_pep(passes)
        else:
            crf = build_ew_pep(
                PIMOpcode.ADD if rec.kind == "add" else PIMOpcode.MUL,
                passes)

        def bases(t: int, _c0=col0) -> Dict[str, int]:
            c = _c0 + t * AAM_BLOCKS
            return {BT0: a_base + c, BT1: b_base + c, BA0: acc_base + c,
                    MINUS_ONE_BLOCK: _MM.minus_one, ZERO_BLOCK: _MM.zero}

        _expand_launch(lines, crf, bases, passes,
                       setup_bases={MINUS_ONE_BLOCK: _MM.minus_one})


def _mem_lines(kind: str, channel: int, nbytes: int) -> List[str]:
    rw = "W" if kind == "h2d" else "R"
    out = []
    for i in range(transfer_cycles(nbytes)):
        bank = i % _BANKS
        row = i // (_BANKS * _COLS_PER_ROW)
        out.append(f"{rw} MEM {channel} {bank} {row}")
    return out


def _emit_device(lines: List[str], dev) -> None:
    """One device's event stream as trace lines."""
    lines.append(f"# channel {dev.channel_id}")
    for kind, payload in dev.events:
        if kind in ("h2d", "d2h"):
            lines.extend(_mem_lines(kind, dev.channel_id, payload))
        elif kind == "reuse":
            # resident operand consumed in place: no MEM transactions;
            # comment-shaped so HBM-PIMulator replay skips it while our
            # parser round-trips the avoided traffic
            lines.append(f"# RESIDENT {dev.channel_id} {payload}")
        elif kind == "spill":
            # capacity eviction: no transactions now — the re-ship is a
            # real MEM write when the evicted operand next misses
            lines.append(f"# SPILL {dev.channel_id} {payload}")
        elif kind == "kvappend":
            # paged-KV page write: the new tokens' h2d is charged as real
            # MEM lines by the adjacent transfer event; this marker keys
            # the bytes to the KV cache for replay-neutral attribution
            lines.append(f"# KVAPPEND {dev.channel_id} {payload}")
        elif kind == "kvevict":
            # paged-KV page eviction under capacity pressure: zero
            # transactions now — the re-ship is real MEM traffic (and a
            # host-link reupload charge) when the page is restored
            lines.append(f"# KVEVICT {dev.channel_id} {payload}")
        elif kind in ("tstart", "tend"):
            # async-timeline schedule markers: zero commands, pure timing
            op_id, cycles = payload
            tag = "TSTART" if kind == "tstart" else "TEND"
            lines.append(f"# {tag} {dev.channel_id} {op_id} {cycles:.3f}")
        elif kind == "fault":
            # fail-stop injected (repro_torch.faults): zero commands — the
            # channel simply issues nothing afterwards
            lines.append(f"# FAULT {dev.channel_id} {payload:.3f}")
        elif kind == "recover":
            # recovery landed here: the matching traffic is real MEM
            # lines (re-ship) or analytic busy time (output replay)
            lines.append(f"# RECOVER {dev.channel_id} {payload}")
        elif kind == "migrate":
            # routed-MoE expert migration landed on this (dst) stack:
            # zero commands — the weight movement is the matching
            # HOSTLINK reupload charge
            layer, expert, src, dst, nbytes = payload
            lines.append(
                f"# MIGRATE {layer} {expert} {src} {dst} {nbytes}")
        elif kind == "instr":
            # whole-shard spans (the fast paths' aggregated records)
            # expand to the identical per-tile instruction sequence,
            # so fast and reference traces are byte-for-byte equal
            recs = payload.records() if isinstance(payload, ShardSpan) \
                else (payload,)
            for rec in recs:
                if rec.kind == "mac":
                    _expand_mac(lines, rec)
                else:
                    _expand_ew(lines, rec)
        else:
            raise ValueError(kind)


def emit_trace(stack) -> str:
    """Serialize everything the stack's devices have executed so far.

    Accepts a :class:`PIMStack` or a :class:`~repro_torch.runtime.cluster.
    PIMCluster`.  Multi-stack clusters group channels under ``# STACK s``
    markers and prepend the host-link ledger as ``# HOSTLINK`` lines; a
    single-stack cluster emits neither, staying byte-identical to a bare
    stack.
    """
    lines = [HEADER]
    stacks = getattr(stack, "stacks", None)
    if stacks is None:                               # bare PIMStack
        for dev in stack:
            _emit_device(lines, dev)
        return "\n".join(lines) + "\n"
    multi = len(stacks) > 1
    for kind, nbytes in stack.link.events:
        lines.append(f"# HOSTLINK {kind} {nbytes}")
    # switched topology: each stack's private link gets its own marker
    # section (shared topology has links=None and emits nothing extra,
    # keeping the trace byte-identical to the pre-topology format)
    for sid, ledger in enumerate(getattr(stack, "links", None) or ()):
        if ledger.events:
            lines.append(f"# LINK {sid}")
            for kind, nbytes in ledger.events:
                lines.append(f"# HOSTLINK {kind} {nbytes}")
    for sid, stk in enumerate(stacks):
        if multi:
            lines.append(f"# STACK {sid}")
        for dev in stk:
            _emit_device(lines, dev)
    return "\n".join(lines) + "\n"


def strip_timestamps(text: str) -> str:
    """Drop the async scheduler's ``# TSTART``/``# TEND`` marker lines.

    An async run over the same op stream differs from a serialized run
    only by these markers (the timeline places busy intervals, it never
    reorders or changes commands), so the stripped async trace is
    byte-identical to the serialized trace — the invariant the tests
    pin.
    """
    return "\n".join(ln for ln in text.split("\n")
                     if not _TS_LINE_RE.match(ln))


def dump_trace(stack: PIMStack, path: str) -> int:
    """Write the stack's trace to ``path``; returns the line count."""
    text = emit_trace(stack)
    with open(path, "w") as f:
        f.write(text)
    return text.count("\n")


# ---------------------------------------------------------------------------
# Parsing (round-trip checks / trace-driven replay entry point)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceStats:
    """Counts reconstructed from a trace file."""

    pim_commands: int = 0
    launches: int = 0                  # AB-mode switches
    cfr_writes: int = 0
    opcodes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    pim_per_channel: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    mem_writes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)       # per channel
    mem_reads: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)       # per channel
    resident_reuses: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)       # per channel
    resident_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)       # per channel
    spill_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)       # per channel
    kvappend_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)       # per channel
    kvevict_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)       # per channel
    # -- async-timeline schedule markers: (channel, op_id) -> cycles.
    # Empty on serialized traces; stripping the marker lines from an
    # async trace recovers the serialized byte stream ------------------
    op_starts: Dict[Tuple[int, int], float] = dataclasses.field(
        default_factory=dict)
    op_ends: Dict[Tuple[int, int], float] = dataclasses.field(
        default_factory=dict)
    # -- cluster dimension: on single-stack traces the per-stack counters
    # accumulate under stack 0 (no # STACK markers exist to switch on) —
    # use ``stacks_seen`` (empty unless markers appeared) to distinguish
    # cluster traces, never truthiness of the counters ------------------
    stacks_seen: List[int] = dataclasses.field(default_factory=list)
    pim_per_stack: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    mem_writes_per_stack: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    mem_reads_per_stack: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    host_link_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)       # per kind (xstack|drain)
    host_link_events: int = 0
    # -- switched link topology: per-stack-link sections (# LINK s).
    # ``link_stacks_seen`` records the section markers in order (empty on
    # shared-topology traces); ``host_link_bytes_per_link`` attributes
    # HOSTLINK bytes to the per-stack link they landed on (uplink bytes —
    # those before any # LINK marker — stay out of it) ------------------
    link_stacks_seen: List[int] = dataclasses.field(default_factory=list)
    host_link_bytes_per_link: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)       # per stack link
    # -- routed-MoE expert migrations: (layer, expert, src, dst, bytes)
    # in marker order.  Empty unless a placement migration fired --------
    migrate_events: List[Tuple[int, int, int, int, int]] = \
        dataclasses.field(default_factory=list)
    # -- fault-injection markers (repro_torch.faults): channel -> injection
    # cycle, and recovery bytes landed per channel.  Empty on fault-free
    # traces (the markers only exist when a fault actually fired) -------
    fault_channels: Dict[int, float] = dataclasses.field(
        default_factory=dict)
    recover_bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)       # per channel

    @property
    def channels(self):
        return sorted(set(self.pim_per_channel)
                      | set(self.mem_writes) | set(self.mem_reads))

    @property
    def total_host_link_bytes(self) -> int:
        return sum(self.host_link_bytes.values())


_CHANNEL_RE = re.compile(r"^# channel (\d+)$")
_RESIDENT_RE = re.compile(r"^# RESIDENT (\d+) (\d+)$")
_STACK_RE = re.compile(r"^# STACK (\d+)$")
_HOSTLINK_RE = re.compile(
    r"^# HOSTLINK (xstack|drain|retry|reupload|degrade|prefill|acts)"
    r" (\d+)$")
_LINK_RE = re.compile(r"^# LINK (\d+)$")
_MIGRATE_RE = re.compile(r"^# MIGRATE (\d+) (\d+) (\d+) (\d+) (\d+)$")
_SPILL_RE = re.compile(r"^# SPILL (\d+) (\d+)$")
_KVAPPEND_RE = re.compile(r"^# KVAPPEND (\d+) (\d+)$")
_KVEVICT_RE = re.compile(r"^# KVEVICT (\d+) (\d+)$")
_FAULT_RE = re.compile(r"^# FAULT (\d+) ([0-9.]+)$")
_RECOVER_RE = re.compile(r"^# RECOVER (\d+) (\d+)$")
_TSTART_RE = re.compile(r"^# TSTART (\d+) (\d+) ([0-9.]+)$")
_TEND_RE = re.compile(r"^# TEND (\d+) (\d+) ([0-9.]+)$")
_TS_LINE_RE = re.compile(r"^# T(?:START|END) ")
_MEM_RE = re.compile(r"^([RW]) MEM (\d+) (\d+) (\d+)$")
_PIM_RE = re.compile(r"^PIM ([A-Z]+)((?: [A-Z]+,\d+)*)$")
_CFR_RE = re.compile(r'^W CFR "(\d+)" ([A-Z]+)$')


def parse_trace(text: str) -> TraceStats:
    """Parse an emitted trace back into per-channel (and, for cluster
    traces, per-stack / host-link) command counts."""
    stats = TraceStats()
    channel = 0
    stack = 0
    cur_link = None          # per-stack link section (None = uplink)
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.rstrip()
        if not line:
            continue
        mm = _CHANNEL_RE.match(line)
        if mm:
            channel = int(mm.group(1))
            continue
        mm = _STACK_RE.match(line)
        if mm:
            stack = int(mm.group(1))
            stats.stacks_seen.append(stack)
            continue
        mm = _LINK_RE.match(line)
        if mm:
            cur_link = int(mm.group(1))
            stats.link_stacks_seen.append(cur_link)
            continue
        mm = _HOSTLINK_RE.match(line)
        if mm:
            stats.host_link_events += 1
            stats.host_link_bytes[mm.group(1)] += int(mm.group(2))
            if cur_link is not None:
                stats.host_link_bytes_per_link[cur_link] += \
                    int(mm.group(2))
            continue
        mm = _MIGRATE_RE.match(line)
        if mm:
            stats.migrate_events.append(tuple(int(g)
                                              for g in mm.groups()))
            continue
        mm = _SPILL_RE.match(line)
        if mm:
            stats.spill_bytes[int(mm.group(1))] += int(mm.group(2))
            continue
        mm = _KVAPPEND_RE.match(line)
        if mm:
            stats.kvappend_bytes[int(mm.group(1))] += int(mm.group(2))
            continue
        mm = _KVEVICT_RE.match(line)
        if mm:
            stats.kvevict_bytes[int(mm.group(1))] += int(mm.group(2))
            continue
        mm = _RESIDENT_RE.match(line)
        if mm:
            stats.resident_reuses[int(mm.group(1))] += 1
            stats.resident_bytes[int(mm.group(1))] += int(mm.group(2))
            continue
        mm = _TSTART_RE.match(line)
        if mm:
            stats.op_starts[(int(mm.group(1)), int(mm.group(2)))] = \
                float(mm.group(3))
            continue
        mm = _TEND_RE.match(line)
        if mm:
            stats.op_ends[(int(mm.group(1)), int(mm.group(2)))] = \
                float(mm.group(3))
            continue
        mm = _FAULT_RE.match(line)
        if mm:
            stats.fault_channels[int(mm.group(1))] = float(mm.group(2))
            continue
        mm = _RECOVER_RE.match(line)
        if mm:
            stats.recover_bytes[int(mm.group(1))] += int(mm.group(2))
            continue
        if line.startswith("#"):
            continue
        if line == "AB W":
            stats.launches += 1
            continue
        mm = _CFR_RE.match(line)
        if mm:
            stats.cfr_writes += 1
            continue
        mm = _MEM_RE.match(line)
        if mm:
            if mm.group(1) == "W":
                stats.mem_writes[int(mm.group(2))] += 1
                stats.mem_writes_per_stack[stack] += 1
            else:
                stats.mem_reads[int(mm.group(2))] += 1
                stats.mem_reads_per_stack[stack] += 1
            continue
        mm = _PIM_RE.match(line)
        if mm:
            stats.pim_commands += 1
            stats.opcodes[mm.group(1)] += 1
            stats.pim_per_channel[channel] += 1
            stats.pim_per_stack[stack] += 1
            continue
        raise ValueError(f"unparseable trace line {lineno}: {line!r}")
    return stats
