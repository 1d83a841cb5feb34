"""Device-level model of one Aquabolt-XL HBM-PIM stack.

A stack exposes :data:`~repro_torch.core.isa.PSEUDO_CHANNELS` = 16
pseudo-channels (4 dies x 4), each with its own 8 PIM units executing an
independent command stream.  The paper evaluates a single pseudo-channel
and names multi-channel scaling as future work; this module is that
missing layer:

* :class:`PIMDevice` — one pseudo-channel: an :class:`~repro_torch.core.engine.
  AMEEngine` (compute ledger) plus a host<->PIM transfer ledger.  Transfers
  are charged at the pseudo-channel command rate: one 32-byte bus transaction
  per column command (the same bus the HBM-PIMulator trace format addresses
  with its 5-bit column field), i.e. ``ceil(bytes / 32)`` cycles at the
  250 MHz bus clock.
* :class:`PIMStack` — the 16-channel device: indexing, reset, and aggregate
  accounting.  The *makespan* semantics (total time = max over channels, not
  sum) live in :mod:`repro_torch.runtime.scheduler`, which owns dispatch order.

Channels do not share PIM-visible state: all cross-channel data movement goes
through the host and is accounted as transfers.  Multiple stacks behind one
host link are :class:`repro_torch.runtime.cluster.PIMCluster`; a stack
constructed with ``stack_id=s`` numbers its devices with *cluster-flat*
channel ids (``s * channels + local``) so ledgers, reports, and traces stay
unambiguous across the cluster.

Residency capacity: ``capacity_bytes`` bounds the per-channel residency
table (default ``None`` = unbounded, today's behavior).  Adding a resident
region past the bound evicts least-recently-used *tensors* first; evicted
bytes are counted as ``spill_bytes`` (the re-ship exposure) and the actual
re-transfer is charged naturally when the evicted operand next misses.

Port of ``repro.runtime.device``: every channel's engine is a
:class:`repro_torch.core.AMEEngine` on the stack's ``device`` (the card
unless the caller passes another), where its numerics run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.core.engine import AMEEngine
from repro_torch.core.isa import PIM_FREQ_HZ, PSEUDO_CHANNELS
from repro_torch.launch.device import resolve_device
from repro_torch.runtime.placement import box_contains

#: bytes moved per column command on one pseudo-channel bus (32-byte
#: transaction granularity — one GRF entry / half a DRAM burst)
TRANSFER_BYTES_PER_COMMAND = 32

#: FP16 operand element size — all runtime transfers/residency are FP16
BYTES_PER_ELEM = 2


def box_bytes(box: Tuple[int, int, int, int]) -> int:
    """FP16 bytes of one (r0, r1, c0, c1) operand box."""
    return (box[1] - box[0]) * (box[3] - box[2]) * BYTES_PER_ELEM

#: per-pseudo-channel host<->PIM bandwidth implied by the command model
CHANNEL_BANDWIDTH_BYTES_PER_S = TRANSFER_BYTES_PER_COMMAND * PIM_FREQ_HZ


def transfer_cycles(nbytes: int) -> int:
    """Bus cycles to move ``nbytes`` over one pseudo-channel."""
    return math.ceil(nbytes / TRANSFER_BYTES_PER_COMMAND)


@dataclasses.dataclass
class TransferLedger:
    """Host<->PIM traffic of one pseudo-channel."""

    h2d_bytes: int = 0
    d2h_bytes: int = 0
    h2d_cycles: int = 0
    d2h_cycles: int = 0

    @property
    def total_bytes(self) -> int:
        return self.h2d_bytes + self.d2h_bytes

    @property
    def total_cycles(self) -> int:
        return self.h2d_cycles + self.d2h_cycles


@dataclasses.dataclass
class DeviceSnapshot:
    """Ledger totals of one device at a point in time (for per-op deltas)."""

    cycles: float
    flops: int
    commands: int
    h2d_bytes: int
    d2h_bytes: int
    h2d_cycles: int
    d2h_cycles: int
    reuse_bytes: int = 0
    dedupe_bytes: int = 0
    spill_bytes: int = 0


class PIMDevice:
    """One pseudo-channel: leaf engine + transfer ledger + event stream.

    ``events`` records the device-visible history in dispatch order —
    ``("h2d"|"d2h", nbytes)`` transfer markers and ``("instr", InstrRecord)``
    entries appended by the scheduler after each shard executes — and is
    what :mod:`repro_torch.runtime.trace` serializes to a command trace.

    Analytic (cost-only) scheduling charges ``analytic_*`` counters instead
    of running the engine; :attr:`compute_cycles` etc. always report the sum
    of both paths so mixed use stays consistent.
    """

    def __init__(self, channel_id: int,
                 capacity_bytes: Optional[int] = None, device=None):
        self.channel_id = channel_id
        self.capacity_bytes = capacity_bytes
        # fail-stop flag set by repro_torch.faults.FaultInjector; a failed
        # channel is excluded from new placement decompositions and its
        # residency table has been wiped (shards lost)
        self.failed = False
        self.engine = AMEEngine(device=device)
        self.xfer = TransferLedger()
        self.events: List[Tuple[str, object]] = []
        self.analytic_cycles = 0.0
        self.analytic_flops = 0
        self.analytic_commands = 0
        # operand residency: tensor uid -> resident 2D boxes (r0, r1, c0, c1)
        # in that tensor's own coordinates.  Owned by the scheduler /
        # repro_torch.runtime.residency; the device just stores and queries.
        # Dict insertion order doubles as the LRU order (oldest first);
        # _touch moves a uid to the back on every hit.
        self.resident: Dict[int, List[Tuple[int, int, int, int]]] = {}
        # uids that must not be evicted: kept outputs whose d2h drain is
        # still pending — on hardware, spilling them would lose the only
        # copy of the result.  Unpinned when the handle drains/evicts.
        self.pinned: Set[int] = set()
        self.reuse_bytes = 0    # h2d avoided by cross-op operand residency
        self.dedupe_bytes = 0   # h2d avoided by within-op slice dedupe
        self.spill_bytes = 0    # resident bytes evicted under capacity
        # async-timeline channel clock (repro_torch.runtime.timeline): the
        # cycle this channel next comes free.  Only an async_mode
        # runtime advances it; the serialized mode leaves it at 0.
        self.tl_free = 0.0

    # -- compute ledger ------------------------------------------------------

    @property
    def compute_cycles(self) -> float:
        return self.engine.total_cycles + self.analytic_cycles

    @property
    def compute_flops(self) -> int:
        return self.engine.total_flops + self.analytic_flops

    @property
    def compute_commands(self) -> int:
        return self.engine.total_commands + self.analytic_commands

    def charge_analytic(self, cycles: float, flops: int,
                        commands: int) -> None:
        self.analytic_cycles += cycles
        self.analytic_flops += flops
        self.analytic_commands += commands

    # -- transfers -----------------------------------------------------------

    def host_to_pim(self, nbytes: int) -> int:
        """Account a host->PIM transfer; returns its bus cycles."""
        cyc = transfer_cycles(nbytes)
        self.xfer.h2d_bytes += nbytes
        self.xfer.h2d_cycles += cyc
        self.events.append(("h2d", nbytes))
        return cyc

    def pim_to_host(self, nbytes: int) -> int:
        """Account a PIM->host transfer; returns its bus cycles."""
        cyc = transfer_cycles(nbytes)
        self.xfer.d2h_bytes += nbytes
        self.xfer.d2h_cycles += cyc
        self.events.append(("d2h", nbytes))
        return cyc

    def note_reuse(self, nbytes: int) -> None:
        """Account a resident-operand reuse: zero bus traffic, event only.

        ``nbytes`` is the h2d transfer *avoided* — what the fresh-transfer
        path would have shipped for the same shard.
        """
        self.reuse_bytes += nbytes
        self.events.append(("reuse", nbytes))

    def note_dedupe(self, nbytes: int) -> None:
        """Account a within-op repeated-slice dedupe (e.g. the GEMV x
        vector across same-channel K-split shards): zero bus traffic.

        Kept separate from :meth:`note_reuse` so residency invariants
        ("reuse == weight bytes") stay exact on both the fresh and the
        resident path; the trace marker is the same ``reuse`` event.
        """
        self.dedupe_bytes += nbytes
        self.events.append(("reuse", nbytes))

    # -- residency table -----------------------------------------------------

    def _touch(self, uid: int) -> None:
        """Move ``uid`` to the most-recently-used end of the LRU order."""
        boxes = self.resident.pop(uid)
        self.resident[uid] = boxes

    def add_resident(self, uid: int,
                     box: Tuple[int, int, int, int],
                     pin: bool = False) -> bool:
        """Record that ``box`` of tensor ``uid`` now lives on this channel.

        Under a ``capacity_bytes`` bound, least-recently-used *other*
        unpinned tensors are evicted first (their bytes counted as spill
        and marked in the event stream); a box that cannot fit even alone
        — or cannot fit without evicting pinned (undrained-output) data —
        is not recorded at all (streamed through, re-shipped next use).
        ``pin=True`` additionally pins ``uid`` (kept outputs awaiting
        their deferred d2h).  Returns whether the box is now resident.

        A box that *contains* already-resident boxes of the same tensor
        supersedes them (they are absorbed rather than double-counted) —
        the growing-trailing-page case of a :class:`~repro_torch.runtime.
        residency.PagedTensor`, where each re-mark extends the previous
        page box by the newly appended tokens.
        """
        boxes = self.resident.get(uid)
        if boxes:
            kept_boxes = [b for b in boxes if not box_contains(box, b)]
            if len(kept_boxes) != len(boxes):
                self.resident[uid] = kept_boxes
        nbytes = box_bytes(box)
        cap = self.capacity_bytes
        if cap is not None:
            if nbytes > cap:
                return False
            need = self.resident_bytes + nbytes - cap
            # refuse before evicting anything if eviction cannot free
            # enough (pinned data never counts) — a doomed insert must
            # not cost other tensors their residency
            if need > 0:
                evictable = sum(self.resident_bytes_of(u)
                                for u in self.resident
                                if u not in self.pinned)
                if evictable < need:
                    return False
            while self.resident_bytes + nbytes > cap:
                # oldest other unpinned tensor first; the incoming uid's
                # own older boxes only as a last resort; never pinned data
                victim = next((u for u in self.resident
                               if u != uid and u not in self.pinned), uid)
                self._spill(victim)
        self.resident.setdefault(uid, []).append(box)
        if pin:
            self.pinned.add(uid)
        self._touch(uid)
        return True

    def unpin(self, uid: int) -> None:
        """Make ``uid`` evictable again (its pending outputs drained)."""
        self.pinned.discard(uid)

    def _spill(self, uid: int) -> None:
        """Evict tensor ``uid``: count its bytes as spill (the re-ship the
        next miss will charge) and mark the trace."""
        nbytes = self.resident_bytes_of(uid)
        self.resident.pop(uid, None)
        self.spill_bytes += nbytes
        self.events.append(("spill", nbytes))

    def has_resident(self, uid: int,
                     box: Tuple[int, int, int, int]) -> bool:
        """True if ``box`` is contained in a resident region of ``uid``."""
        hit = any(box_contains(b, box)
                  for b in self.resident.get(uid, ()))
        if hit:
            self._touch(uid)
        return hit

    def drop_resident(self, uid: int) -> None:
        """Forget all of tensor ``uid``'s regions (eviction, no traffic)."""
        self.resident.pop(uid, None)
        self.pinned.discard(uid)

    def drop_resident_box(self, uid: int,
                          box: Tuple[int, int, int, int]) -> int:
        """Forget the resident regions of ``uid`` contained in ``box``
        (paged KV eviction: one page, not the whole tensor).  Returns the
        bytes dropped; no spill/traffic accounting — the KV manager
        charges its own eviction markers and the eventual re-ship.
        """
        boxes = self.resident.get(uid)
        if not boxes:
            return 0
        kept = [b for b in boxes if not box_contains(box, b)]
        dropped = (sum(box_bytes(b) for b in boxes)
                   - sum(box_bytes(b) for b in kept))
        if kept:
            self.resident[uid] = kept
        else:
            self.resident.pop(uid)
        return dropped

    def resident_bytes_of(self, uid: int) -> int:
        """Bytes of tensor ``uid`` resident on this channel."""
        return sum(box_bytes(b) for b in self.resident.get(uid, ()))

    @property
    def resident_bytes(self) -> int:
        """Bytes of operand data currently resident on this channel."""
        return sum(box_bytes(b) for boxes in self.resident.values()
                   for b in boxes)

    # -- snapshots (per-op deltas for RuntimeReport) -------------------------

    def snapshot(self) -> DeviceSnapshot:
        return DeviceSnapshot(
            cycles=self.compute_cycles, flops=self.compute_flops,
            commands=self.compute_commands,
            h2d_bytes=self.xfer.h2d_bytes, d2h_bytes=self.xfer.d2h_bytes,
            h2d_cycles=self.xfer.h2d_cycles, d2h_cycles=self.xfer.d2h_cycles,
            reuse_bytes=self.reuse_bytes, dedupe_bytes=self.dedupe_bytes,
            spill_bytes=self.spill_bytes)


class PIMStack:
    """An HBM-PIM stack: up to 16 independent pseudo-channels.

    ``stack_id`` places the stack inside a
    :class:`~repro_torch.runtime.cluster.PIMCluster`: devices are numbered
    with cluster-flat channel ids (``stack_id * channels + local``) while
    ``__getitem__`` stays local (0-based within the stack).  A bare stack
    (``stack_id=0``) numbers devices 0..channels-1 exactly as before.
    ``device`` is where the channels' engines compute (the card by
    default), kept as ``torch_device``.
    """

    def __init__(self, channels: int = PSEUDO_CHANNELS, stack_id: int = 0,
                 capacity_bytes: Optional[int] = None, device=None):
        assert 1 <= channels <= PSEUDO_CHANNELS, \
            f"a stack has at most {PSEUDO_CHANNELS} pseudo-channels"
        self.stack_id = stack_id
        self.capacity_bytes = capacity_bytes
        self.torch_device = resolve_device(device)
        self.devices = [PIMDevice(stack_id * channels + i, capacity_bytes,
                                  self.torch_device)
                        for i in range(channels)]

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, ch: int) -> PIMDevice:
        return self.devices[ch]

    def __iter__(self) -> Iterator[PIMDevice]:
        return iter(self.devices)

    # -- aggregates ----------------------------------------------------------

    @property
    def total_flops(self) -> int:
        return sum(d.compute_flops for d in self.devices)

    @property
    def total_bytes(self) -> int:
        return sum(d.xfer.total_bytes for d in self.devices)

    @property
    def resident_bytes(self) -> int:
        return sum(d.resident_bytes for d in self.devices)

    @property
    def busy_cycles(self) -> float:
        """Sum of per-channel busy time (NOT wall-clock; see scheduler)."""
        return sum(d.compute_cycles + d.xfer.total_cycles
                   for d in self.devices)

    @property
    def spill_bytes(self) -> int:
        return sum(d.spill_bytes for d in self.devices)

    def reset(self) -> None:
        self.__init__(len(self.devices), self.stack_id, self.capacity_bytes,
                      self.torch_device)
