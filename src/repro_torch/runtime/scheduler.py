"""Command-queue scheduler: dispatch one op across pseudo-channels.

The scheduler partitions a GEMM/GEMV/element-wise op according to a
placement policy (:mod:`repro_torch.runtime.placement`), enqueues each shard's
command stream on its pseudo-channel's engine, and reports *makespan*
semantics: channels run asynchronously, so wall-clock time is the maximum
per-channel busy time, never the sum.

Per-channel busy time models transfer/compute overlap the way a
double-buffered host DMA behaves on real PIM parts (PrIM's lesson that
host<->PIM traffic dominates unless overlapped):

    busy = lead_in + max(compute, h2d - lead_in) + d2h

where ``lead_in`` is the transfer time of the channel's *first* operand
tile pair (nothing to overlap with yet), the remaining input traffic
streams behind compute, and results drain after the last PEP retires.
``PIMRuntime(overlap=False)`` switches to the synchronous-DMA comparison
model instead: ``busy = h2d + compute + d2h`` — nothing overlaps, the
PrIM-style worst case (identical ledgers, only busy time differs).

The runtime drives either one :class:`PIMStack` or a multi-stack
:class:`~repro_torch.runtime.cluster.PIMCluster` (``PIMRuntime(stacks=N)``).
Placement then grows a leading stack axis — flat-channel geometry is
unchanged at fixed total channels (makespan parity) — and traffic that
crosses stacks is additionally charged on the cluster's shared host
link: operand boxes shipped to more than one stack within an op, and
K-split partial drains whose reduction group spans stacks.  Per-op
``stack=`` restricts the decomposition to one stack (the decode-offload
regime: each layer's weights live on their home stack).  Single-stack
runs never touch the link — their ledgers and traces are byte-identical
to a bare stack.

Operands may be host arrays (shipped in full every op, the one-shot
default) or :class:`~repro_torch.runtime.residency.DeviceTensor` handles whose
shards already live on their channels: resident regions charge **zero**
h2d (a ``reuse`` event keeps the trace replayable), misses transfer and
become resident for the next op.  ``keep_output=True`` leaves exact-cover
output shards resident instead of draining them — the d2h is deferred to
:meth:`DeviceTensor.to_host` and skipped entirely when a chained op
consumes the handle in place (element-wise epilogue fusion).

Shards that split K produce FP16 partial products; the scheduler ships
each partial back to the host (accounted as d2h traffic) and reduces them
in ascending-k order — the host-side reduction that balanced placement
trades for utilization.  Partial output shards therefore always drain,
even under ``keep_output``: the reduced value only exists on the host.

Both execution modes charge *identical* ledgers (property-tested), and
each has a fast path and a reference path:

* ``execute=True``  — numerics run on each channel's :class:`AMEEngine`
  (order-exact FP16); output-space placements are bit-exact with a
  single-channel run, with or without residency.  The default
  ``engine="batched"`` executor runs each whole shard as one fold
  (:func:`repro_torch.core.engine.gemm_on_engine_batched`), bit-exact with
  the per-tile ``engine="tiled"`` reference walk.
* ``execute=False`` — analytic: only the cost model runs, for large-shape
  sweeps (the benchmark channel-scaling and residency sections).  Shards
  are charged via closed-form tile-count formulas
  (:func:`repro_torch.core.cost.gemm_shard_cost`) in O(1) per shard; the
  per-tile generator walk remains available as ``engine="tiled"`` and
  charges bit-identical ledgers.

Both fast paths record one :class:`~repro_torch.core.engine.ShardSpan` per
shard instead of per-tile instruction records; the trace emitter expands
spans back to the identical per-tile command stream, so
``emit_trace``/``parse_trace`` round-trips are unchanged.

``PIMRuntime(async_mode=True)`` layers the dependency-aware timeline of
:mod:`repro_torch.runtime.timeline` on top: ops return :class:`OpHandle`
futures instead of ``(out, report)``, dependencies are inferred from
resident :class:`DeviceTensor` reads/writes (plus explicit ``after=``
edges), and each op's per-channel busy intervals start at ``max(dep
retire, channel free, link free)`` instead of a global barrier — so
independent ops interleave on disjoint channels and host-link windows
block only their dependents.  Ops may also target an explicit channel
subset (``channels=``), the lever the async decode offload uses to run
q/k/v and gate/up concurrently on one stack.  Ledgers, numerics, and
traces are unchanged by async mode (the timeline adds only
replay-neutral ``# TSTART``/``# TEND`` trace markers); with the default
``async_mode=False`` nothing here runs at all.

Port of ``repro.runtime.scheduler``.  The engines compute on the
runtime's ``device`` (the card unless the caller passes another): host
operands (numpy arrays or tensors) are rounded to FP16 once per executed
op and moved there, a :class:`DeviceTensor`'s mirror already lives
there, and results are float16 tensors on it.  The ledgers, reports and
traces are the reference's, ``==`` and byte for byte, with or without
an attached profiler (``profile=``) or fault plan (``faults=``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core import cost as cost_mod
from repro_torch.core.engine import (
    InstrRecord,
    ShardSpan,
    ew_on_engine,
    ew_on_engine_batched,
    ew_tiles,
    gemm_on_engine,
    gemm_on_engine_batched,
    gemm_tiles,
)
from repro_torch.core.isa import PIM_FREQ_HZ
from repro_torch.runtime.cluster import PIMCluster
from repro_torch.runtime.device import PIMDevice, PIMStack, transfer_cycles
from repro_torch.runtime.placement import Shard, cluster_shards, \
    placement_shards, stack_restricted_shards, subset_shards
from repro_torch.runtime.residency import BYTES_PER_ELEM, Box, \
    DeviceTensor, as_f16, box_bytes
from repro_torch.runtime.timeline import OpHandle, Timeline

#: shard executor modes: "batched" = whole-shard fold fast path (and
#: closed-form analytic costs); "tiled" = the per-tile reference walk
ENGINE_MODES = ("batched", "tiled")

F16 = torch.float16

#: a host array (numpy, or a tensor on any device) or a resident handle
Operand = Union[torch.Tensor, np.ndarray, DeviceTensor]


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChannelReport:
    """One pseudo-channel's share of an op.

    ``channel`` is the cluster-flat id; ``stack`` the owning stack (0 on
    a bare single stack).  ``overlap=False`` reports the synchronous-DMA
    busy model (nothing overlaps) instead of the double-buffered default.
    """

    channel: int
    compute_cycles: float
    flops: int
    commands: int
    h2d_bytes: int
    d2h_bytes: int
    h2d_cycles: int
    d2h_cycles: int
    lead_in_cycles: int
    reuse_bytes: int = 0    # h2d avoided by cross-op operand residency
    dedupe_bytes: int = 0   # h2d avoided by within-op slice dedupe
    stack: int = 0          # owning stack (leading placement axis)
    spill_bytes: int = 0    # residency evicted under a capacity bound
    overlap: bool = True    # transfer/compute overlap model in effect

    @property
    def busy_cycles(self) -> float:
        """Wall-clock busy time under the overlap model (module docstring)."""
        if self.compute_cycles == 0 and self.h2d_cycles == 0 \
                and self.d2h_cycles == 0:
            return 0.0
        if not self.overlap:           # synchronous DMA: strict sequence
            return self.h2d_cycles + self.compute_cycles + self.d2h_cycles
        stream = max(self.compute_cycles, self.h2d_cycles
                     - self.lead_in_cycles)
        return self.lead_in_cycles + stream + self.d2h_cycles

    def utilization(self, makespan: float) -> float:
        """Fraction of the op's wall-clock this channel spent computing."""
        return self.compute_cycles / makespan if makespan else 0.0


@dataclasses.dataclass(frozen=True)
class RuntimeReport:
    """Device-level account of one scheduled op.

    ``stacks`` / ``host_link_bytes`` / ``host_link_cycles`` account the
    cluster dimension: inter-stack traffic over the shared host link
    (always 0 on a single stack).  :attr:`makespan_cycles` keeps its
    per-channel meaning — fixed-total-channel cluster reshapes are
    makespan-parity — while :attr:`cluster_makespan_cycles` folds the
    link in as a second serialization axis.
    """

    op: str
    shape: Tuple[int, ...]
    placement: str
    channels: int                     # pseudo-channels the op decomposed over
    per_channel: Tuple[ChannelReport, ...]
    stacks: int = 1                   # stacks behind the runtime
    host_link_bytes: int = 0          # inter-stack bytes over the host link
    host_link_cycles: int = 0
    # fail-stopped flat channel ids at dispatch time (repro_torch.faults)
    # — non-empty reports ran degraded, on the surviving decomposition
    failed_channels: Tuple[int, ...] = ()

    @property
    def makespan_cycles(self) -> float:
        return max((c.busy_cycles for c in self.per_channel), default=0.0)

    @property
    def cluster_makespan_cycles(self) -> float:
        """Makespan with the shared host link as a serialization axis."""
        return max(self.makespan_cycles, float(self.host_link_cycles))

    @property
    def total_flops(self) -> int:
        return sum(c.flops for c in self.per_channel)

    @property
    def total_commands(self) -> int:
        return sum(c.commands for c in self.per_channel)

    @property
    def total_bytes(self) -> int:
        return sum(c.h2d_bytes + c.d2h_bytes for c in self.per_channel)

    @property
    def total_h2d_bytes(self) -> int:
        return sum(c.h2d_bytes for c in self.per_channel)

    @property
    def total_d2h_bytes(self) -> int:
        return sum(c.d2h_bytes for c in self.per_channel)

    @property
    def total_reuse_bytes(self) -> int:
        """H2d traffic avoided by cross-op operand residency — on a
        resident-weights op this equals exactly the weight shard bytes."""
        return sum(c.reuse_bytes for c in self.per_channel)

    @property
    def total_dedupe_bytes(self) -> int:
        """H2d traffic avoided by within-op repeated-slice dedupe (charged
        identically on fresh and resident paths)."""
        return sum(c.dedupe_bytes for c in self.per_channel)

    @property
    def total_spill_bytes(self) -> int:
        """Residency bytes evicted under per-channel capacity bounds
        during this op (the re-ship exposure, not charged traffic)."""
        return sum(c.spill_bytes for c in self.per_channel)

    @property
    def flop_per_cycle(self) -> float:
        """Effective throughput at makespan (the scaling headline).

        0.0 for empty/degenerate ops — guarded like
        :meth:`ChannelReport.utilization`, so fully-resident no-transfer
        no-compute reports never divide by zero.
        """
        mk = self.makespan_cycles
        return self.total_flops / mk if mk else 0.0

    @property
    def gflops(self) -> float:
        return self.flop_per_cycle * PIM_FREQ_HZ / 1e9

    @property
    def seconds(self) -> float:
        return self.makespan_cycles / PIM_FREQ_HZ

    def utilizations(self) -> List[float]:
        mk = self.makespan_cycles
        return [c.utilization(mk) for c in self.per_channel]

    def summary(self) -> str:
        # empty per_channel yields a degenerate all-zero line instead of
        # min()/max() raising — guarded like flop_per_cycle
        us = self.utilizations() or [0.0]
        busy = [c for c in self.per_channel if c.busy_cycles > 0]
        line = (f"{self.op} {'x'.join(map(str, self.shape))} "
                f"[{self.placement}, {self.channels}ch, {len(busy)} busy]: "
                f"makespan={self.makespan_cycles:.0f}cyc "
                f"{self.gflops:.1f}GFLOP/s "
                f"util(min/mean/max)={min(us):.2f}/"
                f"{sum(us) / len(us):.2f}/{max(us):.2f} "
                f"bytes={self.total_bytes} reuse={self.total_reuse_bytes}")
        if self.stacks > 1:           # single-stack summaries are unchanged
            line += (f" stacks={self.stacks} "
                     f"link_bytes={self.host_link_bytes}")
            # the cluster dimension, self-describing: how serialized the
            # shared link is against the channel makespan, and where the
            # residency machinery moved (or refused to move) bytes
            cmk = self.cluster_makespan_cycles
            link_util = self.host_link_cycles / cmk if cmk else 0.0
            line += (f"\n  cluster: makespan={cmk:.0f}cyc "
                     f"link_cycles={self.host_link_cycles} "
                     f"link_util={link_util:.2f} "
                     f"reuse={self.total_reuse_bytes} "
                     f"dedupe={self.total_dedupe_bytes} "
                     f"spill={self.total_spill_bytes}")
        if self.failed_channels:
            # degraded-makespan section: the op ran on the surviving
            # decomposition, so makespan above IS the degraded figure
            line += (f"\n  degraded: failed_channels="
                     f"{list(self.failed_channels)} "
                     f"surviving={self.channels}ch "
                     f"makespan={self.makespan_cycles:.0f}cyc")
        return line


# ---------------------------------------------------------------------------
# The runtime
# ---------------------------------------------------------------------------


def _unwrap(x: Operand, stack: PIMStack
            ) -> Tuple[Optional[DeviceTensor], object, Tuple[int, int]]:
    """Split an operand into (handle, values, shape): a handle's float16
    mirror, or the host array as given (converted only when an op
    executes, so analytic ops take 0-strided views as they are)."""
    if isinstance(x, DeviceTensor):
        assert x.stack is stack, \
            "DeviceTensor was placed on a different runtime's stack; " \
            "residency does not transfer between stacks"
        return x, x.values, x.shape
    return None, x, tuple(x.shape)


class PIMRuntime:
    """Schedules ops onto a :class:`PIMStack` (or a multi-stack
    :class:`PIMCluster`) and accounts them.

    ``engine`` selects the default shard executor: ``"batched"`` (fast,
    whole-shard fold / closed-form analytic) or ``"tiled"`` (the per-tile
    reference).  Both are bit-exact and charge identical ledgers; per-op
    ``engine=`` overrides the default.

    ``stacks > 1`` builds a :class:`PIMCluster` of ``stacks`` x
    ``channels`` pseudo-channels behind one shared host link; ``stack=``
    also accepts a pre-built cluster.  ``overlap=False`` switches busy
    time to the synchronous-DMA model (no transfer/compute overlap);
    ``capacity_bytes`` bounds each channel's residency table (LRU
    eviction counted as spill).

    ``async_mode=True`` attaches the dependency-aware
    :class:`~repro_torch.runtime.timeline.Timeline`: ops return
    :class:`~repro_torch.runtime.timeline.OpHandle` futures (``.result`` /
    ``.report`` carry what the serialized mode returns), start times
    respect inferred DeviceTensor dependencies plus explicit ``after=``
    edges, and ``self.timeline.now`` is the async wall-clock.  Ledgers
    and traces stay identical to serialized mode.

    ``device`` is where every channel's engine holds its tiles and runs
    the numerics, and where results land: the card unless the caller
    passes another device (an explicit ``stack=`` brings its own).
    ``metrics=`` takes a :class:`~repro_torch.obs.metrics.MetricsRegistry`,
    ``profile=`` a :class:`~repro_torch.obs.profile.Profiler` (or True),
    ``faults=`` a :class:`~repro_torch.faults.plan.FaultPlan` or its DSL.
    """

    def __init__(self, channels: int = 1, stack: Optional[PIMStack] = None,
                 engine: str = "batched", stacks: int = 1,
                 overlap: bool = True,
                 capacity_bytes: Optional[int] = None,
                 async_mode: bool = False,
                 link_topology: str = "shared",
                 metrics=None, profile=None, faults=None, device=None):
        assert engine in ENGINE_MODES, engine
        if stack is not None:
            if stacks != 1 or capacity_bytes is not None \
                    or link_topology != "shared" or device is not None:
                raise ValueError(
                    "stacks=/capacity_bytes=/link_topology=/device= "
                    "configure a runtime-built stack and are ignored with "
                    "an explicit stack= — build the PIMCluster/PIMStack "
                    "with them instead")
            self.stack = stack
        elif stacks > 1:
            self.stack = PIMCluster(stacks, channels,
                                    capacity_bytes=capacity_bytes,
                                    link_topology=link_topology,
                                    device=device)
        else:
            self.stack = PIMStack(channels, capacity_bytes=capacity_bytes,
                                  device=device)
        self.device = self.stack.torch_device
        self.engine = engine
        self.overlap = overlap
        self._cluster = self.stack if isinstance(self.stack, PIMCluster) \
            else None
        self.async_mode = async_mode
        self.timeline: Optional[Timeline] = \
            Timeline(self.stack, self._cluster) if async_mode else None
        # dep inference: tensor uid -> the OpHandle that last wrote it
        # (place uploads and keep_output results); readers wait on it
        self._writers: Dict[int, OpHandle] = {}
        # -- observability (repro_torch.obs), strictly additive: both
        # hooks only *read* finished reports/ledgers, so traces, ledgers
        # and numerics are untouched when either is attached, and nothing
        # below runs at all when both stay None (the default)
        self.metrics = metrics
        if metrics is not None and self._cluster is not None:
            for link in self._cluster.all_links():
                link.metrics = metrics
        self.profile = None
        if profile:
            from repro_torch.obs.profile import Profiler
            prof = Profiler() if profile is True else profile
            self.profile = prof.attach(self)
        # -- fault injection (repro_torch.faults), same additive
        # discipline: an attached *empty* plan leaves ledgers ==-equal and
        # traces byte-identical, and with faults=None nothing below runs
        self.faults = None
        if faults is not None:
            from repro_torch.faults.injector import FaultInjector
            from repro_torch.faults.plan import as_plan
            self.faults = FaultInjector(as_plan(faults), self)
            if self._cluster is not None:
                # per-link routing: every ledger (shared/uplink and each
                # per-stack link on a switched cluster) gets the hook, so
                # retries/degradation land on the link that carried the
                # bytes
                for link in self._cluster.all_links():
                    link.faults = self.faults

    # -- internals -----------------------------------------------------------

    def _engine_mode(self, override: Optional[str]) -> str:
        mode = self.engine if override is None else override
        assert mode in ENGINE_MODES, mode
        return mode

    @property
    def n_stacks(self) -> int:
        return self._cluster.n_stacks if self._cluster else 1

    def _shards(self, placement: str, m: int, k: int, n: int,
                stack: Optional[int],
                channels: Optional[Sequence[int]] = None
                ) -> Tuple[Shard, ...]:
        """Resolve the op's shard decomposition, stack axis included.

        ``channels`` restricts the op to an explicit subset of flat
        channel ids (the async concurrent-group regime); ``stack``
        restricts to one whole stack of a cluster.  They are mutually
        exclusive.
        """
        if channels is not None:
            if stack is not None:
                raise ValueError(
                    "pass stack= or channels=, not both — a channel "
                    "subset already pins the op's devices")
            chans = tuple(sorted(channels))
            total = len(self.stack)
            if not chans or not all(0 <= c < total for c in chans):
                raise ValueError(
                    f"channel subset {chans} out of range for "
                    f"{total} flat channels")
            cps = self._cluster.channels_per_stack if self._cluster \
                else len(self.stack)
            return subset_shards(placement, m, k, n, chans, cps)
        if self._cluster is None:
            if stack is not None:
                raise ValueError(
                    "stack= requires a multi-stack runtime "
                    "(PIMRuntime(stacks=N) or an explicit PIMCluster)")
            return placement_shards(placement, m, k, n, len(self.stack))
        cps = self._cluster.channels_per_stack
        if stack is None:
            return cluster_shards(placement, m, k, n,
                                  self._cluster.n_stacks, cps)
        if not 0 <= stack < self._cluster.n_stacks:
            raise ValueError(
                f"stack {stack} out of range for a "
                f"{self._cluster.n_stacks}-stack cluster")
        return stack_restricted_shards(placement, m, k, n, stack, cps)

    def _flat(self, s: Shard) -> int:
        """Cluster-flat channel id of a shard's (stack, channel)."""
        if self._cluster is None:
            return s.channel
        return self._cluster.flat(s.stack, s.channel)

    def _link_charge_ship(self, key, stack_idx: int, nbytes: int,
                          link_seen: Dict) -> None:
        """Charge the host link when an operand box crosses stacks.

        Shared topology: every copy of the same box beyond its first
        stack's is inter-stack — one ``xstack`` charge per extra
        destination on the shared link.  Switched topology: the switch
        *multicasts*, so a replicated box is read out of its source
        stack once — one ``xstack`` charge on the source stack's link
        when the first extra destination appears, further destinations
        free.  ``link_seen`` tracks each box's destination stacks in
        first-landed order across the op.
        """
        if self._cluster is None:
            return
        seen = link_seen.setdefault(key, [])
        if seen and stack_idx not in seen:
            if self._cluster.links is not None:
                if len(seen) == 1:      # multicast: source reads out once
                    self._cluster.link_for(seen[0]).charge("xstack", nbytes)
            else:
                self._cluster.link.charge("xstack", nbytes)
        if stack_idx not in seen:
            seen.append(stack_idx)

    def _record_instrs(self, dev: PIMDevice, n_before: int) -> None:
        for rec in dev.engine.instrs[n_before:]:
            dev.events.append(("instr", rec))

    def _link_before(self) -> Tuple:
        """Pre-op link snapshot: (total bytes, total cycles) over every
        link ledger, plus — switched topology only — the per-link cycle
        clocks the async submit path splits its occupancy dict from."""
        if self._cluster is None:
            return (0, 0, None)
        b, c = self._cluster.link_totals()
        per = (tuple(l.cycles for l in self._cluster.all_links())
               if self._cluster.links is not None else None)
        return (b, c, per)

    def _link_cycles_async(self, total_cycles: int, link_before: Tuple):
        """The ``link_cycles`` argument for :meth:`Timeline.submit`: the
        op's total link occupancy on a shared topology, or a
        ``{stack|None: cycles}`` per-link delta dict on a switched one
        (``None`` keys the switch uplink)."""
        per_before = link_before[2] if len(link_before) > 2 else None
        if per_before is None:
            return total_cycles
        delta = {}
        for i, link in enumerate(self._cluster.all_links()):
            d = link.cycles - per_before[i]
            if d > 0:
                delta[None if i == 0 else i - 1] = d
        return delta

    def _op_devices(self, stack: Optional[int],
                    channels: Optional[Sequence[int]] = None
                    ) -> List[PIMDevice]:
        """Devices participating in an op: the explicit subset under a
        ``channels=`` restriction, one stack's under ``stack=``, the
        whole stack/cluster otherwise — so restricted ops snapshot and
        report only the channels that can do work."""
        if channels is not None:
            return [self.stack[c] for c in sorted(channels)]
        if stack is None or self._cluster is None:
            return list(self.stack)
        return self._cluster.stacks[stack].devices

    def _note_op(self, report: RuntimeReport) -> None:
        """Fold one finished op's report into the metrics registry."""
        m = self.metrics
        m.counter("runtime.ops", unit="ops",
                  help="ops scheduled (gemm/gemv/elementwise)").inc()
        m.counter("runtime.flops", unit="flop",
                  help="FLOPs executed across channels").inc(
            report.total_flops)
        m.counter("runtime.commands", unit="commands",
                  help="PIM column commands issued").inc(
            report.total_commands)
        m.counter("runtime.h2d_bytes", unit="bytes",
                  help="host->PIM bytes actually transferred").inc(
            report.total_h2d_bytes)
        m.counter("runtime.d2h_bytes", unit="bytes",
                  help="PIM->host bytes actually transferred").inc(
            report.total_d2h_bytes)
        m.counter("runtime.reuse_bytes", unit="bytes",
                  help="h2d avoided by cross-op residency").inc(
            report.total_reuse_bytes)
        m.counter("runtime.dedupe_bytes", unit="bytes",
                  help="h2d avoided by within-op slice dedupe").inc(
            report.total_dedupe_bytes)
        m.counter("runtime.spill_bytes", unit="bytes",
                  help="residency evicted under capacity bounds").inc(
            report.total_spill_bytes)
        m.histogram("runtime.op_makespan_cycles", unit="cycles",
                    help="per-op cluster makespan distribution").record(
            report.cluster_makespan_cycles)

    def _fault_epilogue(self, report: RuntimeReport,
                        out_handle: Optional[DeviceTensor]) -> None:
        """Per-op fault-injector bookkeeping: register kept outputs for
        pinned-output replay (with their producer busy cycles), advance
        the serialized fault clock, and close the op's lost-uid window."""
        inj = self.faults
        if out_handle is not None and out_handle.pending_d2h:
            inj.register(out_handle)
            busy_by = {c.channel: c.busy_cycles for c in report.per_channel}
            for ch, _box in out_handle.pending_d2h:
                inj.note_output(out_handle.uid, ch, busy_by.get(ch, 0.0))
        if self.timeline is None:
            inj.advance(report.cluster_makespan_cycles)
        inj.end_op()

    def _submit_async(self, name: str, busy: Dict[int, float],
                      link_cycles: int, marks: Dict[int, int],
                      reads: Sequence[int], writes: Sequence[int],
                      after: Optional[Sequence[OpHandle]],
                      report: Optional[RuntimeReport],
                      result) -> OpHandle:
        """Register one executed op on the timeline (async mode only).

        ``marks`` holds each participating device's event-stream length
        from before the op ran — the insertion point for the op's
        ``# TSTART`` marker, so timestamps wrap exactly the events the
        op appended and stripping them recovers the serialized trace
        byte-for-byte.
        """
        deps: List[OpHandle] = []
        seen: Set[int] = set()
        for h in [self._writers.get(uid) for uid in reads] \
                + list(after or ()):
            if h is not None and h.op_id not in seen:
                deps.append(h)
                seen.add(h.op_id)
        handle = self.timeline.submit(name, busy, link_cycles, deps,
                                      report=report, result=result)
        for uid in writes:
            self._writers[uid] = handle
        for ch, (start, b) in handle.spans.items():
            dev = self.stack[ch]
            dev.events.insert(marks[ch], ("tstart", (handle.op_id, start)))
            dev.events.append(("tend", (handle.op_id, start + b)))
        return handle

    def _finish(self, op: str, shape: Tuple[int, ...], placement: str,
                before: Dict[int, "object"],
                lead_in: Dict[int, int],
                link_before: Tuple[int, int] = (0, 0),
                devices: Optional[List[PIMDevice]] = None) -> RuntimeReport:
        devs = list(self.stack) if devices is None else devices
        reports = []
        for dev in devs:
            b = before[dev.channel_id]
            reports.append(ChannelReport(
                channel=dev.channel_id,
                compute_cycles=dev.compute_cycles - b.cycles,
                flops=dev.compute_flops - b.flops,
                commands=dev.compute_commands - b.commands,
                h2d_bytes=dev.xfer.h2d_bytes - b.h2d_bytes,
                d2h_bytes=dev.xfer.d2h_bytes - b.d2h_bytes,
                h2d_cycles=dev.xfer.h2d_cycles - b.h2d_cycles,
                d2h_cycles=dev.xfer.d2h_cycles - b.d2h_cycles,
                lead_in_cycles=lead_in.get(dev.channel_id, 0),
                reuse_bytes=dev.reuse_bytes - b.reuse_bytes,
                dedupe_bytes=dev.dedupe_bytes - b.dedupe_bytes,
                stack=(self._cluster.stack_of(dev.channel_id)
                       if self._cluster else 0),
                spill_bytes=dev.spill_bytes - b.spill_bytes,
                overlap=self.overlap))
        lb, lc = self._link_before()[:2]
        return RuntimeReport(
            op=op, shape=shape, placement=placement,
            channels=len(devs),       # == the decomposition width
            per_channel=tuple(reports),
            stacks=self.n_stacks,
            host_link_bytes=lb - link_before[0],
            host_link_cycles=lc - link_before[1],
            failed_channels=(tuple(sorted(self.faults.failed))
                             if self.faults is not None
                             and self.faults.failed else ()))

    def _ship_in(self, dev: PIMDevice, handle: Optional[DeviceTensor],
                 box: Box, shipped: Dict[int, Set], role: str,
                 link_seen: Optional[Dict] = None) -> bool:
        """Charge one operand shard's h2d unless resident or already
        shipped to this channel within the current op.  Returns whether
        bytes actually moved (for the lead-in computation).

        Misses on a handle transfer *and* mark resident, so repeated ops
        converge to zero traffic; plain arrays dedupe only within the op
        (the GEMV x-vector shipped once per channel, not once per K-split
        shard).  On a cluster, a box that actually moves to channels of
        more than one stack additionally charges the host link for every
        stack beyond its first (``link_seen`` tracks per-operand boxes
        across the op).
        """
        nbytes = box_bytes(box)
        if handle is not None:
            if handle.is_resident(dev.channel_id, box):
                dev.note_reuse(nbytes)
                return False
            dev.host_to_pim(nbytes)
            if self.faults is not None:
                # a miss whose residency was lost to a channel failure is
                # recovery traffic: the host link re-carries it on clusters
                self.faults.on_reship(dev, handle.uid, nbytes)
            if link_seen is not None:
                self._link_charge_ship(
                    (role, handle.uid, box),
                    self._cluster.stack_of(dev.channel_id), nbytes,
                    link_seen)
            handle.mark_resident(dev.channel_id, box)
            return True
        seen = shipped.setdefault(dev.channel_id, set())
        key = (role, box)
        if key in seen:
            dev.note_dedupe(nbytes)
            return False
        dev.host_to_pim(nbytes)
        if link_seen is not None:
            self._link_charge_ship(
                (role, None, box),
                self._cluster.stack_of(dev.channel_id), nbytes, link_seen)
        seen.add(key)
        return True

    # -- operand placement (the residency entry point) -----------------------

    def place(self, array, *, placement: str = "balanced", role: str = "A",
              other_dim: int = 1,
              stack: Optional[int] = None,
              channels: Optional[Sequence[int]] = None) -> DeviceTensor:
        """Upload an array's shards onto the stack; returns a resident
        :class:`DeviceTensor` handle.

        The placement decides the per-channel decomposition using the op
        geometry the tensor will serve in: ``role="A"`` treats the array
        as the (M, K) left/element-wise operand of ops with
        ``N = other_dim`` (the resident-weights GEMV regime); ``role="B"``
        as the (K, N) right operand with ``M = other_dim``.  The one-time
        h2d is charged now, on each shard's channel; subsequent ops with a
        matching placement geometry charge zero h2d for this operand.

        Pass a ``(rows, cols)`` tuple instead of an array for an analytic
        (shape-only) handle usable with ``execute=False`` sweeps.  On a
        multi-stack runtime, ``stack=`` pins the whole tensor to one
        stack (consume it with the same ``stack=`` on ops); the default
        spreads shards over every stack, charging the host link where a
        replicated box lands on more than one stack.  ``channels=`` pins
        the tensor to an explicit flat-channel subset instead (consume
        it with the same ``channels=`` on ops); on an async runtime the
        upload itself becomes a timeline op, so every consumer of the
        handle starts after the weights have landed.
        """
        if isinstance(array, tuple):
            arr, shape = None, tuple(array)
        else:
            arr = array if isinstance(array, torch.Tensor) \
                else np.asarray(array, np.float16)
            shape = tuple(arr.shape)
        if len(shape) != 2:
            raise ValueError(
                f"PIMRuntime.place expects a 2D array or a (rows, cols) "
                f"shape tuple, got shape {shape} — reshape/flatten to 2D "
                f"(e.g. arr.reshape(rows, -1)) before placing")
        if self.faults is not None:
            stack, channels = self.faults.on_op(stack, channels)
        handle = DeviceTensor(self.stack, shape, values=arr)
        if role == "A":
            m, k = shape
            shards = self._shards(placement, m, k, other_dim, stack,
                                  channels)
            boxes = [(s, s.a_box) for s in shards]
        elif role == "B":
            k, n = shape
            shards = self._shards(placement, other_dim, k, n, stack,
                                  channels)
            boxes = [(s, s.b_box) for s in shards]
        else:
            raise ValueError(f"role must be 'A' or 'B', got {role!r}")
        op_devs = self._op_devices(stack, channels)
        marks = {d.channel_id: len(d.events) for d in op_devs}
        before_h2d = {d.channel_id: d.xfer.h2d_cycles for d in op_devs}
        before_h2d_bytes = {d.channel_id: d.xfer.h2d_bytes
                            for d in op_devs} \
            if self.metrics is not None else None
        link_before = self._link_before()
        link_seen: Dict = {}
        for s, box in boxes:
            flat = self._flat(s)
            if handle.is_resident(flat, box):    # replicated shard geometry
                continue
            self.stack[flat].host_to_pim(box_bytes(box))
            if self._cluster is not None:
                self._link_charge_ship((role, handle.uid, box), s.stack,
                                       box_bytes(box), link_seen)
            handle.mark_resident(flat, box)
        if self.metrics is not None:
            self.metrics.counter(
                "runtime.place_ops", unit="ops",
                help="operand placements (weight uploads)").inc()
            self.metrics.counter(
                "runtime.upload_bytes", unit="bytes",
                help="one-time h2d charged by place()").inc(
                sum(d.xfer.h2d_bytes - before_h2d_bytes[d.channel_id]
                    for d in op_devs))
        if self.faults is not None:
            if self.timeline is None:
                self.faults.advance(max(
                    max((float(d.xfer.h2d_cycles - before_h2d[d.channel_id])
                         for d in op_devs), default=0.0),
                    float(self._link_before()[1] - link_before[1])))
            self.faults.end_op()
        if self.timeline is not None:
            busy = {d.channel_id:
                    float(d.xfer.h2d_cycles - before_h2d[d.channel_id])
                    for d in op_devs}
            self._submit_async(
                "place", busy,
                self._link_cycles_async(
                    self._link_before()[1] - link_before[1], link_before),
                marks,
                reads=(), writes=(handle.uid,), after=None,
                report=None, result=handle)
        elif self.profile is not None:
            self.profile.on_op(
                "place",
                {d.channel_id:
                 float(d.xfer.h2d_cycles - before_h2d[d.channel_id])
                 for d in op_devs},
                self._link_before()[1] - link_before[1])
        return handle

    # -- GEMM / GEMV ---------------------------------------------------------

    def gemm(self, a: Operand, b: Operand, *,
             placement: str = "row-striped",
             execute: bool = True,
             keep_output: bool = False,
             engine: Optional[str] = None,
             stack: Optional[int] = None,
             channels: Optional[Sequence[int]] = None,
             after: Optional[Sequence[OpHandle]] = None
             ) -> Union[Tuple[Optional[Union[torch.Tensor, DeviceTensor]],
                              RuntimeReport], OpHandle]:
        """C = A(m,k) @ B(k,n) partitioned across the stack's channels.

        ``a``/``b`` may be host arrays or resident :class:`DeviceTensor`
        handles.  With ``keep_output=True`` the result is returned as a
        resident handle (exact-cover output shards stay on their channels;
        K-split partials still drain for the host reduction) instead of a
        host array.  ``engine`` overrides the runtime's shard executor
        ("batched"/"tiled") for this op.  On a multi-stack runtime,
        ``stack=`` restricts the op to one stack's channels; the default
        decomposes over every stack and charges inter-stack traffic on
        the host link.  ``channels=`` restricts to an explicit flat
        channel subset instead (concurrent-group regime).

        On an async runtime the call returns an :class:`OpHandle`
        (``.result`` / ``.report`` carry this tuple's values) whose
        timeline start respects inferred DeviceTensor dependencies plus
        the explicit ``after=`` handles; serialized runtimes ignore
        ``after=`` (program order already implies it).
        """
        mode = self._engine_mode(engine)
        ah, a_vals, (m, k) = _unwrap(a, self.stack)
        bh, b_vals, (k2, n) = _unwrap(b, self.stack)
        assert k == k2, ((m, k), (k2, n))
        assert not execute or (a_vals is not None and b_vals is not None), \
            "analytic (shape-only) DeviceTensor operands require " \
            "execute=False"
        if self.faults is not None:
            # fire due fault events, then decompose over survivors only
            stack, channels = self.faults.on_op(stack, channels)
        if execute:
            a_vals, b_vals = (as_f16(v, self.device) for v in (a_vals, b_vals))
        shards = self._shards(placement, m, k, n, stack, channels)

        op_devs = self._op_devices(stack, channels)
        marks = {d.channel_id: len(d.events) for d in op_devs}
        before = {d.channel_id: d.snapshot() for d in op_devs}
        link_before = self._link_before()
        lead_in: Dict[int, int] = {}
        shipped: Dict[int, Set] = {}
        link_seen: Optional[Dict] = {} if self._cluster else None
        out = torch.zeros((m, n), dtype=F16, device=self.device) \
            if execute else None
        out_handle = DeviceTensor(self.stack, (m, n), values=out,
                                  copy=False) if keep_output else None
        partials: Dict[Tuple[int, int, int, int],
                       List[Tuple[int, torch.Tensor]]] = {}
        # K-split reduction groups: out_box -> [(stack, drained bytes)] in
        # dispatch order, for the cross-stack host-link gather charge
        drain_groups: Dict[Tuple[int, int, int, int],
                           List[Tuple[int, int]]] = {}

        for s in shards:
            flat = self._flat(s)
            dev = self.stack[flat]
            a_ships = self._ship_in(dev, ah, s.a_box, shipped, "A",
                                    link_seen)
            b_ships = self._ship_in(dev, bh, s.b_box, shipped, "B",
                                    link_seen)
            if flat not in lead_in:
                i0, i1, j0, j1, c0, c1 = next(gemm_tiles(s.rows, s.ks, s.ns))
                first = ((i1 - i0) * (c1 - c0) if a_ships else 0) \
                    + ((c1 - c0) * (j1 - j0) if b_ships else 0)
                lead_in[flat] = transfer_cycles(first * BYTES_PER_ELEM)
            if execute:
                n_before = len(dev.engine.instrs)
                run = gemm_on_engine_batched if mode == "batched" \
                    else gemm_on_engine
                sub = run(dev.engine,
                          a_vals[s.m0:s.m1, s.k0:s.k1],
                          b_vals[s.k0:s.k1, s.n0:s.n1])
                self._record_instrs(dev, n_before)
                if s.is_partial(k):
                    partials.setdefault((s.m0, s.m1, s.n0, s.n1), []) \
                        .append((s.k0, sub))
                else:
                    out[s.m0:s.m1, s.n0:s.n1] = sub
            elif mode == "batched":
                # closed-form: O(1) per shard, bit-identical to the walk
                agg = cost_mod.gemm_shard_cost(s.rows, s.ks, s.ns)
                dev.charge_analytic(agg.cycles, agg.flops, agg.commands)
                dev.events.append(
                    ("instr", ShardSpan("mac", s.rows, s.ks, s.ns)))
            else:
                for i0, i1, j0, j1, c0, c1 in gemm_tiles(s.rows, s.ks, s.ns):
                    rep = cost_mod.mfmacc_cost(i1 - i0, c1 - c0, j1 - j0)
                    dev.charge_analytic(rep.cycles, rep.flops, rep.commands)
                    dev.events.append(
                        ("instr",
                         InstrRecord("mac", i1 - i0, c1 - c0, j1 - j0)))
            # an output shard stays on-channel only if residency actually
            # records it (a capacity bound may refuse); otherwise it
            # drains now like any result, so ledger and trace stay
            # consistent with what the host really received
            kept = keep_output and not s.is_partial(k) \
                and out_handle.mark_resident(flat, s.out_box, pin=True)
            if kept:
                out_handle.pending_d2h.append((flat, s.out_box))
            else:
                drained = s.rows * s.ns * BYTES_PER_ELEM   # C / partial
                dev.pim_to_host(drained)
                if s.is_partial(k) and self._cluster is not None:
                    drain_groups.setdefault(s.out_box, []) \
                        .append((s.stack, drained))

        # K-split reduction groups spanning stacks gather their partials
        # over the host link: every partial from a non-home stack (home =
        # the group's first-dispatched shard's stack) crosses it — on a
        # switched cluster, over the *sending* stack's own link (the
        # partials are distinct data, so there is nothing to multicast)
        if self._cluster is not None:
            for parts in drain_groups.values():
                home = parts[0][0]
                for st, nbytes in parts:
                    if st != home:
                        self._cluster.link_for(st).charge("drain", nbytes)

        if execute:
            # host-side reduction of K-split partials, ascending-k FP16
            for (m0, m1, n0, n1), parts in partials.items():
                acc: Optional[torch.Tensor] = None
                for _, arr in sorted(parts, key=lambda t: t[0]):
                    acc = arr if acc is None else acc + arr    # FP16 add
                out[m0:m1, n0:n1] = acc

        report = self._finish("gemm", (m, k, n), placement, before,
                              lead_in, link_before=link_before,
                              devices=op_devs)
        if self.metrics is not None:
            self._note_op(report)
        if self.faults is not None:
            self._fault_epilogue(report, out_handle)
        result = out_handle if keep_output \
            else (out if execute else None)
        if self.timeline is not None:
            return self._submit_async(
                "gemm",
                {c.channel: c.busy_cycles for c in report.per_channel},
                self._link_cycles_async(report.host_link_cycles,
                                        link_before), marks,
                reads=[h.uid for h in (ah, bh) if h is not None],
                writes=(out_handle.uid,) if keep_output else (),
                after=after, report=report, result=result)
        if self.profile is not None:
            self.profile.on_op(
                "gemm",
                {c.channel: c.busy_cycles for c in report.per_channel},
                report.host_link_cycles, report=report)
        return result, report

    def gemv(self, a: Operand, x, *,
             placement: str = "row-striped",
             execute: bool = True,
             engine: Optional[str] = None,
             stack: Optional[int] = None,
             channels: Optional[Sequence[int]] = None,
             after: Optional[Sequence[OpHandle]] = None
             ) -> Union[Tuple[Optional[torch.Tensor], RuntimeReport],
                        OpHandle]:
        """y = A @ x (the MPC-Wrapper comparison workload), as N=1 GEMM.

        ``a`` may be a resident handle (the serve-loop decode regime:
        weights placed once, only the x vector moves per call); per-channel
        x transfers are deduped across K-split shards that share a slice.
        """
        assert not isinstance(x, DeviceTensor), \
            "gemv x must be a host vector; place A instead"
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        res = self.gemm(a, x[:, None],
                        placement=placement, execute=execute,
                        engine=engine, stack=stack, channels=channels,
                        after=after)
        if isinstance(res, OpHandle):
            res.name = "gemv"
            res.report = dataclasses.replace(res.report, op="gemv")
            if res.result is not None:
                res.result = res.result[:, 0]
            return res
        y, rep = res
        rep = dataclasses.replace(rep, op="gemv")
        if self.profile is not None:
            self.profile.amend_last("gemv", rep)
        return (y[:, 0] if y is not None else None), rep

    # -- element-wise --------------------------------------------------------

    def elementwise(self, kind: str, a: Operand, b: Operand, *,
                    placement: str = "row-striped",
                    execute: bool = True,
                    keep_output: bool = False,
                    engine: Optional[str] = None,
                    stack: Optional[int] = None,
                    channels: Optional[Sequence[int]] = None,
                    after: Optional[Sequence[OpHandle]] = None
                    ) -> Union[
                        Tuple[Optional[Union[torch.Tensor, DeviceTensor]],
                              RuntimeReport], OpHandle]:
        """out = a <kind> b partitioned over the (M, C) output grid.

        Placements reuse the GEMM shard geometry with the column axis in
        the K slot and N=1; a K-split shard is just a column slab here, so
        every placement is an exact output partition (no reduction).

        Operands may be resident handles — in particular the
        ``keep_output`` handle of a previous GEMM/element-wise op on the
        same placement, in which case the chained operand never touches
        the host (epilogue fusion).  ``keep_output=True`` keeps this op's
        result resident the same way.
        """
        assert kind in ("add", "sub", "mul")
        mode = self._engine_mode(engine)
        ah, a_vals, (m, c) = _unwrap(a, self.stack)
        bh, b_vals, bshape = _unwrap(b, self.stack)
        assert (m, c) == bshape, ((m, c), bshape)
        assert not execute or (a_vals is not None and b_vals is not None), \
            "analytic (shape-only) DeviceTensor operands require " \
            "execute=False"
        if self.faults is not None:
            stack, channels = self.faults.on_op(stack, channels)
        if execute:
            a_vals, b_vals = (as_f16(v, self.device) for v in (a_vals, b_vals))
        shards = self._shards(placement, m, c, 1, stack, channels)

        op_devs = self._op_devices(stack, channels)
        marks = {d.channel_id: len(d.events) for d in op_devs}
        before = {d.channel_id: d.snapshot() for d in op_devs}
        link_before = self._link_before()
        lead_in: Dict[int, int] = {}
        shipped: Dict[int, Set] = {}
        link_seen: Optional[Dict] = {} if self._cluster else None
        out = torch.zeros((m, c), dtype=F16, device=self.device) \
            if execute else None
        out_handle = DeviceTensor(self.stack, (m, c), values=out,
                                  copy=False) if keep_output else None

        for s in shards:
            flat = self._flat(s)
            dev = self.stack[flat]
            # both operands use the (m, col) footprint: C sits in the K slot
            a_ships = self._ship_in(dev, ah, s.a_box, shipped, "A",
                                    link_seen)
            b_ships = self._ship_in(dev, bh, s.a_box, shipped, "B",
                                    link_seen)
            if flat not in lead_in:
                i0, i1, c0, c1 = next(ew_tiles(s.rows, s.ks))
                first = (i1 - i0) * (c1 - c0) * \
                    (int(a_ships) + int(b_ships))
                lead_in[flat] = transfer_cycles(first * BYTES_PER_ELEM)
            if execute:
                n_before = len(dev.engine.instrs)
                run = ew_on_engine_batched if mode == "batched" \
                    else ew_on_engine
                sub = run(dev.engine, kind,
                          a_vals[s.m0:s.m1, s.k0:s.k1],
                          b_vals[s.m0:s.m1, s.k0:s.k1])
                self._record_instrs(dev, n_before)
                out[s.m0:s.m1, s.k0:s.k1] = sub
            elif mode == "batched":
                agg = cost_mod.ew_shard_cost(kind, s.rows, s.ks)
                dev.charge_analytic(agg.cycles, agg.flops, agg.commands)
                dev.events.append(("instr", ShardSpan(kind, s.rows, s.ks)))
            else:
                for i0, i1, c0, c1 in ew_tiles(s.rows, s.ks):
                    rep = cost_mod.elementwise_cost(kind, i1 - i0, c1 - c0)
                    dev.charge_analytic(rep.cycles, rep.flops, rep.commands)
                    dev.events.append(
                        ("instr", InstrRecord(kind, i1 - i0, c1 - c0)))
            # as in gemm: only actually-resident outputs defer their drain
            if keep_output and out_handle.mark_resident(flat, s.a_box,
                                                        pin=True):
                out_handle.pending_d2h.append((flat, s.a_box))
            else:
                dev.pim_to_host(s.rows * s.ks * BYTES_PER_ELEM)

        report = self._finish(f"ew-{kind}", (m, c), placement, before,
                              lead_in, link_before=link_before,
                              devices=op_devs)
        if self.metrics is not None:
            self._note_op(report)
        if self.faults is not None:
            self._fault_epilogue(report, out_handle)
        result = out_handle if keep_output \
            else (out if execute else None)
        if self.timeline is not None:
            return self._submit_async(
                f"ew-{kind}",
                {cr.channel: cr.busy_cycles for cr in report.per_channel},
                self._link_cycles_async(report.host_link_cycles,
                                        link_before), marks,
                reads=[h.uid for h in (ah, bh) if h is not None],
                writes=(out_handle.uid,) if keep_output else (),
                after=after, report=report, result=result)
        if self.profile is not None:
            self.profile.on_op(
                f"ew-{kind}",
                {cr.channel: cr.busy_cycles for cr in report.per_channel},
                report.host_link_cycles, report=report)
        return result, report

    def softmax(self, a: DeviceTensor, *,
                placement: str = "paged",
                execute: bool = True,
                stack: Optional[int] = None,
                channels: Optional[Sequence[int]] = None,
                after: Optional[Sequence[OpHandle]] = None
                ) -> Union[Tuple[DeviceTensor, RuntimeReport], OpHandle]:
        """Column softmax (axis 0), *in place* on a resident handle — the
        attention epilogue between the score and context GEMVs.

        Cost model: exactly two mul-class elementwise passes per shard
        (the exponentiation pass, then the normalize multiply; the
        cross-page max/sum reduction rides the paper's in-memory
        accumulation dataflow and is folded into the second pass) and
        **zero transfers** — the operand is expected resident (the kept
        score output; a miss ships it in honestly and marks it) and the
        result overwrites the same resident boxes, so the probabilities
        are consumed on-device by the context GEMV without ever touching
        the host.  Numerics: FP32 softmax written back to the handle's
        FP16 host mirror (cross-checked by DecodeOffload numeric mode).
        """
        if not isinstance(a, DeviceTensor):
            raise TypeError(
                "softmax operates in place on a DeviceTensor handle "
                "(keep_output=True score GEMM result); got "
                f"{type(a).__name__}")
        m, c = a.shape
        assert not execute or a.values is not None, \
            "analytic (shape-only) DeviceTensor requires execute=False"
        if self.faults is not None:
            stack, channels = self.faults.on_op(stack, channels)
        shards = self._shards(placement, m, c, 1, stack, channels)

        op_devs = self._op_devices(stack, channels)
        marks = {d.channel_id: len(d.events) for d in op_devs}
        before = {d.channel_id: d.snapshot() for d in op_devs}
        link_before = self._link_before()
        lead_in: Dict[int, int] = {}
        shipped: Dict[int, Set] = {}
        link_seen: Optional[Dict] = {} if self._cluster else None
        for s in shards:
            flat = self._flat(s)
            dev = self.stack[flat]
            a_ships = self._ship_in(dev, a, s.a_box, shipped, "A",
                                    link_seen)
            if flat not in lead_in:
                i0, i1, c0, c1 = next(ew_tiles(s.rows, s.ks))
                lead_in[flat] = transfer_cycles(
                    (i1 - i0) * (c1 - c0) * int(a_ships) * BYTES_PER_ELEM)
            for _ in range(2):
                agg = cost_mod.ew_shard_cost("mul", s.rows, s.ks)
                dev.charge_analytic(agg.cycles, agg.flops, agg.commands)
                dev.events.append(("instr", ShardSpan("mul", s.rows, s.ks)))
            # in place: result stays resident on the same boxes, no d2h

        if execute:
            vals = a.resolve().float()
            e = torch.exp(vals - vals.amax(0, keepdim=True))
            a.values[...] = (e / e.sum(0, keepdim=True)).to(F16)

        report = self._finish("softmax", (m, c), placement, before,
                              lead_in, link_before=link_before,
                              devices=op_devs)
        if self.metrics is not None:
            self._note_op(report)
        if self.faults is not None:
            self._fault_epilogue(report, None)
        if self.timeline is not None:
            return self._submit_async(
                "softmax",
                {cr.channel: cr.busy_cycles for cr in report.per_channel},
                self._link_cycles_async(report.host_link_cycles,
                                        link_before), marks,
                reads=(a.uid,), writes=(a.uid,),
                after=after, report=report, result=a)
        if self.profile is not None:
            self.profile.on_op(
                "softmax",
                {cr.channel: cr.busy_cycles for cr in report.per_channel},
                report.host_link_cycles, report=report)
        return a, report


# ---------------------------------------------------------------------------
# Convenience entry points (the end-to-end PIM-mode API)
# ---------------------------------------------------------------------------


def pim_gemm(a, b, channels: int = 1,
             placement: str = "row-striped", execute: bool = True,
             engine: str = "batched", stacks: int = 1, device=None
             ) -> Tuple[Optional[torch.Tensor], RuntimeReport]:
    """C = A @ B entirely in PIM mode on a fresh ``channels``-wide stack
    (or ``stacks`` x ``channels`` cluster) whose engines run on
    ``device`` (the card by default)."""
    return PIMRuntime(channels=channels, engine=engine, stacks=stacks,
                      device=device).gemm(a, b, placement=placement,
                                          execute=execute)


def pim_gemv(a, x, channels: int = 1,
             placement: str = "row-striped", execute: bool = True,
             engine: str = "batched", stacks: int = 1, device=None
             ) -> Tuple[Optional[torch.Tensor], RuntimeReport]:
    """y = A @ x entirely in PIM mode on a fresh ``channels``-wide stack
    (or ``stacks`` x ``channels`` cluster) whose engines run on
    ``device`` (the card by default)."""
    return PIMRuntime(channels=channels, engine=engine, stacks=stacks,
                      device=device).gemv(a, x, placement=placement,
                                          execute=execute)
