"""Async dependency-aware op timeline: per-channel and per-link clocks.

The scheduler's default (``async_mode=False``) treats every op as a
global barrier: the op's makespan is max-over-channels busy time and ops
accumulate by simple addition (the serve loop's ``pim_cycles +=
rep.makespan_cycles``).  That is correct accounting for one op but wrong
for a *set* of independent ops — the paper's PEP execution model keeps
the host out of the loop precisely so many in-memory micro-kernels can
run concurrently, and PrIM's analysis shows PIM throughput is won or
lost on keeping all banks busy simultaneously.

This module is the async layer.  Every channel owns a monotonic clock
(``PIMDevice.tl_free``) and every cluster host link owns one
(``HostLinkLedger.tl_free``); an op submitted to the timeline becomes an
:class:`OpHandle` future whose shards start at::

    start(ch) = max(dep retire times, channel free time, link free time)

so independent ops interleave on disjoint channels, a fully chained DAG
reproduces the serialized makespan exactly (property-tested), and
host-link transfer windows are charged *inside* the timeline — a link
busy interval blocks dependent shard starts — instead of on a separate
serialization axis.

Dependencies are derived automatically by the scheduler from resident
:class:`~repro_torch.runtime.residency.DeviceTensor` reads/writes (an op that
consumes a kept output starts after its producer retires; every op that
reads a placed weight starts after the upload), plus explicit ``after=``
edges for dataflow the runtime cannot see (e.g. the decode serve loop's
host-side attention/softmax between projections).

The timeline never changes *what* is charged: per-op ledgers, traces and
numerics are identical to the serialized mode (per-channel busy cycles
are conserved under any overlap — also property-tested); it only decides
*when* each op's per-channel busy interval is placed on the clock.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class OpHandle:
    """Lightweight future for one op submitted to an async runtime.

    ``spans`` maps flat channel id -> ``(start, busy)`` — the interval
    the op occupies on that channel's clock; ``link_window`` is the
    ``(start, end)`` interval the op's inter-stack traffic occupies on
    the shared host link (``None`` when the op never crosses stacks).
    ``deps`` holds the op ids this op waited on (inferred + explicit).
    ``result`` / ``report`` are the values the serialized mode would
    have returned from the op call.
    """

    op_id: int
    name: str
    deps: Tuple[int, ...]
    start: float
    retire: float
    spans: Dict[int, Tuple[float, float]]
    link_window: Optional[Tuple[float, float]] = None
    report: Optional[object] = None
    result: Optional[object] = None

    @property
    def busy_cycles(self) -> float:
        """Total channel-busy cycles this op occupies (conservation)."""
        return sum(b for _, b in self.spans.values())

    def __repr__(self) -> str:
        return (f"OpHandle({self.op_id}:{self.name}, "
                f"start={self.start:.0f}, retire={self.retire:.0f}, "
                f"channels={sorted(self.spans)}, deps={list(self.deps)})")


class Timeline:
    """Monotonic per-channel / per-link clocks plus the submitted op log.

    Owned by an ``async_mode=True`` :class:`~repro_torch.runtime.scheduler.
    PIMRuntime`.  The clocks themselves live on the hardware objects —
    ``PIMDevice.tl_free`` and ``HostLinkLedger.tl_free`` — so a stack
    ``reset()`` clears them with the ledgers; the timeline just advances
    them and records :class:`OpHandle` intervals.

    ``ops`` keeps every handle (results and reports included) for the
    runtime's lifetime — the op log is the schedule record tests and the
    pipeline report read.  Long-running numeric loops that don't need
    old results can drop them (``handle.result = None``) after
    consumption; the timeline itself only ever reads ``spans``/
    ``retire``.
    """

    def __init__(self, stack, cluster=None):
        self.stack = stack            # PIMStack or PIMCluster (flat view)
        self.cluster = cluster        # PIMCluster or None
        self.ops: List[OpHandle] = []
        self._next_id = 1

    # -- clocks --------------------------------------------------------------

    @property
    def now(self) -> float:
        """The frontier: max over every channel clock and every link
        clock (the shared link, plus each per-stack link when the
        cluster runs ``link_topology="switched"``)."""
        t = max((d.tl_free for d in self.stack), default=0.0)
        if self.cluster is not None:
            t = max(t, *(l.tl_free for l in self.cluster.all_links()))
        return t

    @property
    def makespan(self) -> float:
        """Wall-clock of everything submitted so far (== :attr:`now`)."""
        return self.now

    def channel_busy(self, channel: int) -> float:
        """Total busy cycles placed on ``channel`` across all ops."""
        return sum(h.spans[channel][1] for h in self.ops
                   if channel in h.spans)

    # -- submission ----------------------------------------------------------

    def submit(self, name: str, channel_busy: Dict[int, float],
               link_cycles=0,
               deps: Optional[List[OpHandle]] = None,
               report=None, result=None) -> OpHandle:
        """Place one op's busy intervals on the clocks.

        ``channel_busy`` maps flat channel id -> this op's busy cycles on
        that channel (zero-busy channels are dropped).  ``link_cycles``
        is the op's host-link occupancy — an int charged on the shared
        link's clock, or (``link_topology="switched"``) a dict mapping
        stack id -> cycles (``None`` = the switch uplink) charged on
        each per-stack link's *own* clock, so disjoint-stack traffic
        overlaps.  Every window opens no earlier than the op's
        dependencies retire and its link is free, and dependent shard
        starts wait for the earliest window.  Returns the
        :class:`OpHandle` whose ``retire`` is what downstream ops wait
        on.
        """
        deps = [d for d in (deps or []) if d is not None]
        ready = max((d.retire for d in deps), default=0.0)
        link_window = None
        if isinstance(link_cycles, dict):
            windows = []
            for key in sorted(link_cycles,
                              key=lambda k: (k is None, k)):
                cyc = link_cycles[key]
                if cyc <= 0:
                    continue
                link = self.cluster.link_for(key)
                ls = max(ready, link.tl_free)
                link.tl_free = ls + cyc
                windows.append((ls, ls + cyc))
            if windows:
                link_window = (min(w[0] for w in windows),
                               max(w[1] for w in windows))
        elif link_cycles > 0:
            link = self.cluster.link
            ls = max(ready, link.tl_free)
            link_window = (ls, ls + link_cycles)
            link.tl_free = link_window[1]
        spans: Dict[int, Tuple[float, float]] = {}
        for ch, busy in channel_busy.items():
            if busy <= 0:
                continue
            dev = self.stack[ch]
            start = max(ready, dev.tl_free)
            if link_window is not None:
                # inter-stack operands must have begun crossing the link
                start = max(start, link_window[0])
            dev.tl_free = start + busy
            spans[ch] = (start, busy)
        ends = [s + b for s, b in spans.values()]
        if link_window is not None:
            ends.append(link_window[1])
        start = min((s for s, _ in spans.values()), default=ready)
        retire = max(ends, default=ready)
        if not spans and link_window is None:
            # degenerate op: all-zero channel_busy and no link traffic
            # (e.g. a place() whose shards were all already resident).
            # Normalize to a zero-length marker at its ready time —
            # empty spans with start == retire == ready — so downstream
            # interval consumers (critical-path walks, utilization
            # denominators) never see an undefined or inverted interval.
            assert start == retire == ready, (start, retire, ready)
        assert retire >= start, (name, start, retire)
        handle = OpHandle(
            op_id=self._next_id, name=name,
            deps=tuple(d.op_id for d in deps),
            start=start, retire=retire,
            spans=spans, link_window=link_window,
            report=report, result=result)
        self._next_id += 1
        self.ops.append(handle)
        return handle
