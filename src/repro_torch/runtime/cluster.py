"""Multi-stack PIM cluster: N HBM-PIM stacks behind one host link.

The paper evaluates one pseudo-channel; :class:`~repro_torch.runtime.device.
PIMStack` scaled that to 16.  The next seam up — the ROADMAP's
"multi-stack sharding" item — is several stacks behind one
:class:`~repro_torch.runtime.scheduler.PIMRuntime`, and what changes there is
not compute but *data movement*: AMD's balanced-placement study and the
PrIM benchmarking work both show cross-device traffic and placement, not
per-unit throughput, decide whether multi-device PIM scales.

:class:`PIMCluster` therefore adds exactly one piece of hardware to the
model: the **shared host link** every stack's DRAM traffic converges on
(the CPU-side interconnect — PCIe-class, nothing like per-stack HBM
bandwidth).  Addressing grows a leading stack axis — ``(stack, channel)``
— with a *flat* view (``cluster[stack * C + channel]``) so the scheduler
and residency layers index devices uniformly; devices carry their flat id
(:class:`PIMStack` with ``stack_id``), so ledgers and traces stay
unambiguous.

The host-link ledger charges only traffic that exists *because* data
crosses stack boundaries — a single-stack cluster is byte-identical
(ledgers and traces) to a bare stack:

* **cross-stack operand movement** — an operand box shipped h2d to
  channels of more than one stack within one op (or one ``place``):
  every copy beyond the first stack's crosses the link;
* **K-split partial drains** — a reduction group whose partials come
  from more than one stack must converge at the host over the link;
  every partial from a non-home stack (home = the stack of the group's
  first-dispatched shard) charges its d2h bytes on the link.

Link time is charged at :data:`HOST_LINK_BYTES_PER_CYCLE` (32 GB/s at
the 250 MHz PIM clock — PCIe-gen4-x16-class) and reported separately
from per-channel busy time: the channel makespan keeps its meaning
(fixed-total-channel reshapes stay makespan-parity), and
``RuntimeReport.cluster_makespan_cycles`` folds the link in as a second
serialization axis.

Port of ``repro.runtime.cluster``; ``device`` is where every stack's
engines compute (the card by default).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.isa import PIM_FREQ_HZ, PSEUDO_CHANNELS
from repro_torch.launch.device import resolve_device
from repro_torch.runtime.device import PIMDevice, PIMStack

#: host-link bytes per PIM cycle: 32 GB/s shared link at 250 MHz —
#: PCIe-gen4-x16-class, 4x one pseudo-channel's 32 B/cycle command bus
HOST_LINK_BYTES_PER_CYCLE = 128

#: the link bandwidth that implies
HOST_LINK_BANDWIDTH_BYTES_PER_S = HOST_LINK_BYTES_PER_CYCLE * PIM_FREQ_HZ


def host_link_cycles(nbytes: int) -> int:
    """PIM-clock cycles ``nbytes`` occupies the shared host link."""
    return math.ceil(nbytes / HOST_LINK_BYTES_PER_CYCLE)


@dataclasses.dataclass
class HostLinkLedger:
    """Inter-stack traffic over the cluster's shared host link.

    ``events`` keeps (kind, nbytes) in charge order — ``"xstack"`` for
    cross-stack operand movement, ``"drain"`` for cross-stack K-split
    partial gathers — and is what the trace emitter serializes as
    ``# HOSTLINK`` marker lines.  Fault injection (:mod:`repro_torch.faults`)
    adds three recovery/perturbation kinds: ``"reupload"`` (lost
    resident shards re-shipped / failover weight migration),
    ``"retry"`` (transient-corruption retransmits incl. backoff pause),
    and ``"degrade"`` (bandwidth-degradation windows; the count slot
    carries the *extra cycles*, since no new bytes move).  The serving
    simulator (:class:`repro_torch.serve.loop.TrafficServer`) adds two
    phase-contention kinds: ``"prefill"`` (host-prefilled KV handed off
    to PIM-resident pages) and ``"acts"`` (per-decode-step activation
    shipping) — the traffic disaggregation studies charge both as busy
    windows on this same link so prefill and decode contend.
    """

    #: event kinds `charge` accepts (degrade goes through charge_raw
    #: only — its cycle cost is not a function of nbytes)
    KINDS = ("xstack", "drain", "retry", "reupload", "prefill", "acts")

    bytes: int = 0
    cycles: int = 0
    events: List[Tuple[str, int]] = dataclasses.field(default_factory=list)
    # async-timeline link clock (repro_torch.runtime.timeline): the cycle the
    # shared link next comes free.  Only an async_mode runtime advances
    # it; serialized mode keeps link time on its own axis instead
    # (RuntimeReport.cluster_makespan_cycles).
    tl_free: float = 0.0
    # repro_torch.obs metrics registry (attached via PIMRuntime(metrics=));
    # excluded from ==/repr so instrumented ledgers stay equal to bare
    # ones — the profiling-off byte-identity invariant
    metrics: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)
    # repro_torch.faults.FaultInjector (attached via
    # PIMRuntime(faults=)); excluded from == for the same reason — an
    # injector with an empty plan must leave the ledger ==-equal to a
    # bare one
    faults: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False)
    # metric-name prefix: the shared link keeps "link"; a switched
    # cluster labels its per-stack ledgers "link<s>".  Excluded from ==
    # so labeled ledgers compare by traffic, not by name.
    label: str = dataclasses.field(
        default="link", compare=False, repr=False)

    def charge_raw(self, kind: str, nbytes: int, cyc: int) -> int:
        """Record one link event at an explicit cycle cost — the base
        accounting step :meth:`charge` and the fault injector's
        retry/degrade perturbations share (never re-enters the fault
        hook, so injected events cannot recurse)."""
        self.bytes += nbytes
        self.cycles += cyc
        self.events.append((kind, nbytes))
        if self.metrics is not None:
            self.metrics.counter(
                f"{self.label}.{kind}_bytes", unit="bytes",
                help=f"host-link bytes charged as {kind!r}").inc(nbytes)
            self.metrics.counter(
                f"{self.label}.cycles", unit="cycles",
                help="host-link occupancy charged").inc(cyc)
        return cyc

    def charge(self, kind: str, nbytes: int) -> int:
        assert kind in self.KINDS, kind
        cyc = self.charge_raw(kind, nbytes, host_link_cycles(nbytes))
        if self.faults is not None:
            self.faults.on_link_charge(self, kind, nbytes, cyc)
        return cyc


class PIMCluster:
    """N :class:`PIMStack`\\ s behind one scheduler and one host link.

    Quacks like a stack for the flat parts — ``len`` is the total channel
    count, ``cluster[flat]`` and iteration reach every device in
    ``(stack, channel)`` order — so :class:`~repro_torch.runtime.residency.
    DeviceTensor` and the scheduler's ledger walks run unchanged.  The
    stack axis is explicit where it matters: :meth:`device` addresses by
    ``(stack, channel)``, :meth:`stack_of` recovers a flat id's stack,
    and :attr:`link` is the shared host-link ledger.  ``device=`` (the
    card by default) is where the engines compute, kept as
    ``torch_device``, so :meth:`device` stays the reference's accessor.
    """

    def __init__(self, stacks: int = 1, channels: int = PSEUDO_CHANNELS,
                 capacity_bytes: Optional[int] = None,
                 link_topology: str = "shared", device=None):
        if link_topology not in ("shared", "switched"):
            raise ValueError(f"unknown link_topology {link_topology!r} "
                             f"(expected 'shared' or 'switched')")
        assert stacks >= 1, "a cluster has at least one stack"
        self.channels_per_stack = channels
        self.link_topology = link_topology
        self.torch_device = resolve_device(device)
        self.stacks = [PIMStack(channels, stack_id=s,
                                capacity_bytes=capacity_bytes,
                                device=self.torch_device)
                       for s in range(stacks)]
        self.link = HostLinkLedger()
        # "switched": one private link per stack behind a host-side
        # switch; ``link`` remains the switch's host uplink for traffic
        # with no single-stack attribution (serve-loop prefill/acts
        # broadcast).  "shared" keeps the single ledger — bit-identical
        # to the pre-topology model.
        self.links: Optional[List[HostLinkLedger]] = (
            [HostLinkLedger(label=f"link{s}") for s in range(stacks)]
            if link_topology == "switched" else None)

    # -- addressing ----------------------------------------------------------

    @property
    def n_stacks(self) -> int:
        return len(self.stacks)

    def __len__(self) -> int:
        return self.n_stacks * self.channels_per_stack

    def __getitem__(self, flat: int) -> PIMDevice:
        s, c = divmod(flat, self.channels_per_stack)
        return self.stacks[s].devices[c]

    def __iter__(self) -> Iterator[PIMDevice]:
        return itertools.chain.from_iterable(
            s.devices for s in self.stacks)

    def device(self, stack: int, channel: int) -> PIMDevice:
        """The device at explicit ``(stack, channel)`` coordinates."""
        return self.stacks[stack].devices[channel]

    def stack_of(self, flat: int) -> int:
        """Stack index owning flat channel id ``flat``."""
        return flat // self.channels_per_stack

    def flat(self, stack: int, channel: int) -> int:
        """Flat channel id of ``(stack, channel)``."""
        return stack * self.channels_per_stack + channel

    # -- link topology -------------------------------------------------------

    def all_links(self) -> List[HostLinkLedger]:
        """Every ledger traffic can land on: the shared link (or switch
        uplink) first, then the per-stack links (switched only)."""
        return [self.link] + (self.links or [])

    def link_for(self, stack: Optional[int]) -> HostLinkLedger:
        """The ledger a transfer attributed to ``stack`` occupies:
        the per-stack link under ``link_topology="switched"``, else (or
        when the transfer has no single-stack attribution) the shared
        link / switch uplink."""
        if self.links is None or stack is None:
            return self.link
        return self.links[stack]

    def link_totals(self) -> Tuple[int, int]:
        """(bytes, cycles) summed over every link ledger — the figures
        ``RuntimeReport.host_link_bytes/cycles`` report regardless of
        topology."""
        links = self.all_links()
        return (sum(l.bytes for l in links), sum(l.cycles for l in links))

    # -- aggregates (mirror PIMStack's) --------------------------------------

    @property
    def total_flops(self) -> int:
        return sum(s.total_flops for s in self.stacks)

    @property
    def total_bytes(self) -> int:
        return sum(s.total_bytes for s in self.stacks)

    @property
    def resident_bytes(self) -> int:
        return sum(s.resident_bytes for s in self.stacks)

    @property
    def spill_bytes(self) -> int:
        return sum(s.spill_bytes for s in self.stacks)

    @property
    def busy_cycles(self) -> float:
        """Sum of per-channel busy time across stacks (NOT wall-clock)."""
        return sum(s.busy_cycles for s in self.stacks)

    def reset(self) -> None:
        cap = self.stacks[0].capacity_bytes
        self.__init__(self.n_stacks, self.channels_per_stack, cap,
                      link_topology=self.link_topology,
                      device=self.torch_device)
