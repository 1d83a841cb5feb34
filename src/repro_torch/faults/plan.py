"""Fault scenarios: what fails, when, and how the failure behaves.

Real PIM silicon fails in ways the clean runtime model ignores: the PrIM
characterization reports DPU/rank-level faults on production UPMEM parts,
and the PIM-adoption literature names reliability as a first-class
integration barrier.  This module is the *scenario* half of the fault
subsystem — plain frozen dataclasses describing failures, plus a small
text DSL for writing them down — with zero runtime behavior of its own.
The *mechanism* half (firing events against a live runtime, recovery,
accounting) is :mod:`repro_torch.faults.injector`.

A :class:`FaultPlan` bundles:

* :class:`ChannelFault` — fail-stop of one pseudo-channel (cluster-flat
  id) at a cycle: the channel is excluded from every later placement
  decomposition, its resident shards are lost (re-upload charged at next
  use), and pinned undrained outputs are replayed onto a survivor.
* :class:`StackFault` — fail-stop of a whole stack (all its channels).
* :class:`LinkTransient` — transient host-link transfer corruption: each
  link charge retransmits with probability ``prob`` per attempt, charged
  as retry-with-exponential-backoff busy windows on the link ledger.
  Draws come from the plan's seeded generator, so runs are reproducible.
* :class:`LinkDegradation` — a bandwidth-degradation window: link
  charges inside ``[start_cycle, end_cycle)`` cost ``factor`` x their
  cycles (extra occupancy charged as ``degrade`` ledger events).
* :class:`ServeFault` — a serving-layer fault: the request decoding in
  ``slot`` at serving iteration ``at_iter`` is knocked out and requeued
  with backoff (or failed after ``Server.max_retries``).

An **empty plan is strictly additive**: attaching ``FaultPlan()`` to a
runtime leaves ledgers ``==``-equal and traces byte-identical to a run
with no faults attached at all — the same discipline as the
observability layer (see docs/robustness.md).

The scenario DSL (one statement per line or ``;``-separated)::

    kill channel 3 @ 1000        # fail-stop flat channel 3 at cycle 1000
    kill stack 1 @ 5e6           # fail-stop all of stack 1
    flaky link p=0.01 backoff=64 retries=8 cap=4096
    slow link x2 @ 1000:5000     # link charges cost 2x in the window
    fail slot 0 @ iter 3         # knock out the request in serve slot 0

Parse with :meth:`FaultPlan.parse`; ``PIMRuntime(faults=...)`` and
``Server(faults=...)`` accept either a plan or a DSL string.

A copy of ``repro.faults.plan`` (pure host code).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ChannelFault:
    """Fail-stop of one pseudo-channel (cluster-flat id) at a cycle."""

    at_cycle: float
    channel: int

    def __post_init__(self):
        if self.at_cycle < 0:
            raise ValueError(f"at_cycle must be >= 0, got {self.at_cycle}")
        if self.channel < 0:
            raise ValueError(f"channel must be >= 0, got {self.channel}")


@dataclasses.dataclass(frozen=True)
class StackFault:
    """Fail-stop of a whole stack (all its pseudo-channels) at a cycle."""

    at_cycle: float
    stack: int

    def __post_init__(self):
        if self.at_cycle < 0:
            raise ValueError(f"at_cycle must be >= 0, got {self.at_cycle}")
        if self.stack < 0:
            raise ValueError(f"stack must be >= 0, got {self.stack}")


@dataclasses.dataclass(frozen=True)
class LinkTransient:
    """Transient host-link corruption: retransmit with probability
    ``prob`` per attempt, exponential backoff between attempts.

    Each retransmit re-charges the transfer's bytes and cycles on the
    link plus a backoff pause that doubles per attempt, capped at
    ``backoff_cap_cycles``; after ``max_retries`` the transfer is
    assumed through (fail-stop link loss is a :class:`StackFault`'s
    job, not this one's).
    """

    prob: float
    backoff_cycles: int = 64
    max_retries: int = 8
    backoff_cap_cycles: int = 4096

    def __post_init__(self):
        if not 0.0 <= self.prob < 1.0:
            raise ValueError(f"prob must be in [0, 1), got {self.prob}")
        if self.backoff_cycles < 0 or self.backoff_cap_cycles < 0:
            raise ValueError("backoff cycles must be >= 0")
        if self.max_retries < 1:
            raise ValueError("max_retries must be >= 1")


@dataclasses.dataclass(frozen=True)
class LinkDegradation:
    """Host-link bandwidth degradation window: charges landing inside
    ``[start_cycle, end_cycle)`` occupy ``factor`` x their cycles."""

    start_cycle: float
    end_cycle: float
    factor: float

    def __post_init__(self):
        if not 0 <= self.start_cycle < self.end_cycle:
            raise ValueError(
                f"need 0 <= start < end, got "
                f"[{self.start_cycle}, {self.end_cycle})")
        if self.factor < 1.0:
            raise ValueError(
                f"factor must be >= 1 (a slowdown), got {self.factor}")


@dataclasses.dataclass(frozen=True)
class ServeFault:
    """Knock out the request decoding in serve slot ``slot`` at serving
    iteration ``at_iter`` (1-based; the server requeues with backoff)."""

    at_iter: int
    slot: int

    def __post_init__(self):
        if self.at_iter < 1:
            raise ValueError(f"at_iter is 1-based, got {self.at_iter}")
        if self.slot < 0:
            raise ValueError(f"slot must be >= 0, got {self.slot}")


# -- the DSL ----------------------------------------------------------------

_KILL_CH_RE = re.compile(
    r"^kill\s+(?:channel|ch)\s+(\d+)\s*@\s*([0-9.eE+]+)$")
_KILL_STACK_RE = re.compile(
    r"^kill\s+stack\s+(\d+)\s*@\s*([0-9.eE+]+)$")
_FLAKY_RE = re.compile(
    r"^flaky\s+link\s+p=([0-9.eE+-]+)"
    r"(?:\s+backoff=(\d+))?(?:\s+retries=(\d+))?(?:\s+cap=(\d+))?$")
_SLOW_RE = re.compile(
    r"^slow\s+link\s+x([0-9.]+)\s*@\s*([0-9.eE+]+)\s*:\s*([0-9.eE+]+)$")
_SERVE_RE = re.compile(
    r"^fail\s+slot\s+(\d+)\s*@\s*iter\s+(\d+)$")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seeded fault scenario.

    Attach to :class:`~repro_torch.runtime.scheduler.PIMRuntime` via
    ``faults=`` (channel/stack/link faults) and to
    :class:`~repro_torch.serve.loop.Server` via ``faults=`` (serve faults).
    ``seed`` drives every random draw (link transients), so the same
    plan replays identically — ledger-equal across runs, the CI
    determinism gate.
    """

    seed: int = 0
    channel_faults: Tuple[ChannelFault, ...] = ()
    stack_faults: Tuple[StackFault, ...] = ()
    link_transient: Optional[LinkTransient] = None
    link_degradations: Tuple[LinkDegradation, ...] = ()
    serve_faults: Tuple[ServeFault, ...] = ()

    def __post_init__(self):
        # tolerate lists; frozen dataclass needs object.__setattr__
        object.__setattr__(self, "channel_faults",
                           tuple(self.channel_faults))
        object.__setattr__(self, "stack_faults", tuple(self.stack_faults))
        object.__setattr__(self, "link_degradations",
                           tuple(self.link_degradations))
        object.__setattr__(self, "serve_faults", tuple(self.serve_faults))

    @property
    def empty(self) -> bool:
        """True when the plan injects nothing (the strictly-additive
        attach: ledgers ==-equal, traces byte-identical)."""
        return not (self.channel_faults or self.stack_faults
                    or self.link_transient or self.link_degradations
                    or self.serve_faults)

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        """Parse the scenario DSL (module docstring) into a plan."""
        ch, st, deg, srv = [], [], [], []
        transient = None
        for raw in re.split(r"[;\n]", text):
            stmt = raw.split("#", 1)[0].strip()
            if not stmt:
                continue
            m = _KILL_CH_RE.match(stmt)
            if m:
                ch.append(ChannelFault(at_cycle=float(m.group(2)),
                                       channel=int(m.group(1))))
                continue
            m = _KILL_STACK_RE.match(stmt)
            if m:
                st.append(StackFault(at_cycle=float(m.group(2)),
                                     stack=int(m.group(1))))
                continue
            m = _FLAKY_RE.match(stmt)
            if m:
                if transient is not None:
                    raise ValueError(
                        f"duplicate 'flaky link' statement: {stmt!r}")
                kw = {}
                if m.group(2):
                    kw["backoff_cycles"] = int(m.group(2))
                if m.group(3):
                    kw["max_retries"] = int(m.group(3))
                if m.group(4):
                    kw["backoff_cap_cycles"] = int(m.group(4))
                transient = LinkTransient(prob=float(m.group(1)), **kw)
                continue
            m = _SLOW_RE.match(stmt)
            if m:
                deg.append(LinkDegradation(start_cycle=float(m.group(2)),
                                           end_cycle=float(m.group(3)),
                                           factor=float(m.group(1))))
                continue
            m = _SERVE_RE.match(stmt)
            if m:
                srv.append(ServeFault(at_iter=int(m.group(2)),
                                      slot=int(m.group(1))))
                continue
            raise ValueError(f"unparseable fault statement: {stmt!r}")
        return cls(seed=seed, channel_faults=tuple(ch),
                   stack_faults=tuple(st), link_transient=transient,
                   link_degradations=tuple(deg), serve_faults=tuple(srv))


def as_plan(faults) -> FaultPlan:
    """Coerce a ``faults=`` argument (plan or DSL string) to a plan."""
    if isinstance(faults, FaultPlan):
        return faults
    if isinstance(faults, str):
        return FaultPlan.parse(faults)
    raise TypeError(
        f"faults= expects a FaultPlan or a scenario-DSL string, "
        f"got {type(faults).__name__}")
