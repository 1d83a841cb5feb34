"""Fault injection mechanism: fire a plan's events against a runtime.

One :class:`FaultInjector` is built per ``PIMRuntime(faults=plan)`` and
threads the plan through every layer the scheduler touches:

* **clock** — serialized runtimes advance a private fault clock by each
  op's ``cluster_makespan_cycles``; async runtimes read the timeline
  frontier.  Events fire when the clock passes their ``at_cycle``,
  polled at every op boundary (fail-stop is modeled at op granularity:
  an op already dispatched completes, the next one sees the failure —
  the retry unit real serving systems use).
* **placement** — :meth:`healthy` maps an op's requested device set
  (``stack=`` / ``channels=`` / whole runtime) to its surviving subset,
  reusing the scheduler's ``channels=`` flat-subset decompositions.
  When nothing in the requested set has failed the request is returned
  *unchanged*, so fault-free ops take byte-identical code paths.
* **residency** — a failed channel's resident shards are lost: their
  uids are flagged and the natural re-ship at next miss is additionally
  charged on the host-link ledger as ``reupload`` traffic (cluster
  runtimes) and marked with a replay-neutral ``# RECOVER`` trace event.
  Pinned undrained outputs (the only copy of a result until
  ``to_host``) are *replayed* onto a survivor channel: the producer's
  recorded busy cycles are re-charged there from the last host copy and
  the pending drain re-homed, so ``DeviceTensor.to_host`` still
  delivers the result.
* **link** — the :class:`~repro_torch.runtime.cluster.HostLinkLedger` calls
  :meth:`on_link_charge` after each charge; transient retransmits and
  degradation-window slowdowns append ``retry`` / ``degrade`` ledger
  events (never recursing through ``charge``).

Everything the injector does is observable: ``faults.*`` counters in an
attached metrics registry, Chrome-trace instant events (``instants``),
``# FAULT`` / ``# RECOVER`` trace markers, and
``RuntimeReport.failed_channels``.

Port of ``repro.faults.injector``: the same events, draws
(``default_rng(plan.seed)``) and ledger charges; a pinned output's
weak reference points at the port's :class:`DeviceTensor`.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.faults.plan import FaultPlan
from repro_torch.runtime.cluster import host_link_cycles
from repro_torch.runtime.residency import DeviceTensor, box_bytes


class FaultError(RuntimeError):
    """Base class for unrecoverable fault-injection conditions."""


class NoHealthyChannelsError(FaultError):
    """An op's entire requested device set has failed — nothing left to
    decompose over.  Recovery above this layer (e.g. stack failover in
    the decode offload) must re-place the work before retrying."""


class FaultInjector:
    """Runtime-side mechanism for one :class:`FaultPlan`.

    Built by ``PIMRuntime(faults=...)``; the scheduler calls
    :meth:`on_op` at every op boundary (poll + healthy-subset remap),
    :meth:`advance` after each serialized op, :meth:`on_reship` on
    handle misses, and registers kept outputs via :meth:`register` /
    :meth:`note_output`.  All random draws come from one
    ``default_rng(plan.seed)``, so a plan replays identically.
    """

    def __init__(self, plan: FaultPlan, runtime):
        self.plan = plan
        self.rt = runtime
        total = len(runtime.stack)
        cluster = runtime._cluster
        n_stacks = cluster.n_stacks if cluster is not None else 1
        cps = cluster.channels_per_stack if cluster is not None else total
        events: List[Tuple[float, int, str, int]] = []
        for i, f in enumerate(plan.channel_faults):
            if not 0 <= f.channel < total:
                raise ValueError(
                    f"ChannelFault channel {f.channel} out of range for "
                    f"{total} flat channels")
            events.append((f.at_cycle, i, "channel", f.channel))
        for i, f in enumerate(plan.stack_faults):
            if not 0 <= f.stack < n_stacks:
                raise ValueError(
                    f"StackFault stack {f.stack} out of range for "
                    f"{n_stacks} stacks")
            events.append((f.at_cycle, len(plan.channel_faults) + i,
                           "stack", f.stack))
        #: due events in (cycle, declaration) order — the tiebreak index
        #: keeps simultaneous faults deterministic
        self._pending = sorted(events)
        self._cps = cps
        self.rng = np.random.default_rng(plan.seed)
        self.failed: Set[int] = set()
        #: uids whose resident shards were lost to a channel failure —
        #: their next miss's re-ship is recovery traffic
        self.lost_uids: Set[int] = set()
        self._reshipped: Set[int] = set()
        #: uid -> weakref(DeviceTensor) for pinned-output replay
        self._tensors: Dict[int, "weakref.ref"] = {}
        #: (uid, channel) -> producer busy cycles (the replay charge)
        self._output_busy: Dict[Tuple[int, int], float] = {}
        self._serial_clock = 0.0
        #: Chrome-trace instant events: (kind, cycle, flat channel or -1
        #: for the host link, label)
        self.instants: List[Tuple[str, float, int, str]] = []
        #: plain mirror of the faults.* counters (works without a
        #: metrics registry attached)
        self.counters: Dict[str, float] = {}

    # -- clock ---------------------------------------------------------------

    @property
    def now(self) -> float:
        """The fault clock: timeline frontier (async) or the accumulated
        serialized makespan."""
        tl = self.rt.timeline
        return tl.now if tl is not None else self._serial_clock

    def advance(self, cycles: float) -> None:
        """Advance the serialized fault clock by one op's makespan."""
        self._serial_clock += cycles

    # -- counters / observability --------------------------------------------

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value
        m = self.rt.metrics
        if m is not None:
            m.counter(f"faults.{name}",
                      # the reference's help text: registry snapshots
                      # of both packages compare ==
                      help="fault-injection counter (repro.faults)"
                      ).inc(value)

    # -- event firing --------------------------------------------------------

    def poll(self) -> None:
        """Fire every pending fault whose cycle has passed."""
        while self._pending and self._pending[0][0] <= self.now:
            at, _, kind, target = self._pending.pop(0)
            if kind == "channel":
                self._fail_channel(target, at)
            else:
                for c in range(target * self._cps,
                               (target + 1) * self._cps):
                    self._fail_channel(c, at)
                self.count("stack_failures", 1)

    def is_failed(self, channel: int) -> bool:
        return channel in self.failed

    def _fail_channel(self, ch: int, at: float) -> None:
        if ch in self.failed:
            return
        dev = self.rt.stack[ch]
        self.failed.add(ch)
        dev.failed = True
        dev.events.append(("fault", float(at)))
        self.instants.append(
            ("fault", float(at), ch, f"channel {ch} fail-stop"))
        self.count("channel_failures", 1)
        lost = sum(dev.resident_bytes_of(u) for u in dev.resident)
        if lost:
            self.count("lost_resident_bytes", lost)
        # pinned undrained outputs first: the only copy of those results
        # lives on-channel, so they replay onto a survivor before the
        # residency table is wiped
        for uid in [u for u in list(dev.resident) if u in dev.pinned]:
            self._replay_output(uid, ch, at)
        for uid in list(dev.resident):
            self.lost_uids.add(uid)
            dev.drop_resident(uid)

    def _pick_survivor(self, ch: int) -> int:
        """A healthy channel to inherit ``ch``'s replayed work: same
        stack preferred (no extra link crossing), lowest flat id wins."""
        total = len(self.rt.stack)
        s0 = (ch // self._cps) * self._cps
        same = [c for c in range(s0, min(s0 + self._cps, total))
                if c not in self.failed]
        if same:
            return same[0]
        any_ = [c for c in range(total) if c not in self.failed]
        if not any_:
            raise NoHealthyChannelsError(
                "every channel has failed; nothing can inherit replayed "
                "outputs")
        return any_[0]

    def _replay_output(self, uid: int, ch: int, at: float) -> None:
        """Replay a pinned undrained output from the last host copy onto
        a survivor: re-charge the producer's busy cycles there, re-home
        the pending d2h boxes, charge cross-stack moves on the link."""
        ref = self._tensors.get(uid)
        handle: Optional[DeviceTensor] = ref() if ref is not None else None
        busy = self._output_busy.pop((uid, ch), 0.0)
        survivor = self._pick_survivor(ch)
        sdev = self.rt.stack[survivor]
        moved: List[Tuple[int, int, int, int]] = []
        if handle is not None:
            pending = []
            for c, box in handle.pending_d2h:
                if c == ch:
                    moved.append(box)
                    pending.append((survivor, box))
                else:
                    pending.append((c, box))
            handle.pending_d2h = pending
            for box in moved:
                # capacity may refuse; the pending entry still points at
                # the survivor, so the eventual to_host drains there
                sdev.add_resident(uid, box, pin=True)
        nbytes = sum(box_bytes(b) for b in moved)
        if busy > 0:
            sdev.charge_analytic(busy, 0, 0)
            tl = self.rt.timeline
            if tl is not None:
                tl.submit("replay", {survivor: busy}, 0, [])
            else:
                self._serial_clock += busy
        sdev.events.append(("recover", nbytes))
        cluster = self.rt._cluster
        if cluster is not None and \
                cluster.stack_of(survivor) != cluster.stack_of(ch):
            # switched topology attributes the migration to the
            # destination stack's private link; shared falls through to
            # the single ledger (link_for returns it unchanged)
            cluster.link_for(cluster.stack_of(survivor)).charge(
                "reupload", nbytes)
        self.count("replayed_outputs", 1)
        self.count("replayed_bytes", nbytes)
        self.count("replay_cycles", busy)
        self.instants.append(
            ("recover", self.now, survivor,
             f"replayed output uid={uid} ch{ch}->ch{survivor}"))

    # -- scheduler hooks -----------------------------------------------------

    def on_op(self, stack: Optional[int],
              channels: Optional[Sequence[int]]
              ) -> Tuple[Optional[int], Optional[Sequence[int]]]:
        """Op-boundary hook: fire due events, then map the op's requested
        device set to its healthy subset."""
        self.poll()
        return self.healthy(stack, channels)

    def healthy(self, stack: Optional[int],
                channels: Optional[Sequence[int]]
                ) -> Tuple[Optional[int], Optional[Sequence[int]]]:
        """The surviving portion of a requested (stack=, channels=) set.

        Unchanged requests are returned as-is — fault-free ops keep
        their exact decomposition (and its caches).  A request whose
        channels partially failed becomes a flat ``channels=`` subset;
        a fully-failed request raises :class:`NoHealthyChannelsError`.
        """
        if not self.failed:
            return stack, channels
        if channels is not None:
            req = sorted(channels)
        elif stack is not None:
            req = list(range(stack * self._cps, (stack + 1) * self._cps))
        else:
            req = list(range(len(self.rt.stack)))
        alive = [c for c in req if c not in self.failed]
        if not alive:
            raise NoHealthyChannelsError(
                f"all requested channels {req} have failed "
                f"(failed={sorted(self.failed)})")
        if len(alive) == len(req):
            return stack, channels
        return None, tuple(alive)

    def end_op(self) -> None:
        """Close one op: uids whose lost shards re-shipped this op leave
        the lost set (recovery traffic is charged once per loss)."""
        if self._reshipped:
            self.lost_uids.difference_update(self._reshipped)
            self._reshipped.clear()

    def on_reship(self, dev, uid: int, nbytes: int) -> None:
        """A handle miss just re-shipped ``nbytes`` of tensor ``uid``:
        if the residency was lost to a fault, account it as recovery —
        link ``reupload`` traffic on clusters, a ``# RECOVER`` trace
        event either way."""
        if uid not in self.lost_uids:
            return
        self._reshipped.add(uid)
        dev.events.append(("recover", nbytes))
        cluster = self.rt._cluster
        if cluster is not None:
            # charge the re-ship on the receiving stack's link (the
            # shared ledger when link_topology="shared")
            cluster.link_for(cluster.stack_of(dev.channel_id)).charge(
                "reupload", nbytes)
        self.count("reupload_bytes", nbytes)
        self.instants.append(
            ("recover", self.now, dev.channel_id,
             f"re-shipped {nbytes}B of lost uid={uid}"))

    # -- residency registration (pinned-output replay inputs) ---------------

    def register(self, handle: DeviceTensor) -> None:
        self._tensors[handle.uid] = weakref.ref(handle)

    def note_output(self, uid: int, channel: int, busy: float) -> None:
        """Record the producer busy cycles behind one kept output shard
        (what a replay re-charges on the survivor)."""
        self._output_busy[(uid, channel)] = \
            max(self._output_busy.get((uid, channel), 0.0), busy)

    # -- host-link hook ------------------------------------------------------

    def on_link_charge(self, ledger, kind: str, nbytes: int,
                       cycles: int) -> None:
        """Post-charge link hook: degradation windows and transient
        retransmits append their own ledger events (``degrade`` /
        ``retry``) without recursing through ``charge``."""
        now = self.now
        for d in self.plan.link_degradations:
            if d.start_cycle <= now < d.end_cycle:
                extra = int(-(-cycles * (d.factor - 1.0) // 1))  # ceil
                if extra > 0:
                    # degrade events carry the *extra cycles* in the
                    # count slot (no new bytes move; the link is just
                    # occupied longer)
                    ledger.charge_raw("degrade", 0, extra)
                    self.count("degraded_cycles", extra)
        lt = self.plan.link_transient
        if lt is None:
            return
        retries = 0
        backoff = lt.backoff_cycles
        while retries < lt.max_retries and self.rng.random() < lt.prob:
            retries += 1
            pause = min(backoff, lt.backoff_cap_cycles)
            ledger.charge_raw("retry", nbytes,
                              host_link_cycles(nbytes) + pause)
            backoff *= 2
        if retries:
            self.count("link_retries", retries)
            self.count("retransmitted_bytes", nbytes * retries)
            self.instants.append(
                ("retry", now, -1,
                 f"link retransmit x{retries} ({nbytes}B {kind})"))

    # -- reporting -----------------------------------------------------------

    def summary(self) -> Dict[str, float]:
        """Counter snapshot plus failure state (the RuntimeReport /
        bench-facing view)."""
        out = dict(self.counters)
        out["failed_channels"] = float(len(self.failed))
        return out
