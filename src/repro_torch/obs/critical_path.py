"""Critical-path attribution over a timeline's op DAG.

``RuntimeReport.cluster_makespan_cycles`` says *how long* a schedule
took; this module says *why*.  Starting from the last-retiring op, the
walk moves backward through time asking, at every instant, "what was the
binding constraint here?" — a channel busy interval, a host-link
transfer window, a dependency retire, or nothing (slack: every resource
idle while the schedule waits on an earlier event).  The result is a
chain of :class:`PathSegment`\\ s that **partitions** ``[0, makespan]``
exactly: coverage == makespan is an invariant, gated in the bench
suite, not a best-effort statistic.

Why exact float equality works here: every clock value on the timeline
is produced by ``max()`` over previously-produced clock values plus
integer cycle counts (see :meth:`repro_torch.runtime.timeline.Timeline.
submit`), so a shard's start is *bit-identical* to whichever constraint
bound it.  The walk matches ends to starts with a tiny tolerance
(:data:`TOL`) purely as belt-and-braces; in practice the comparisons are
exact.

Predecessor priority at a segment boundary ``s`` (earliest first match
wins):

1. a **dependency** retiring at ``s`` — the op waited on its DAG edge;
2. the **previous span on the same channel** ending at ``s`` — the op
   was channel-bound (queueing, not dataflow);
3. a **host-link window** ending at ``s`` — the op was link-bound;
4. any op **retiring** at ``s`` (degenerate zero-busy ops hop straight
   through to their own deps);
5. otherwise **slack**: attribute ``(e, s]`` to idle time, where ``e``
   is the latest event end before ``s``, and resume from that event.

The walk is pure analysis — it reads ``OpHandle``-shaped objects
(``op_id``/``name``/``deps``/``spans``/``link_window``/``retire``) and
never touches the clocks, so it works identically on a live
``Timeline.ops`` log and on the serialized-mode shadow log kept by
:class:`repro_torch.obs.profile.Profiler`.

A copy of ``repro.obs.critical_path`` (pure host code).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence, Tuple

#: slop for matching clock values; timeline clocks propagate bit-exactly
#: (maxes of sums of previously-produced floats) so this never actually
#: absorbs error — it only guards hypothetical future float churn
TOL = 1e-9


@dataclasses.dataclass(frozen=True)
class PathSegment:
    """One interval of the makespan and what it was spent on.

    ``kind`` is ``"channel"`` (busy on flat channel ``channel``),
    ``"link"`` (host-link transfer window), ``"ready"`` (a zero-length
    marker where a degenerate op retired), or ``"slack"`` (no resource
    active; ``op_id``/``name`` refer to the op whose event *ends* the
    idle gap, i.e. the one the schedule was waiting behind).
    """

    op_id: int
    name: str
    kind: str
    channel: Optional[int]
    t0: float
    t1: float

    @property
    def cycles(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class ProfileReport:
    """Structured result of one critical-path walk.

    ``segments`` is chronological (ascending ``t0``) and partitions
    ``[0, makespan_cycles]``; ``by_op``/``by_channel`` fold the non-slack
    segments by attribution; ``channel_busy`` is total busy cycles per
    channel across *all* ops (utilization denominator = makespan).
    """

    makespan_cycles: float
    segments: List[PathSegment]
    by_op: Dict[int, float]
    op_names: Dict[int, str]
    by_channel: Dict[int, float]
    link_cycles: float
    slack_cycles: float
    channel_busy: Dict[int, float]
    n_ops: int

    @property
    def coverage_cycles(self) -> float:
        """Sum of segment lengths — invariant: == :attr:`makespan_cycles`."""
        return sum(s.cycles for s in self.segments)

    def top(self, k: int = 5) -> List[Tuple[str, int, float]]:
        """Top-``k`` (name, op_id, cycles) contributors to the path."""
        ranked = sorted(self.by_op.items(), key=lambda kv: -kv[1])
        return [(self.op_names.get(op_id, "?"), op_id, cyc)
                for op_id, cyc in ranked[:k]]

    def to_json(self) -> Dict:
        return {
            "profile_report": 1,
            "makespan_cycles": self.makespan_cycles,
            "coverage_cycles": self.coverage_cycles,
            "link_cycles": self.link_cycles,
            "slack_cycles": self.slack_cycles,
            "n_ops": self.n_ops,
            "by_op": {str(k): v for k, v in sorted(self.by_op.items())},
            "op_names": {str(k): v
                         for k, v in sorted(self.op_names.items())},
            "by_channel": {str(k): v
                           for k, v in sorted(self.by_channel.items())},
            "channel_busy": {str(k): v
                             for k, v in sorted(self.channel_busy.items())},
            "segments": [dataclasses.asdict(s) for s in self.segments],
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    def summary(self, top_k: int = 5) -> str:
        """Human-readable attribution the CLI and examples print."""
        mk = self.makespan_cycles
        lines = [f"critical path over {self.n_ops} ops, "
                 f"makespan={mk:.0f}cyc (coverage={self.coverage_cycles:.0f})"]

        def pct(c: float) -> str:
            return f"{100.0 * c / mk:.1f}%" if mk else "n/a"

        chan = sum(self.by_channel.values())
        lines.append(f"  channel-bound={chan:.0f}cyc ({pct(chan)})  "
                     f"link-bound={self.link_cycles:.0f}cyc "
                     f"({pct(self.link_cycles)})  "
                     f"slack={self.slack_cycles:.0f}cyc "
                     f"({pct(self.slack_cycles)})")
        if self.channel_busy and mk:
            utils = [b / mk for b in self.channel_busy.values()]
            lines.append(f"  channel util: mean="
                         f"{sum(utils) / len(utils):.3f} "
                         f"max={max(utils):.3f} over "
                         f"{len(self.channel_busy)} channels")
        for name, op_id, cyc in self.top(top_k):
            lines.append(f"  #{op_id:<4d} {name:<24s} "
                         f"{cyc:10.0f}cyc  {pct(cyc)}")
        return "\n".join(lines)


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= TOL


def critical_path(ops: Sequence) -> ProfileReport:
    """Walk the op DAG backward from the retiring op; see module doc.

    ``ops`` is any sequence of ``OpHandle``-shaped records.  Returns a
    :class:`ProfileReport` whose segments partition ``[0, makespan]``.
    """
    ops = list(ops)
    by_id = {h.op_id: h for h in ops}
    channel_busy: Dict[int, float] = {}
    for h in ops:
        for ch, (_, b) in h.spans.items():
            channel_busy[ch] = channel_busy.get(ch, 0.0) + b

    makespan = max((h.retire for h in ops), default=0.0)
    if not ops or makespan <= TOL:
        return ProfileReport(
            makespan_cycles=0.0, segments=[], by_op={},
            op_names={h.op_id: h.name for h in ops}, by_channel={},
            link_cycles=0.0, slack_cycles=0.0,
            channel_busy=channel_busy, n_ops=len(ops))

    # every (end, kind, channel, start, op) event, for slack fallback and
    # generic end-matching; "retire" pseudo-events let the walk hop
    # through degenerate zero-busy ops
    events: List[Tuple[float, str, Optional[int], float, object]] = []
    spans_by_ch: Dict[int, List[Tuple[float, float, object]]] = {}
    for h in ops:
        for ch, (s, b) in h.spans.items():
            events.append((s + b, "channel", ch, s, h))
            spans_by_ch.setdefault(ch, []).append((s, s + b, h))
        if h.link_window is not None:
            events.append((h.link_window[1], "link", None,
                           h.link_window[0], h))
        if not h.spans and h.link_window is None:
            events.append((h.retire, "ready", None, h.retire, h))

    def element_ending_at(h, t: float):
        """``h``'s own interval ending at ``t`` (tightest start wins)."""
        best = None
        for ch, (s, b) in h.spans.items():
            if _close(s + b, t) and (best is None or s > best[2]):
                best = ("channel", ch, s)
        if h.link_window is not None and _close(h.link_window[1], t):
            if best is None or h.link_window[0] > best[2]:
                best = ("link", None, h.link_window[0])
        if best is None and _close(h.retire, t):
            best = ("ready", None, t)
        return best

    def pred_at(h, elem_kind: str, elem_ch: Optional[int], s: float):
        """The op binding ``h`` at boundary ``s`` (priority per moduledoc)."""
        for d in h.deps:                               # 1. dependency edge
            dh = by_id.get(d)
            if dh is not None and _close(dh.retire, s):
                return dh
        if elem_kind == "channel":                     # 2. channel queueing
            for (_, e, oh) in spans_by_ch.get(elem_ch, ()):
                if _close(e, s) and oh is not h:
                    return oh
        for oh in ops:                                 # 3. link-bound
            if oh.link_window is not None and _close(oh.link_window[1], s):
                return oh
        for oh in ops:                                 # 4. any retire
            if oh is not h and _close(oh.retire, s) and oh.op_id < h.op_id:
                return oh
        return None

    segments: List[PathSegment] = []
    t = makespan
    cur = max((h for h in ops if _close(h.retire, makespan)),
              key=lambda h: h.op_id)
    visited = set()
    max_iters = 4 * (len(events) + len(ops)) + 16
    for _ in range(max_iters):
        if t <= TOL:
            break
        key = (cur.op_id, round(t, 6))
        slack_forced = key in visited   # revisit ⇒ only slack can progress
        visited.add(key)
        elem = None if slack_forced else element_ending_at(cur, t)
        if elem is not None:
            kind, ch, s = elem
            if kind != "ready":         # ready markers are zero-length
                segments.append(PathSegment(
                    op_id=cur.op_id, name=cur.name, kind=kind,
                    channel=ch, t0=s, t1=t))
                t = s
            if t <= TOL:
                break
            nxt = pred_at(cur, kind, ch, t)
            if nxt is not None:
                cur = nxt
                continue
        # slack: nothing ends at t on the current chain — fall back to
        # the latest event end strictly before t, idle in between
        prior = [(e, h) for (e, _, _, _, h) in events if e < t - TOL]
        if not prior:
            segments.append(PathSegment(
                op_id=cur.op_id, name=cur.name, kind="slack",
                channel=None, t0=0.0, t1=t))
            t = 0.0
            break
        e, owner = max(prior, key=lambda p: p[0])
        segments.append(PathSegment(
            op_id=owner.op_id, name=owner.name, kind="slack",
            channel=None, t0=e, t1=t))
        t = e
        cur = owner
    assert t <= TOL, (
        f"critical-path walk stalled at t={t} (makespan={makespan}); "
        f"{len(segments)} segments so far")

    segments.reverse()                  # chronological
    by_op: Dict[int, float] = {}
    by_channel: Dict[int, float] = {}
    link_cycles = 0.0
    slack_cycles = 0.0
    for seg in segments:
        if seg.kind == "slack":
            slack_cycles += seg.cycles
            continue
        by_op[seg.op_id] = by_op.get(seg.op_id, 0.0) + seg.cycles
        if seg.kind == "channel":
            by_channel[seg.channel] = (
                by_channel.get(seg.channel, 0.0) + seg.cycles)
        elif seg.kind == "link":
            link_cycles += seg.cycles
    return ProfileReport(
        makespan_cycles=makespan, segments=segments, by_op=by_op,
        op_names={h.op_id: h.name for h in ops}, by_channel=by_channel,
        link_cycles=link_cycles, slack_cycles=slack_cycles,
        channel_busy=channel_busy, n_ops=len(ops))
