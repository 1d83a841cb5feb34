"""Timeline profiler: op log capture and Chrome Trace Event export.

Two capture paths feed one export/analysis pipeline:

* **async runtimes** already keep the full op log —
  ``PIMRuntime(async_mode=True).timeline.ops`` records every
  :class:`~repro_torch.runtime.timeline.OpHandle` with spans, link windows and
  dep edges.  Profiling an async runtime reads that log as-is: zero
  capture cost, nothing extra runs during scheduling.
* **serialized runtimes** have no clock, so :class:`Profiler` keeps a
  *shadow* log: each op is barrier-placed on a pseudo-clock (every span
  opens at the previous op's retire, exactly the serialized
  accumulation semantics ``pim_cycles += rep.cluster_makespan_cycles``)
  and chained to its predecessor with a dep edge.  The shadow records
  are plain :class:`OpHandle`\\ s, so the critical-path walk and the
  trace exporter run unchanged on either source.

The export target is Chrome Trace Event Format JSON — the
``{"traceEvents": [...]}`` dict Perfetto (https://ui.perfetto.dev) and
``chrome://tracing`` load directly.  Track mapping:

* one *process* per stack (``pid`` = stack index, named ``stack N``)
  plus one for the shared host link (``pid`` = n_stacks,
  ``host-link``);
* one *thread* per pseudo-channel within its stack (``tid`` = local
  channel id, named with the flat id so cluster traces stay
  unambiguous);
* one complete event (``ph: "X"``) per (op, channel) span, with h2d /
  compute / d2h **phase sub-slices** nested inside it when the op
  carries a :class:`~repro_torch.runtime.scheduler.ChannelReport` (the
  overlap busy model places lead-in first, the stream window second,
  the drain last; ``overlap=False`` reports nest strictly
  sequentially);
* one ``ph: "s"`` / ``ph: "f"`` **flow pair per dep edge** — Perfetto
  draws these as arrows from the producer's retire to the consumer's
  first span.

Timestamps are microseconds (Chrome's unit) at the 250 MHz PIM clock:
``us = cycles / 250``.  Cycle values ride along in ``args`` so nothing
is lost to the unit conversion.

Port of ``repro.obs.profile``: host code that reads the port's
:class:`~repro_torch.runtime.timeline.OpHandle` logs; traces are the
reference's, byte for byte.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from repro_torch.core.isa import PIM_FREQ_HZ
from repro_torch.runtime.timeline import OpHandle

from repro_torch.obs.critical_path import ProfileReport, critical_path

#: Chrome trace timestamps are microseconds; the PIM clock is 250 MHz
US_PER_CYCLE = 1e6 / PIM_FREQ_HZ


class Profiler:
    """Shadow op log for a serialized (``async_mode=False``) runtime.

    Attached via ``PIMRuntime(profile=True)`` (or an explicit instance);
    the scheduler calls :meth:`on_op` after each op's ledgers close.
    Records are barrier-placed: every span and link window opens at the
    previous op's retire, so the shadow clock's frontier equals the sum
    of per-op ``cluster_makespan_cycles`` — the serialized wall-clock.

    Strictly additive: the profiler only *reads* each op's finished
    report; ledgers, traces and numerics are untouched (property-tested
    against an unprofiled twin).
    """

    def __init__(self):
        self.ops: List[OpHandle] = []
        self.runtime = None
        self._clock = 0.0
        self._next_id = 1

    def attach(self, runtime) -> "Profiler":
        self.runtime = runtime
        return self

    @property
    def now(self) -> float:
        """The shadow clock frontier (serialized wall-clock so far)."""
        return self._clock

    def on_op(self, name: str, channel_busy: Dict[int, float],
              link_cycles: int = 0, report=None, result=None) -> OpHandle:
        """Barrier-place one finished op on the shadow clock."""
        t0 = self._clock
        spans = {ch: (t0, float(b)) for ch, b in channel_busy.items()
                 if b > 0}
        link_window = (t0, t0 + link_cycles) if link_cycles > 0 else None
        ends = [s + b for s, b in spans.values()]
        if link_window is not None:
            ends.append(link_window[1])
        retire = max(ends, default=t0)
        handle = OpHandle(
            op_id=self._next_id, name=name,
            deps=(self.ops[-1].op_id,) if self.ops else (),
            start=t0, retire=retire, spans=spans,
            link_window=link_window, report=report, result=result)
        self._next_id += 1
        self._clock = retire
        self.ops.append(handle)
        return handle

    def amend_last(self, name: str, report=None) -> None:
        """Rename the most recent record (the gemv-wraps-gemm case)."""
        assert self.ops, "no op recorded yet"
        self.ops[-1].name = name
        if report is not None:
            self.ops[-1].report = report


def _ops_of(runtime) -> List[OpHandle]:
    """The op log backing ``runtime`` — timeline (async) or shadow."""
    tl = getattr(runtime, "timeline", None)
    if tl is not None:
        return tl.ops
    prof = getattr(runtime, "profile", None)
    if prof is not None:
        return prof.ops
    raise ValueError(
        "runtime has no op log: construct it with async_mode=True or "
        "profile=True to capture one")


def _topology(runtime):
    """(stack_of, local_of, n_stacks) channel-mapping helpers."""
    cluster = getattr(runtime, "_cluster", None)
    if cluster is not None:
        cps = cluster.channels_per_stack
        return (lambda ch: ch // cps), (lambda ch: ch % cps), \
            cluster.n_stacks
    return (lambda ch: 0), (lambda ch: ch), 1


def _phase_slices(cr) -> List[Dict]:
    """(name, offset, dur, args) phase breakdown of one ChannelReport,
    offsets relative to the span start, per the busy model."""
    out = []
    if not cr.overlap:               # synchronous DMA: strict sequence
        t = 0.0
        for name, dur in (("h2d", cr.h2d_cycles),
                          ("compute", cr.compute_cycles),
                          ("d2h", cr.d2h_cycles)):
            if dur > 0:
                out.append({"name": name, "off": t, "dur": float(dur)})
            t += dur
        return out
    stream = max(cr.compute_cycles, cr.h2d_cycles - cr.lead_in_cycles)
    if cr.lead_in_cycles > 0:
        out.append({"name": "h2d", "off": 0.0,
                    "dur": float(cr.lead_in_cycles)})
    if stream > 0:
        out.append({"name": "compute", "off": float(cr.lead_in_cycles),
                    "dur": float(stream),
                    "args": {"compute_cycles": cr.compute_cycles,
                             "h2d_stream_cycles": max(
                                 0, cr.h2d_cycles - cr.lead_in_cycles)}})
    if cr.d2h_cycles > 0:
        out.append({"name": "d2h",
                    "off": float(cr.lead_in_cycles) + stream,
                    "dur": float(cr.d2h_cycles)})
    return out


def chrome_trace(runtime) -> Dict:
    """The full Chrome Trace Event dict for ``runtime``'s op log."""
    ops = _ops_of(runtime)
    stack_of, local_of, n_stacks = _topology(runtime)
    link_pid = n_stacks
    events: List[Dict] = []

    # track metadata: processes = stacks (+ link), threads = channels
    seen_tracks = set()
    for s in range(n_stacks):
        events.append({"ph": "M", "pid": s, "tid": 0,
                       "name": "process_name",
                       "args": {"name": f"stack {s}"}})
        events.append({"ph": "M", "pid": s, "tid": 0,
                       "name": "process_sort_index", "args": {"sort_index": s}})
    events.append({"ph": "M", "pid": link_pid, "tid": 0,
                   "name": "process_name", "args": {"name": "host-link"}})
    events.append({"ph": "M", "pid": link_pid, "tid": 0,
                   "name": "process_sort_index",
                   "args": {"sort_index": link_pid}})
    events.append({"ph": "M", "pid": link_pid, "tid": 0,
                   "name": "thread_name", "args": {"name": "link"}})

    for h in ops:
        for ch in sorted(h.spans):
            s, b = h.spans[ch]
            pid, tid = stack_of(ch), local_of(ch)
            if (pid, tid) not in seen_tracks:
                seen_tracks.add((pid, tid))
                events.append({
                    "ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name",
                    "args": {"name": f"ch {pid}.{tid} (flat {ch})"}})
                events.append({
                    "ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_sort_index",
                    "args": {"sort_index": tid}})
            args = {"op_id": h.op_id, "channel": ch,
                    "start_cycles": s, "busy_cycles": b}
            cr = None
            if h.report is not None:
                cr = next((c for c in h.report.per_channel
                           if c.channel == ch), None)
            if cr is not None:
                args.update(flops=cr.flops, h2d_bytes=cr.h2d_bytes,
                            d2h_bytes=cr.d2h_bytes,
                            reuse_bytes=cr.reuse_bytes)
            events.append({"ph": "X", "cat": "op", "name": h.name,
                           "pid": pid, "tid": tid,
                           "ts": s * US_PER_CYCLE,
                           "dur": b * US_PER_CYCLE, "args": args})
            if cr is not None:
                for ph in _phase_slices(cr):
                    events.append({
                        "ph": "X", "cat": "phase", "name": ph["name"],
                        "pid": pid, "tid": tid,
                        "ts": (s + ph["off"]) * US_PER_CYCLE,
                        "dur": ph["dur"] * US_PER_CYCLE,
                        "args": ph.get("args", {})})
        if h.link_window is not None:
            ls, le = h.link_window
            args = {"op_id": h.op_id, "start_cycles": ls,
                    "link_cycles": le - ls}
            if h.report is not None:
                args["link_bytes"] = h.report.host_link_bytes
            events.append({"ph": "X", "cat": "link", "name": h.name,
                           "pid": link_pid, "tid": 0,
                           "ts": ls * US_PER_CYCLE,
                           "dur": (le - ls) * US_PER_CYCLE, "args": args})

    # dep edges as flow arrows: producer retire -> consumer first span
    by_id = {h.op_id: h for h in ops}
    for h in ops:
        dst = min(h.spans.items(), key=lambda kv: kv[1][0], default=None)
        for d in h.deps:
            src = by_id.get(d)
            if src is None:
                continue
            # anchor the arrow tail inside the producer's last interval
            tail = max(((ch, se) for ch, se in
                        ((c, sp[0] + sp[1]) for c, sp in src.spans.items())),
                       key=lambda kv: kv[1], default=None)
            flow_id = f"d{src.op_id}_{h.op_id}"
            if tail is not None:
                tch, tend = tail
                events.append({"ph": "s", "cat": "dep", "name": "dep",
                               "id": flow_id,
                               "pid": stack_of(tch), "tid": local_of(tch),
                               "ts": tend * US_PER_CYCLE})
            elif src.link_window is not None:
                events.append({"ph": "s", "cat": "dep", "name": "dep",
                               "id": flow_id, "pid": link_pid, "tid": 0,
                               "ts": src.link_window[1] * US_PER_CYCLE})
            else:
                continue                     # degenerate producer: no anchor
            if dst is not None:
                dch, (ds, _) = dst
                events.append({"ph": "f", "bp": "e", "cat": "dep",
                               "name": "dep", "id": flow_id,
                               "pid": stack_of(dch), "tid": local_of(dch),
                               "ts": ds * US_PER_CYCLE})
            elif h.link_window is not None:
                events.append({"ph": "f", "bp": "e", "cat": "dep",
                               "name": "dep", "id": flow_id,
                               "pid": link_pid, "tid": 0,
                               "ts": h.link_window[0] * US_PER_CYCLE})
            else:                            # degenerate consumer: drop tail
                events.pop()

    # fault-injection instants (repro_torch.faults): injection / recovery /
    # retransmit markers as Perfetto instant events on the affected
    # channel's track (channel -1 = the host link)
    inj = getattr(runtime, "faults", None)
    if inj is not None:
        for kind, cycle, ch, label in inj.instants:
            if ch < 0:
                pid, tid = link_pid, 0
            else:
                pid, tid = stack_of(ch), local_of(ch)
            events.append({"ph": "i", "s": "g", "cat": "fault",
                           "name": f"{kind}: {label}",
                           "pid": pid, "tid": tid,
                           "ts": cycle * US_PER_CYCLE,
                           "args": {"kind": kind, "cycle": cycle,
                                    "channel": ch}})

    makespan = max((h.retire for h in ops), default=0.0)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            # the trace format's name, the reference's: traces of both
            # packages compare byte for byte
            "source": "repro.obs",
            "clock_hz": PIM_FREQ_HZ,
            "makespan_cycles": makespan,
            "n_ops": len(ops),
            "n_stacks": n_stacks,
        },
    }


def export_chrome_trace(runtime, path: Optional[str] = None) -> Dict:
    """Serialize ``runtime``'s op log to Chrome Trace JSON; optionally
    write it to ``path`` (open the file at https://ui.perfetto.dev)."""
    trace = chrome_trace(runtime)
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def profile_report(runtime) -> ProfileReport:
    """Critical-path attribution of ``runtime``'s op log."""
    return critical_path(_ops_of(runtime))
