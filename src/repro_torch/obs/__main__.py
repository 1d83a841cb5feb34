"""``python -m repro_torch.obs <file>`` — summarize observability artifacts.

Accepts any of the three on-disk formats this repo produces and prints
a terminal summary:

* a Chrome trace JSON (``{"traceEvents": [...]}``) exported by
  :func:`repro_torch.obs.profile.export_chrome_trace` — per-track busy time,
  op counts, flow-edge count;
* a dumped :class:`repro_torch.obs.critical_path.ProfileReport` JSON
  (``{"profile_report": 1, ...}``) — the attribution summary;
* a ``.trace`` command trace (:mod:`repro_torch.runtime.trace` line grammar)
  — command/transaction counts per channel, marker totals.

Port of ``python -m repro.obs``; the output is the reference's.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Dict

from repro_torch.obs.critical_path import PathSegment, ProfileReport


def _summarize_chrome(trace: Dict) -> str:
    events = trace.get("traceEvents", [])
    other = trace.get("otherData", {})
    names: Dict[tuple, str] = {}
    busy_us: collections.Counter = collections.Counter()
    ops_per_track: collections.Counter = collections.Counter()
    op_names: collections.Counter = collections.Counter()
    flows = 0
    for ev in events:
        ph = ev.get("ph")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "M":
            if ev.get("name") == "process_name":
                names[(ev.get("pid"), None)] = ev["args"]["name"]
            elif ev.get("name") == "thread_name":
                names[key] = ev["args"]["name"]
        elif ph == "X" and ev.get("cat") in ("op", "link"):
            busy_us[key] += ev.get("dur", 0.0)
            ops_per_track[key] += 1
            op_names[ev.get("name", "?")] += 1
        elif ph == "s" and ev.get("cat") == "dep":
            flows += 1
    lines = [f"chrome trace: {len(events)} events, "
             f"{sum(ops_per_track.values())} op slices, "
             f"{flows} dep flows"]
    if other:
        lines.append(
            f"  makespan={other.get('makespan_cycles', 0):.0f}cyc  "
            f"ops={other.get('n_ops', '?')}  "
            f"stacks={other.get('n_stacks', '?')}")
    for key in sorted(busy_us):
        pid, tid = key
        proc = names.get((pid, None), f"pid {pid}")
        thread = names.get(key, f"tid {tid}")
        lines.append(f"  [{proc} / {thread}] "
                     f"busy={busy_us[key]:.3f}us "
                     f"slices={ops_per_track[key]}")
    for name, cnt in op_names.most_common(8):
        lines.append(f"  op {name!r}: {cnt} slices")
    return "\n".join(lines)


def _summarize_report(data: Dict, top: int = 5) -> str:
    rep = ProfileReport(
        makespan_cycles=data["makespan_cycles"],
        segments=[PathSegment(**s) for s in data.get("segments", [])],
        by_op={int(k): v for k, v in data.get("by_op", {}).items()},
        op_names={int(k): v for k, v in data.get("op_names", {}).items()},
        by_channel={int(k): v
                    for k, v in data.get("by_channel", {}).items()},
        link_cycles=data.get("link_cycles", 0.0),
        slack_cycles=data.get("slack_cycles", 0.0),
        channel_busy={int(k): v
                      for k, v in data.get("channel_busy", {}).items()},
        n_ops=data.get("n_ops", 0))
    return rep.summary(top_k=top)


def _summarize_trace(text: str) -> str:
    from repro_torch.runtime.trace import parse_trace
    st = parse_trace(text)
    lines = [f"command trace: {st.pim_commands} PIM commands, "
             f"{st.launches} launches, {st.cfr_writes} CFR writes"]
    if st.opcodes:
        ops = " ".join(f"{k}={v}" for k, v in sorted(st.opcodes.items()))
        lines.append(f"  opcodes: {ops}")
    for ch in st.channels:
        lines.append(
            f"  ch {ch}: pim={st.pim_per_channel.get(ch, 0)} "
            f"w={st.mem_writes.get(ch, 0)} r={st.mem_reads.get(ch, 0)} "
            f"resident_bytes={st.resident_bytes.get(ch, 0)} "
            f"spill_bytes={st.spill_bytes.get(ch, 0)}")
    if st.stacks_seen:
        lines.append(f"  stacks: {sorted(set(st.stacks_seen))} "
                     f"host_link_bytes={dict(st.host_link_bytes)}")
    if st.op_starts:
        lines.append(f"  async markers: {len(st.op_starts)} TSTART / "
                     f"{len(st.op_ends)} TEND over "
                     f"{len({op for _, op in st.op_starts})} ops")
    if st.kvappend_bytes or st.kvevict_bytes:
        lines.append(
            f"  kv markers: append_bytes={sum(st.kvappend_bytes.values())} "
            f"evict_bytes={sum(st.kvevict_bytes.values())} over "
            f"{len(set(st.kvappend_bytes) | set(st.kvevict_bytes))} channels")
    if st.link_stacks_seen:
        lines.append(
            f"  stack links: {sorted(set(st.link_stacks_seen))} "
            f"bytes_per_link={dict(st.host_link_bytes_per_link)}")
    if st.migrate_events:
        lines.append(
            f"  migrate markers: {len(st.migrate_events)} events, "
            f"{sum(m[4] for m in st.migrate_events)} bytes")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="summarize a .trace file, Chrome trace JSON, or "
                    "ProfileReport JSON")
    ap.add_argument("path", help="artifact to summarize")
    ap.add_argument("--top", type=int, default=5,
                    help="top-k ops for profile reports (default 5)")
    ns = ap.parse_args(argv)
    with open(ns.path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        data = json.loads(text)
        if "traceEvents" in data:
            print(_summarize_chrome(data))
        elif "profile_report" in data or "makespan_cycles" in data:
            print(_summarize_report(data, top=ns.top))
        else:
            print("unrecognized JSON artifact (expected traceEvents or "
                  "profile_report)", file=sys.stderr)
            return 2
    else:
        print(_summarize_trace(text))
    return 0


if __name__ == "__main__":
    sys.exit(main())
