#!/usr/bin/env python3
"""A traced run of one benchmark cell with the port's span recorder, on
one card: a stop-gap until the benchmark reads the recorder itself.

    python3 tools/serve_spans.py --workload qwen3-1.7b.chat --seed <n> \
        --seconds 51 --spans 1 [--out FILE]

Runs ``portbench``'s traced run (``bench.run_cell(traced=True)``: the
harness's synchronising ``port.Tracer`` and the profiled slice) and,
with ``--spans 1``, gives the served ``Server`` a
``repro_torch.obs.SpanRecorder`` where the Tracer is installed.  The
harness is not edited: this script wraps its ``Tracer.install``,
``bench.serve_window``, ``trace.reduce`` and
``trace.Profile.device_events`` for the run to keep what they see.
Once ``portbench`` hands the recorder to the ``Server`` and reads these
numbers in ``portbench/metrics/`` (ROADMAP B7), this script goes.
Prints one JSON line of readings:

* ``decode_issue_p50_ms`` and ``admit_p50_ms``: the median
  ``model.decode_step`` and ``serve.admit`` span, over spans outside the
  profiled slice;
* ``decode_issue_idle``: % of the slice in which the card idles under
  ``model.decode_step`` or a span inside it;
* ``idle_by_span``: the slice's idle seconds by the path of the innermost
  open span (``repro_torch.obs.spans.innermost``), the harness's sleeps
  and the rest (``trace.OUTSIDE``) apart, and ``decode_split``: the
  decode steps' host seconds in attention, MLP and the rest;
* ``port``: the harness's ``decode_mfu``, ``k1_roofline.decode`` and
  ``itl_p95_ms`` read from the port's records alone: the ``serve.decode``
  spans and their ``positions``, the K1 records (shape and element
  bytes) stamped inside the slice, paired in order with its ``ame_gemm``
  kernels, and each request's token stamps (the end of its
  ``serve.first_token``, then of each ``serve.step`` whose ``uids`` name
  it), beside ``itl_p95_ms`` from the harness's own stamps of the run;
* ``k1_match``: whether the recorder's K1 records equal the Tracer's in
  count, order, (m, k, n) and phase;
* ``anchor_offset_us``: the slice's first device event mapped by the
  recorder's clock anchors, less the harness's marker stamp;
* ``tracer_decode_p50_ms``: the Tracer's synchronised decode span, the
  yardstick with the recorder on and off; ``per_step``: spans and launch
  records a ``serve.step``;
* ``experts`` (a sigmoid-routed MoE): the ``model.experts`` counters
  of the decode steps, ``routed`` a live row and ``held_reached``, each
  a layer's mean, beside the family file's expectation
  (:func:`expert_counts`);
* ``metrics``: the harness's per-layer readings of the same run, and
  ``breakdown``: its busy time, top device ops and idle gaps;
  ``micro_ns``: the recorder's own cost per span and per launch record.
"""
import argparse
import json
import statistics
import sys
import time

T_START = time.perf_counter()

import os  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ.setdefault(var, str(CACHE / sub))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def micro_ns(n: int = 20000):
    """ns per open/close pair and per launch record, on this host."""
    from repro_torch.obs import SpanRecorder
    rec = SpanRecorder()
    top = rec.open("serve.step")
    t = time.perf_counter_ns()
    for _ in range(n):
        rec.close(rec.open("model.attention"))
    span = (time.perf_counter_ns() - t) / n
    t = time.perf_counter_ns()
    for _ in range(n):
        rec.launch("k1", 32, 2048, 2048, 2, 2)
    launch = (time.perf_counter_ns() - t) / n
    rec.close(top)
    return {"span": span, "launch": launch}


def _overlaps(s, lo_ns, hi_ns):
    return s["start_ns"] < hi_ns and s["end_ns"] > lo_ns


def readings(recs, tracer, seen, outside_label):
    from portbench import trace
    from repro_torch.obs import spans as sp
    ss = recs["spans"]
    lo, hi = seen["lo"], seen["hi"]
    lo_ns, hi_ns = lo * 1e9, hi * 1e9

    def p50_ms(name):
        d = [s["end_ns"] - s["start_ns"] for s in ss if s["name"] == name
             and s["end_ns"] is not None and not _overlaps(s, lo_ns, hi_ns)]
        return statistics.median(d) / 1e6 if d else None

    busy = trace.merge([(s, e) for _, s, e in seen["events"]], lo, hi)
    idle, t = [], lo
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = e
    if t < hi:
        idle.append((t, hi))
    parts = sp.innermost(ss, [(s * 1e9, e * 1e9) for s, e in idle])
    # idle under no port span: the harness's sleeps, else outside
    none_ns = parts.pop(None, 0.0)
    sleeps = trace.merge([(s, e) for label, s, e in seen["host"]
                          if label == "waiting for the next arrival"],
                         lo, hi)
    slept = 0.0
    for gs, ge in idle:
        for s, e in sleeps:
            o = min(ge, e) - max(gs, s)
            if o > 0:
                slept += o
    by_span = {k: v / 1e9 for k, v in sorted(parts.items(),
                                             key=lambda kv: -kv[1])}
    by_span["harness sleep"] = slept
    by_span[outside_label] = none_ns / 1e9 - slept
    window = hi - lo
    n_steps = max(1, sum(s["name"] == "serve.step" for s in ss))
    under_decode = sum(v for k, v in by_span.items()
                       if "model.decode_step" in k.split("/"))

    # the decode steps' host time: attention, MLP and the rest
    steps = [s for s in ss if s["name"] == "model.decode_step"
             and s["end_ns"] is not None]
    step_ids = {s["id"] for s in steps}
    split = {"attention": 0, "mlp": 0}
    for s in ss:
        if s["parent"] in step_ids and s["name"] in ("model.attention",
                                                     "model.mlp"):
            split[s["name"][6:]] += s["end_ns"] - s["start_ns"]
    total = sum(s["end_ns"] - s["start_ns"] for s in steps)
    split["rest"] = total - split["attention"] - split["mlp"]
    decode_split = {k: v / 1e9 for k, v in split.items()}

    path = sp.paths(ss)

    def phase(sid):
        names = path[sid].split("/")
        return "prefill" if "model.prefill" in names else \
            "decode" if "model.decode_step" in names else None

    mine = [(ln["m"], ln["k"], ln["n"], phase(ln["span"]))
            for ln in recs["launches"] if ln["kernel"] == "k1"]
    theirs = [(ln["m"], ln["k"], ln["n"], ln["phase"]) for ln in tracer.k1]
    anchor_off = None
    if seen.get("raw0_ns") is not None:
        anchor_off = (sp.unix_to_perf_ns(recs["anchors"], seen["raw0_ns"])
                      - seen["t_mark"] * 1e9) / 1e3
    return {
        "decode_issue_p50_ms": p50_ms("model.decode_step"),
        "admit_p50_ms": p50_ms("serve.admit"),
        "decode_issue_idle": 100.0 * under_decode / window,
        "slice_s": window,
        "idle_s": sum(e - s for s, e in idle),
        "idle_by_span": by_span,
        "idle_unlabelled_share": 100.0 * by_span[outside_label] / window,
        "decode_split": decode_split,
        "k1_match": mine == theirs,
        "k1_counts": [len(mine), len(theirs)],
        "anchor_offset_us": anchor_off,
        "per_step": {"spans": len(ss) / n_steps,
                     "launches": len(recs["launches"]) / n_steps},
    }


def port_readings(recs, seen, cfg):
    """``decode_mfu``, ``k1_roofline.decode`` and ``itl_p95_ms`` as the
    harness's readers define them, from the port's records alone."""
    from portbench import roofline, stats, work
    from repro_torch.obs import spans as sp
    ss = recs["spans"]
    lo_ns, hi_ns = seen["lo"] * 1e9, seen["hi"] * 1e9
    by_id = {s["id"]: s for s in ss}
    path = sp.paths(ss)

    dec = [s for s in ss if s["name"] == "serve.decode"
           and s["end_ns"] is not None and not _overlaps(s, lo_ns, hi_ns)]
    need = sum(work.bound_s(*work.decode_work(cfg, s["attrs"]["positions"]))
               [0] for s in dec)
    took = sum(s["end_ns"] - s["start_ns"] for s in dec) / 1e9
    mfu = 100.0 * need / took if dec else None

    k1_s = [e - s for n, s, e in seen["events"] if "ame_gemm" in n]
    mine = [ln for ln in recs["launches"] if ln["kernel"] == "k1"
            and lo_ns <= ln["t_ns"] <= hi_ns]
    k1_roof = None
    if mine and len(mine) == len(k1_s):
        pairs = [(ln, d) for ln, d in zip(mine, k1_s)
                 if "model.decode_step" in path[ln["span"]].split("/")]
        k1_roof = 100.0 * sum(roofline.k1(ln) for ln, _ in pairs) \
            / sum(d for _, d in pairs)

    # each request's token stamps, as the harness takes them: its first
    # token's host sync, then the end of every step that gave it one
    stamps = {}
    for s in ss:
        if s["name"] == "serve.first_token":
            stamps[by_id[s["parent"]]["attrs"]["uid"]] = [s["end_ns"] / 1e9]
    for s in ss:
        if s["name"] == "serve.step":
            for uid in s["attrs"].get("uids", ()):
                stamps[uid].append(s["end_ns"] / 1e9)
    win = seen["win"]
    gaps = [b - a for st in stamps.values() for a, b in zip(st, st[1:])
            if b <= win.t_end]
    itl = 1e3 * stats.percentile(gaps, 95) if gaps else None
    return {"decode_mfu": mfu, "k1_roofline.decode": k1_roof,
            "itl_p95_ms": itl,
            "harness_itl_p95_ms": stats.itl_tail_ms(win, 95),
            "decode_steps": len(dec), "k1_in_slice": [len(mine), len(k1_s)],
            "itl_gaps": [len(gaps), len(stats.itl_s(win.requests,
                                                    win.t_end))]}


def expert_counts(recs, cfg):
    """The counters of the ``model.experts`` spans (a sigmoid-routed MoE)
    under the decode steps: each MoE layer's ``held_reached`` and its
    ``routed`` pairs a live row, as means over (step, layer), beside
    what ``families/<family>.py`` expects at each step's live rows
    (``held_reached``) and under routing spread evenly (``routed``:
    top_k x held / num_experts); None without such spans."""
    import importlib
    fam = importlib.import_module(f"portbench.families.{cfg['family']}")
    ss = recs["spans"]
    by_id = {s["id"]: s for s in ss}
    rows, reached, expect = [], [], []
    for s in ss:
        if s["name"] != "model.experts":
            continue
        up = by_id[s["parent"]]
        while up["name"] != "serve.decode" and up["parent"] is not None:
            up = by_id[up["parent"]]
        if up["name"] != "serve.decode":
            continue                    # a prefill's
        m = len(up["attrs"]["positions"])
        rows.append(s["attrs"]["routed"] / m)
        reached.append(s["attrs"]["held_reached"])
        expect.append(fam.held_reached(cfg, m))
    if not rows:
        return None
    mo = cfg["moe"]
    return {"layer_steps": len(rows),
            "routed_per_live_row": statistics.mean(rows),
            "routed_per_live_row_even": mo["top_k"] * fam.held(cfg)
            / mo["num_experts"],
            "held_reached": statistics.mean(reached),
            "held_reached_expected": statistics.mean(expect)}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="tools/serve_spans.py")
    ap.add_argument("--workload", default="qwen3-1.7b.chat")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None,
                    help="append the JSON line to this file too")
    args = ap.parse_args(argv)

    import torch
    from portbench import bench, port, trace
    from repro_torch.obs import SpanRecorder

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    seen = {}
    install, reduce_, device_events = (port.Tracer.install, trace.reduce,
                                       trace.Profile.device_events)
    serve_window = bench.serve_window

    def install_with_spans(self):
        install(self)
        seen["tracer"] = self
        if args.spans:
            self.srv.spans = seen["rec"] = SpanRecorder()

    def keep_window(*args, **kw):
        seen["win"] = serve_window(*args, **kw)
        return seen["win"]

    def keep_reduce(events, lo, hi, host):
        seen.update(events=events, lo=lo, hi=hi, host=host)
        return reduce_(events, lo, hi, host)

    def keep_first_event(self):
        raw = sorted(e.start_ns() for e in
                     self.prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA)
        seen.update(raw0_ns=raw[0] if raw else None, t_mark=self.t_mark)
        return device_events(self)

    port.Tracer.install = install_with_spans
    bench.serve_window = keep_window
    trace.reduce = keep_reduce
    trace.Profile.device_events = keep_first_event
    torch.set_num_threads(4)
    cell = bench.cell_of(bench.load_spec(), args.workload, True)
    result = bench.run_cell(cell, args.seed, args.seconds, True,
                            torch.device("cuda", 0), T_START, log)
    tracer = seen["tracer"]
    dec = [s["end"] - s["start"] for s in tracer.spans
           if s["phase"] == "decode" and not s["profiled"]]
    line = {"seed": args.seed, "spans": args.spans,
            "card": bench._card(), "correct": result["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "tracer_decode_p50_ms": 1e3 * statistics.median(dec),
            "breakdown": result.get("breakdown"),
            "micro_ns": micro_ns()}
    if args.spans:
        recs = seen["rec"].records()
        line.update(readings(recs, tracer, seen, trace.OUTSIDE))
        line["port"] = port_readings(recs, seen, cell["cfg"])
        if cell["cfg"].get("moe"):
            line["experts"] = expert_counts(recs, cell["cfg"])
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
