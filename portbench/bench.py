"""One run of one cell: set-up, the measured window, metrics, the check.

Set-up builds (or finds built) the kernels, makes the weights from the
seed on the card, builds one ``repro_torch.serve.loop.Server`` with the
benchmark's ``perf_counter`` clock and warms the shapes of the cell's
traffic.  The window then drives ``Server.submit`` and ``Server.step``
for ``--seconds`` under the cell's seeded open-loop schedule; requests
are timed from when they were due.  After the window the run steps on,
for at most the cell's ``wait_share`` of a window, until every request
due in it has its first token (a cell offered more than the server
completes waits for none).  Then the server is freed and the check
runs.

With ``--trace 1`` the same run records spans and launch shapes
(``port.Tracer``) and profiles a short steady slice of the window
(``trace.Profile``); it prints the per-layer metrics in place of the
end-to-end ones.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from portbench import arrivals, check, trace
from portbench import weights as weights_mod

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: top-level module names that a run may not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: where the profiled slice starts and how long it lasts, as shares of
#: the window, and its longest length in seconds
PROFILE_AT, PROFILE_SHARE, PROFILE_MAX_S = 0.4, 0.2, 3.0


def load_spec(root: Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metric_entries(spec: Dict, cell: str, traced: bool) -> List[Dict]:
    """The end-to-end metrics of ``cell``, or with ``traced`` its
    per-layer ones: those that list it, else those that move one of its
    end-to-end metrics."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def cell_of(spec: Dict, name: str, traced: bool) -> Dict:
    """Everything one run of cell ``name`` reads, from the files that
    ``BENCHMARK.json`` names: the configuration, the traffic mix, and the
    cell's own file (``cells/<name>.json``: its offered rate, how long
    the run waits for the window's first tokens, and the check's
    limits)."""
    w = next((w for w in spec["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    mix = arrivals.load(PKG / "traffic" / f"{w['traffic']}.json")
    own = json.loads((PKG / "cells" / f"{name}.json").read_text())
    return dict(name=name, chips=w["chips"], cfg=cfg, mix=mix,
                rate=float(own["rate_rps"]),
                wait_share=float(own["wait_share"]), limits=own,
                metrics=metric_entries(spec, name, traced))


def reader(name: str):
    """The ``read(run)`` of ``metrics/<name>.py``."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def warm(srv, prompts, new_tokens: int = 4) -> None:
    """Prefill each warm prompt and decode a few steps over the full slot
    batch, then forget those requests."""
    from portbench import port
    for j, p in enumerate(prompts):
        srv.submit(port.request(-1 - j, p, new_tokens))
    srv.run_until_drained()
    srv.completed.clear()


def serve_window(srv, sched: List[arrivals.Arrival], seconds: float,
                 wait_share: float, tracer=None,
                 profile: Optional[trace.Profile] = None) -> SimpleNamespace:
    """Drive the server under ``sched`` for ``seconds``, then for at most
    ``wait_share * seconds`` more until every request due in the window
    has its first token; returns the window's stamps (``perf_counter``
    seconds)."""
    from portbench import port
    recs, live, sleeps = [], [], []
    t0 = time.perf_counter()
    t_end, t_stop = t0 + seconds, t0 + (1.0 + wait_share) * seconds
    p_on = t0 + PROFILE_AT * seconds
    p_off = p_on + min(PROFILE_MAX_S, PROFILE_SHARE * seconds)
    i = 0
    while True:
        now = time.perf_counter()
        while i < len(sched) and t0 + sched[i].due_s <= now:
            a = sched[i]
            req = port.request(a.uid, a.prompt, a.max_new)
            srv.submit(req)
            recs.append(dict(uid=a.uid, due=t0 + a.due_s, submitted=now,
                             req=req, stamps=[]))
            live.append(recs[-1])
            i += 1
        if profile is not None:
            if profile.prof is None and now >= p_on:
                profile.start()
                tracer.profiling = True
            elif tracer.profiling and now >= p_off:
                profile.stop()
                tracer.profiling = False
        if now >= t_stop or (now >= t_end and i == len(sched) and all(
                r["stamps"] for r in recs)):
            break
        if srv.queue or any(a is not None for a in srv.active):
            srv.step()
            stamp = time.perf_counter()
            for r in live:
                n = len(r["req"].out_tokens)
                if n > len(r["stamps"]):
                    if not r["stamps"]:
                        r["stamps"].append(r["req"].first_token_at)
                    r["stamps"] += [stamp] * (n - len(r["stamps"]))
            live = [r for r in live if not r["req"].done]
        else:
            wake = min(t0 + sched[i].due_s if i < len(sched) else t_end,
                       t_stop)
            if profile is not None and p_on > now:
                wake = min(wake, p_on if profile.prof is None else p_off)
            elif tracer is not None and tracer.profiling:
                wake = min(wake, p_off)
            wake = max(wake, now)
            time.sleep(wake - now)
            sleeps.append(("waiting for the next arrival", now,
                           time.perf_counter()))
    if tracer is not None and tracer.profiling:
        profile.stop()
        tracer.profiling = False
    t_last = time.perf_counter()
    requests = [dict(uid=r["uid"], due=r["due"], stamps=r["stamps"],
                     prompt_len=len(r["req"].prompt),
                     max_new=r["req"].max_new,
                     admitted_at=r["req"].admitted_at
                     if r["req"].admitted_at else None,
                     first_token_at=r["stamps"][0] if r["stamps"] else None)
                for r in recs]
    return SimpleNamespace(t0=t0, t_end=t_end, t_last=t_last,
                           seconds=seconds, requests=requests,
                           sleeps=sleeps)


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if shutil.which("nvidia-smi") is None:
        return torch.cuda.get_device_name(0)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else torch.cuda.get_device_name(0)


def _match(launches: List[Dict], device_s: List[float]) -> bool:
    """Give each profiled launch its kernel's device time, pairing the
    n-th launch with the n-th kernel of its name on the one stream."""
    mine = [ln for ln in launches if ln["profiled"]]
    if len(mine) != len(device_s):
        return False
    for ln, s in zip(mine, device_s):
        ln["device_s"] = s
    return True


def run_cell(cell: Dict, seed: int, seconds: float, traced: bool, device,
             t_start: float, log=print) -> Dict:
    """Set up, serve the window, read the metrics and check the output;
    returns the result line as a dict."""
    from portbench import port
    cfg, mix = cell["cfg"], cell["mix"]
    a = port.arch(cfg)
    if device.type == "cuda":
        built = port.build_kernels(a)
        log(f"kernels: nvcc seconds {built} (0.0: already built)")
    t_w = time.perf_counter()
    w = weights_mod.make(port.meta_params(a), seed, device)
    t_s = time.perf_counter()
    srv = port.server(a, w, mix, device)
    t_m = time.perf_counter()
    warm(srv, arrivals.warm_prompts(mix, seed, cfg["vocab_size"]))
    log(f"set-up: {t_w - t_start:.3f} s to the weights (imports, CUDA, "
        f"kernels), weights {t_s - t_w:.3f} s, Server {t_m - t_s:.3f} s, "
        f"warm-up {time.perf_counter() - t_m:.3f} s")
    sched = arrivals.schedule(mix, cell["rate"], seconds, seed,
                              cfg["vocab_size"])
    tracer = profile = None
    if traced:
        tracer = port.Tracer(srv)
        tracer.install()
        profile = trace.Profile(device) if device.type == "cuda" else None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    try:
        win = serve_window(srv, sched, seconds, cell["wait_share"], tracer,
                           profile)
    finally:
        if tracer is not None:
            tracer.remove()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    finished = list(srv.completed)
    refused = len(srv.failed_requests)
    del srv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    run = SimpleNamespace(cfg=cfg, mix=mix, setup_s=setup_s, spans=[],
                          k1=[], k4=[], profile=None, **vars(win))
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        run.spans, run.k1, run.k4 = tracer.spans, tracer.k1, tracer.k4
        if profile is not None and profile.prof is not None:
            host = [(s["phase"] + " (host issue, device idle)", s["start"],
                     s["end"]) for s in tracer.spans if s["profiled"]]
            host += [x for x in win.sleeps
                     if x[2] > profile.t_mark and x[1] < profile.t_stop]
            run.profile = trace.reduce(profile.device_events(),
                                       profile.t_mark, profile.t_stop, host)
            for kind, key in (("k1", "k1_s"), ("k4", "k4_s")):
                if not _match(getattr(run, kind), run.profile[key]):
                    log(f"trace: {kind} launches and kernels in the slice "
                        f"do not pair up; its roofline is left out")
            device_info.update(busy_s=run.profile["busy_s"],
                               window_s=run.profile["window_s"])
            breakdown = {"device_ops": run.profile["device_ops"],
                         "idle_gaps": run.profile["idle_gaps"]}
    metrics = {}
    for m in cell["metrics"]:
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    lim = cell["limits"]
    readings = check.gaps(w, cfg, *check.pick(
        finished, seed, lim["sample_tokens"], lim["first_requests"]), device)
    verdict = check.judge(readings, lim)
    log(f"read: {readings}")
    # a request still queued when a run that does not wait for it stops
    # (a cell offered more than the server completes) has not failed
    missing = sum(r["first_token_at"] is None for r in run.requests) \
        if cell["wait_share"] > 0 else 0
    result = {"correct": verdict["correct"], "attempted": len(run.requests),
              "failed": refused + missing, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict["checks"]
    return result


def loaded_forbidden() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def _json_safe(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _json_safe(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_json_safe(v) for v in x]
    return x


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = cell_of(load_spec(), args.workload, bool(args.trace))
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); this "
            f"machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start, log)
    return emit(result, _card(), log)


def emit(result: Dict, card: str, log) -> int:
    """Print the result line, and before it on standard error the card
    and each number checked beside its limit; refuse a run that loaded
    JAX or the JAX package."""
    bad = loaded_forbidden()
    if bad:
        log(f"the run loaded {bad}: the benchmark measures repro_torch only")
        return 3
    log(f"card: {card}")
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']} ({c['rule']} {c['limit']})")
    print(json.dumps(_json_safe(result)), flush=True)
    return 0
