"""The readings that a cell's correctness limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 101-112 \
        --control 101-103 --seconds 25 \
        [--faults state_unchanged,token_altered,half_batch_left_out \
         --fault-seeds 104-106 --fault-seconds 15]

In one process, for each seed: weights from the seed, a fresh ``Server``,
the warm-up and a short window of the cell's own schedule at its own
rate and sizes, then the check's sample and its gaps, as a run reads
them.  For the ``--control`` seeds it also reads the control: the
reference in float8 put in the program's place, at the same positions of
the same prompts and served tokens.  For each of ``--faults``
(``faults.FAULTS``) and each ``--fault-seeds`` seed it serves a window
with that fault planted under ``Server.step`` and reads the same
numbers, judged against the cell's limits.  One JSON line per reading,
then for each number the largest program reading, the smallest control
one and the smallest of each fault.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

from portbench import arrivals, bench, check, faults, port  # noqa: E402
from portbench import weights as weights_mod  # noqa: E402

#: the numbers a limit can be set on
KEYS = ("mean_logit_gap", "widest_logit_gap",
        "first_token_mean_logit_gap", "first_token_widest_logit_gap")


def seeds(text: str):
    if "-" in text:
        lo, hi = (int(x) for x in text.split("-"))
        return list(range(lo, hi + 1))
    return [int(x) for x in text.split(",") if x]


def read(cell, a, seed: int, seconds: float, dev, control: bool = False,
         fault: str = "") -> dict:
    """One window of the cell at ``seed`` and the check's readings."""
    cfg, mix, lim = cell["cfg"], cell["mix"], cell["limits"]
    t = time.perf_counter()
    w = weights_mod.make(port.meta_params(a), seed, dev)
    srv = port.server(a, w, mix, dev)
    bench.warm(srv, arrivals.warm_prompts(mix, seed, cfg["vocab_size"]))
    sched = arrivals.schedule(mix, cell["rate"], seconds, seed,
                              cfg["vocab_size"])
    with port.planted(faults.FAULTS[fault]) if fault \
            else contextlib.nullcontext():
        bench.serve_window(srv, sched, seconds, cell["wait_share"])
    finished = list(srv.completed)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    r = check.gaps(w, cfg, *check.pick(finished, seed, lim["sample_tokens"],
                                       lim["first_requests"]),
                   dev, control=control)
    r.update(seed=seed, fault=fault or None, finished=len(finished),
             correct=check.judge(r, lim)["correct"],
             reference_s=time.perf_counter() - t_ref,
             seed_s=time.perf_counter() - t)
    print(json.dumps(bench._json_safe(r)), flush=True)
    del w
    gc.collect()
    torch.cuda.empty_cache()
    return r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--fault-seconds", type=float, default=15.0)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    cell = bench.cell_of(bench.load_spec(), args.workload, False)
    a = port.arch(cell["cfg"])
    port.build_kernels(a)
    control = set(seeds(args.control))
    runs = [read(cell, a, s, args.seconds, dev, control=s in control)
            for s in seeds(args.seeds)]
    for fault in [f for f in args.faults.split(",") if f]:
        runs += [read(cell, a, s, args.fault_seconds, dev, fault=fault)
                 for s in seeds(args.fault_seeds)]
    prog = [r for r in runs if not r["fault"]]
    for k in KEYS:
        row = dict(workload=args.workload, number=k,
                   program_max=max(r[k] for r in prog))
        ctrl = [r["control_" + k] for r in prog if "control_" + k in r]
        if ctrl:
            row["control_min"] = min(ctrl)
        for fault in {r["fault"] for r in runs if r["fault"]}:
            row[fault + "_min"] = min(r[k] for r in runs
                                      if r["fault"] == fault)
        print(json.dumps(bench._json_safe(row)), flush=True)


if __name__ == "__main__":
    main()
