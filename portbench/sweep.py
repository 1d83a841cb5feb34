"""Find a cell's knee once: serve its mix at several offered rates.

    python3 portbench/sweep.py --workload <cell> --rates 2,3,4 \
        --seconds 30 --seed 1

One process, one set of weights; each rate gets a fresh ``Server``, its
warm-up and one window of the cell's schedule at that rate.  For each
rate it prints the requests due, how many got no first token by the
window's end, the median wait in the queue over the first and the last
third of the window, the tails and the delivered tokens/s.  The knee is
the highest rate at which the backlog does not grow over the window: the
last third's queue wait stays near the first third's and every request
due gets its first token in time.  Cells then run at 0.8 x the knee.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))

import torch  # noqa: E402

from portbench import arrivals, bench, port, stats  # noqa: E402
from portbench import weights as weights_mod  # noqa: E402

#: how long after the window each rate waits for the window's first tokens
WAIT_SHARE = 0.5


def thirds(requests, t0, seconds):
    """Median queue wait (s) of the requests due in each third."""
    out = []
    for k in range(3):
        lo, hi = t0 + k * seconds / 3, t0 + (k + 1) * seconds / 3
        w = [(r["admitted_at"] - r["due"]) if r["admitted_at"] else
             float("inf") for r in requests if lo <= r["due"] < hi]
        out.append(stats.percentile(w, 50))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    cell = bench.cell_of(bench.load_spec(), args.workload, False)
    cfg, mix = cell["cfg"], cell["mix"]
    a = port.arch(cfg)
    port.build_kernels(a)
    w = weights_mod.make(port.meta_params(a), args.seed, dev)
    mean_out = sum(x.max_new for x in arrivals.schedule(
        mix, 10.0, 100.0, args.seed, cfg["vocab_size"])) / 1000
    for rate in (float(r) for r in args.rates.split(",")):
        srv = port.server(a, w, mix, dev)
        bench.warm(srv, arrivals.warm_prompts(mix, args.seed,
                                              cfg["vocab_size"]))
        sched = arrivals.schedule(mix, rate, args.seconds, args.seed,
                                  cfg["vocab_size"])
        win = bench.serve_window(srv, sched, args.seconds, WAIT_SHARE)
        reqs = win.requests
        late = sum(r["first_token_at"] is None
                   or r["first_token_at"] > win.t_end for r in reqs)
        row = dict(rate=rate, due=len(reqs), no_first_token_by_end=late,
                   queue_wait_s_by_third=thirds(reqs, win.t0, args.seconds),
                   ttft_p50_s=stats.percentile(stats.ttft_s(reqs), 50),
                   ttft_p90_s=stats.percentile(stats.ttft_s(reqs), 90),
                   itl_p95_s=stats.percentile(
                       stats.itl_s(reqs, win.t_end), 95),
                   output_tok_s=stats.tokens_in(reqs, win.t0, win.t_end)
                   / args.seconds,
                   offered_tok_s=rate * mean_out)
        print(json.dumps(bench._json_safe(row)), flush=True)
        del srv
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
