"""Serve a small model with batched requests: slot-based continuous
batching, prefill + batched decode, per-request latency stats.

Port of the reference's serve example, with its flags, plus ``--device``
(the card by default; ``--device cpu`` runs the kernels' plain versions).
The model is serve_lm's reduced qwen3-1.7b (4 layers, d_model 256) with
weights from a seeded generator; every projection goes through
``backend="kernel"``.

With ``--pim-offload`` the decode path is mirrored onto a resident-weight
PIM runtime: each step's matmuls are accounted on a 16-pseudo-channel
stack and the run ends with the steady-state PIM-vs-host roofline.  With
``--pim-numeric`` the sidecar also executes each step's matmul set on the
per-channel engines and checks every output against an FP32 reference.
With ``--profile out.json`` the offload runs in async timeline mode and
the run writes a Chrome-trace profile of the PIM schedule, prints the
critical-path attribution and the TTFT/TPOT percentiles.  Request
timestamps come from a deterministic virtual clock unless ``--wall``.
``--traffic RATE`` also replays a seeded Poisson trace through the
virtual-time ``TrafficServer`` and prints disaggregated-vs-colocated
goodput at an SLO.

  PYTHONPATH=src python -m repro_torch.serve [--requests 12] [--slots 4]
  PYTHONPATH=src python -m repro_torch.serve --device cpu --pim-offload
  PYTHONPATH=src python -m repro_torch.serve --traffic 50
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.launch.device import resolve_device
from repro_torch.models import model as lm
from repro_torch.serve.loop import Request, Server, TrafficServer
from repro_torch.serve.offload import DecodeOffload
from repro_torch.serve.traffic import SLO, HostCostModel, poisson_trace


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--pim-offload", action="store_true",
                    help="account decode matmuls on a resident-weight "
                         "PIM runtime and report the roofline")
    ap.add_argument("--pim-channels", type=int, default=16)
    ap.add_argument("--pim-numeric", action="store_true",
                    help="run the offloaded matmuls numerically on the "
                         "per-channel engines, checked against FP32")
    ap.add_argument("--profile", metavar="OUT_JSON", default=None,
                    help="write a Chrome-trace profile of the PIM decode "
                         "schedule here (implies --pim-offload in async "
                         "timeline mode) and report critical-path + "
                         "TTFT/TPOT latency metrics")
    ap.add_argument("--wall", action="store_true",
                    help="stamp request timestamps from time.perf_counter() "
                         "instead of the deterministic virtual clock")
    ap.add_argument("--traffic", type=float, metavar="RATE_RPS",
                    default=None,
                    help="also replay a seeded Poisson trace at RATE_RPS "
                         "through the virtual-time TrafficServer and "
                         "print disaggregated vs colocated goodput")
    ap.add_argument("--device", default="cuda",
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get("qwen3-1.7b").reduced().replace(n_layers=4, d_model=256,
                                              d_ff=512, vocab_size=1024)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    metrics = None
    if args.profile:
        from repro_torch.obs import MetricsRegistry
        metrics = MetricsRegistry()
    offload = DecodeOffload(cfg, channels=args.pim_channels,
                            numeric=args.pim_numeric,
                            async_mode=args.profile is not None,
                            metrics=metrics, device=dev) \
        if args.pim_offload or args.pim_numeric or args.profile else None
    srv = Server(cfg, params, slots=args.slots, cache_len=160,
                 pim_offload=offload, metrics=metrics, wall=args.wall,
                 backend="kernel", device=dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        plen = int(rng.integers(4, 32))
        srv.submit(Request(uid=uid,
                           prompt=rng.integers(0, 1023, plen).astype(np.int32),
                           max_new=args.max_new))
    done = srv.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    toks = sum(len(r.out_tokens) for r in done)
    lat = [r.finished_at - r.submitted_at for r in done]
    print(f"served {len(done)} requests / {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s on {dev}, slots={args.slots})")
    unit = "wall" if args.wall else "virtual"
    print(f"latency ({unit} seconds) p50={np.percentile(lat, 50):.4f}s "
          f"p99={np.percentile(lat, 99):.4f}s")
    if len(done) != args.requests:
        raise SystemExit(f"{len(done)} of {args.requests} requests served")
    if offload is not None:
        roof = offload.roofline()
        print(f"pim offload [{roof['channels']}ch, {roof['placement']}]: "
              f"{len(offload.steps)} decode steps, "
              f"weights={roof['weight_bytes']}B uploaded once "
              f"({roof['upload_bytes']}B sharded)")
        print(f"  steady state (full batch): "
              f"h2d={roof['steady_h2d_bytes']}B (activations only), "
              f"d2h={roof['steady_d2h_bytes']}B, "
              f"weight reuse={roof['steady_reuse_bytes']}B/step")
        if args.pim_numeric:
            err = max(s.numeric_max_err for s in offload.steps)
            lerr = max(s.logits_max_err for s in offload.steps)
            print(f"  numeric decode-on-PIM: every matmul executed on the "
                  f"engines and matched FP32 (max err={err:.1e}, "
                  f"lm_head logits err={lerr:.1e})")
        print(f"  roofline: pim={roof['steady_pim_s']:.2e}s vs "
              f"host={roof['steady_host_s']:.2e}s "
              f"({roof['steady_host_bound']}-bound host), "
              f"pim_vs_host={roof['steady_pim_vs_host']:.3f}")
        if roof["steady_reuse_bytes"] != offload.weight_bytes:
            raise SystemExit("the offload's steady state re-read weights "
                             "it should keep resident")
    if args.profile:
        from repro_torch.obs import export_chrome_trace, profile_report
        trace = export_chrome_trace(offload.rt, args.profile)
        rep = profile_report(offload.rt)
        print(f"profile: {len(trace['traceEvents'])} events -> "
              f"{args.profile} (open at https://ui.perfetto.dev)")
        print(rep.summary(top_k=5))
        lat_sum = srv.latency_summary()
        ttft, tpot = lat_sum["ttft_s"], lat_sum["tpot_s"]
        print(f"serve latency [{lat_sum['requests']} requests, "
              f"{lat_sum['tokens']} tokens]: "
              f"ttft p50={ttft['p50']:.3f}s p99={ttft['p99']:.3f}s | "
              f"tpot p50={tpot['p50']:.4f}s p99={tpot['p99']:.4f}s")
    if args.traffic:
        off = DecodeOffload(cfg, channels=args.pim_channels, device=dev)
        cost = HostCostModel(cfg)
        step_s = off.step(args.slots).pim_s
        slo = SLO(ttft_s=4 * cost.prefill_s(256), tpot_s=1.3 * step_s)
        tr = poisson_trace(args.traffic, 200, seed=7, prompt_len=256,
                           max_new=args.max_new)
        print(f"traffic: 200 Poisson arrivals @ {args.traffic:.1f} rps, "
              f"slo(ttft={slo.ttft_s:.4f}s tpot={slo.tpot_s:.5f}s)")
        for label, dis in (("disaggregated", True), ("colocated", False)):
            ts = TrafficServer(off, slots=args.slots, disaggregate=dis,
                               chunk_tokens=64, slo=slo)
            ts.run(tr)
            s = ts.latency_summary()
            print(f"  {label:13s}: goodput={s['goodput_rps']:8.2f} rps  "
                  f"attainment={s['slo_attainment']:.2f}  "
                  f"ttft_p99={s['ttft_s']['p99']:.4f}s  "
                  f"tpot_p99={s['tpot_s']['p99']:.5f}s")
    print("serve_lm OK")


if __name__ == "__main__":
    main()
