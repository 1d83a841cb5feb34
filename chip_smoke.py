#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device  — require CUDA; print the card's name and power limit; TF32 off.
2. build   — build every kernel under src/repro_torch/kernels/csrc with
             nvcc (one process per source, all at once); print the build
             seconds and the ptxas register / shared-memory lines.
3. kernels — hold K1 (ame_gemm) against its plain version at the main
             path's shapes and the ragged test shapes; time the kernel,
             the plain version and torch.matmul (the library yardstick,
             which the port never calls) with CUDA events beside the bound.
4. serve   — full-width qwen3-1.7b (28 layers, f32 parameters, bf16
             compute) from a seeded generator serves a few requests through
             ``Server(backend="kernel")``; K1 must launch 196 times per
             forward.  One prompt's logits are held against
             ``backend="torch"``; one warm decode step is timed and
             profiled (device busy time, K1's share, idle share); a
             reduced model on the card is held against the same model on
             the CPU.
5. report  — one JSON line of every ported kernel, then the last line
             ``{"ok": true, "device": {...}}``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: K1's tolerance against its plain version, per output dtype: the same
#: values as tests/test_kernels.py (f32 runs FP32 FMA, never TF32, so only
#: the order of the sums differs; bf16 outputs may round one ulp apart)
K1_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (0.06, 0.06)}
#: serve: prefill logits under backend="kernel" vs "torch", bf16 compute.
#: Both accumulate in f32, but sums in another order round a bf16
#: activation one ulp (2^-8 relative) apart now and then, and 28 layers
#: carry that on; logits of the seeded model are O(1)
SERVE_LOGITS_ATOL = 0.25
#: small reduced model (f32) on the card vs the CPU: f32 sum-order only
SMALL_TOL = 1e-4
SLOTS, CACHE_LEN, MAX_NEW, N_REQUESTS = 4, 128, 16, 6


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, args_list, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls (after warm-up),
    cycling through ``args_list`` so the weights come from device memory
    and not from L2, as on the main path."""
    import torch
    for args in args_list[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script measures the card and has no CPU path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device 0: {name} (count {torch.cuda.device_count()})")
    log("[device] nvidia-smi name, power.limit:")
    log(smi)
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} kernel source(s) in "
        f"{time.perf_counter() - t0:.1f}s wall")
    for name in libs:
        info = _build.BUILD_INFO[name]
        log(f"[build] {name}: nvcc {info['seconds']:.1f}s")
        for line in info["ptxas"]:
            log(f"[build]   {line}")


def k1_shapes(cfg, m_values=(1, 4, 64)):
    """(name, m, k, n) of the seven K1 calls of one layer, per M."""
    d, hd = cfg.d_model, cfg.head_dim_
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    per_layer = [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
                 ("wi", d, cfg.d_ff), ("wg", d, cfg.d_ff),
                 ("mlp.wo", cfg.d_ff, d)]
    return [(nm, m, k, n) for m in m_values for nm, k, n in per_layer]


def phase_kernels(cfg):
    """K1 against its plain version; returns per-shape records."""
    import torch
    from repro_torch.kernels import ame_gemm as k1
    from repro_torch.kernels import ref
    from repro_torch.launch import hw

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    l2_bytes = 50 * 2 ** 20
    cases = [(nm, m, k, n, torch.bfloat16) for nm, m, k, n in k1_shapes(cfg)]
    cases += [("ragged", m, k, n, dt) for m, k, n in ((100, 130, 70),
                                                      (257, 33, 129))
              for dt in (torch.float32, torch.bfloat16)]
    records = []
    for nm, m, k, n, dt in cases:
        esz = torch.finfo(dt).bits // 8
        copies = max(1, min(16, -(-4 * l2_bytes // ((m * k + k * n) * esz))))
        args = [((torch.randn(m, k, generator=gen, device=dev) * 0.3).to(dt),
                 (torch.randn(k, n, generator=gen, device=dev) * 0.3).to(dt))
                for _ in range(copies)]
        a, b = args[0]
        got = k1.ame_gemm(a, b)
        torch.cuda.synchronize()
        want = ref.gemm(a, b)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"K1 {nm} {(m, k, n)}: {got.shape} "
                                 f"{got.dtype} vs {want.shape} {want.dtype}")
        atol, rtol = K1_TOL[str(dt).removeprefix("torch.")]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        iters = 20
        ms = timed_ms(k1.ame_gemm, args, iters)
        plain_ms = timed_ms(ref.gemm, args, iters)
        lib_ms = timed_ms(torch.matmul, args, iters)
        nbytes = (m * k + k * n) * esz + m * n * esz
        peak = hw.PEAK_FLOPS if dt == torch.bfloat16 else hw.PEAK_FLOPS_F32
        t_bytes, t_ops = nbytes / hw.HBM_BW, 2 * m * n * k / peak
        rec = dict(name=nm, m=m, k=k, n=n, dtype=str(dt).removeprefix("torch."),
                   max_abs_err=err, atol=atol, rtol=rtol, ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        records.append(rec)
        log(f"[kernels] ame_gemm {nm:7s} (m,k,n)=({m},{k},{n}) "
            f"{rec['dtype']}: max_abs_err={err:.3g} (atol {atol}, rtol "
            f"{rtol}) {'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")
    return records


def phase_serve(cfg, dev):
    """Serve seeded requests at full width; returns the serve summary."""
    import numpy as np
    import torch
    from repro_torch.kernels import ame_gemm as k1
    from repro_torch.models import model as lm
    from repro_torch.serve.loop import Request, Server

    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    srv = Server(cfg, params, slots=SLOTS, cache_len=CACHE_LEN,
                 backend="kernel", device=dev)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {lm.param_count(params):,} parameters "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, compute "
        f"{cfg.policy.compute_dtype}) ready in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size,
                                               int(rng.integers(8, 65))
                                               ).astype(np.int32),
                    max_new=MAX_NEW) for u in range(N_REQUESTS)]
    for r in reqs:
        srv.submit(r)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    k1.launches = 0                                   # main path starts
    t0 = time.perf_counter()
    done = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.launches                            # main path ends
    tokens = sum(len(r.out_tokens) for r in done)
    forwards = srv.prefills + srv.decode_steps
    per_forward = 7 * cfg.n_layers
    log(f"[serve] {len(done)} requests, {tokens} tokens, {srv.prefills} "
        f"prefills + {srv.decode_steps} decode steps in {wall:.3f}s wall "
        f"(synchronised), {tokens / wall:.1f} tok/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"[serve] ame_gemm launches: {launches} (expected {per_forward} x "
        f"{forwards} forwards = {per_forward * forwards})")
    if len(done) != N_REQUESTS:
        raise AssertionError(f"{len(done)} of {N_REQUESTS} requests served")
    if launches != per_forward * forwards or launches == 0:
        raise AssertionError("the main path did not go through ame_gemm once "
                             "per dense projection")
    for r in done:
        if not (1 <= len(r.out_tokens) <= MAX_NEW
                and all(0 <= t < cfg.vocab_size for t in r.out_tokens)):
            raise AssertionError(f"request {r.uid}: bad tokens {r.out_tokens}")

    # one request's prefill logits: kernel vs the plain torch backend
    toks = {"tokens": torch.as_tensor(reqs[0].prompt[None], dtype=torch.long,
                                      device=dev)}
    lk, _ = lm.prefill(srv.params, toks, cfg, CACHE_LEN, backend="kernel")
    lt, _ = lm.prefill(srv.params, toks, cfg, CACHE_LEN, backend="torch")
    valid = slice(0, cfg.vocab_size)
    lk, lt = lk[:, valid], lt[:, valid]
    if lk.shape != (1, cfg.vocab_size) or not torch.isfinite(lk).all():
        raise AssertionError("prefill logits are not finite (1, vocab)")
    err = float((lk - lt).abs().max())
    log(f"[serve] prefill logits kernel vs torch: max_abs_err={err:.4g} "
        f"(atol {SERVE_LOGITS_ATOL}; logits max |x| "
        f"{float(lt.abs().max()):.3g}); argmax {int(lk.argmax())} vs "
        f"{int(lt.argmax())}")
    if err > SERVE_LOGITS_ATOL:
        raise AssertionError("kernel and torch backends disagree")
    phase_breakdown(cfg, srv.params, dev)
    del params, srv
    torch.cuda.empty_cache()
    return dict(requests=len(done), tokens=tokens, wall_s=wall,
                launches=launches)


def phase_breakdown(cfg, params, dev, steps=5):
    """Where a warm decode step's time goes (M = SLOTS, KV length 64):
    CUDA-event time per step, then one profiled step's device time by
    kernel (K1's share, the device's idle share)."""
    import torch
    from repro_torch.models import model as lm

    caches = lm.make_caches(cfg, SLOTS, CACHE_LEN, dev)
    toks = torch.zeros((SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((SLOTS,), 64, dtype=torch.long, device=dev)

    def step():
        lm.decode_step(params, toks, pos, caches, cfg, backend="kernel")
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        step()
    end.record()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps
    step_ms = start.elapsed_time(end) / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    kernels, n_launch = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
            n_launch += e.count
    busy = sum(kernels.values())
    log(f"[breakdown] warm decode step, M={SLOTS}: {step_ms:.2f} ms "
        f"(CUDA events, mean of {steps}), {host_ms:.2f} ms host wall")
    if busy <= 0:
        log("[breakdown] the profiler saw no device time: kernel shares "
            "not measured")
        return
    k1_ms = sum(v for k, v in kernels.items() if "ame_gemm_kernel" in k)
    log(f"[breakdown] profiled step: device busy {busy:.2f} ms in "
        f"{n_launch} kernel launches ({host_ms * 1e3 / n_launch:.1f} us of "
        f"host time each) of {len(kernels)} names; ame_gemm {k1_ms:.2f} ms "
        f"({100 * k1_ms / busy:.1f}% of busy); idle share of the event-"
        f"timed step {100 * max(0.0, 1 - busy / step_ms):.1f}%")
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[breakdown]   {v:8.3f} ms  {k[:100]}")


def phase_small_reference(cfg_full, dev):
    """Reduced qwen3 (f32) on the card, kernel backend, against the same
    parameters on the CPU with the plain backend: prefill + 3 decodes."""
    import numpy as np
    import torch
    from repro_torch.models import model as lm

    cfg = cfg_full.reduced()
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = _to(cpu, dev)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16))
    outs = {}
    for name, p, dev, be in (("cpu", cpu, "cpu", "torch"),
                             ("card", card, dev, "kernel")):
        t = torch.as_tensor(toks, dtype=torch.long, device=dev)
        lg, c = lm.prefill(p, {"tokens": t}, cfg, 24, backend=be)
        seq = [lg.cpu()]
        pos = torch.full((2,), 16, dtype=torch.long, device=dev)
        for _ in range(3):
            nxt = seq[-1].argmax(-1).to(dev)[:, None]
            lg, c = lm.decode_step(p, nxt, pos, c, cfg, backend=be)
            seq.append(lg.cpu())
            pos = pos + 1
        outs[name] = torch.stack(seq)
    err = float((outs["card"] - outs["cpu"]).abs().max())
    log(f"[small] reduced {cfg.name} f32: card (kernel) vs CPU (plain) "
        f"max_abs_err={err:.3g} (tol {SMALL_TOL})")
    if not torch.isfinite(outs["card"]).all() or err > SMALL_TOL:
        raise AssertionError("reduced model on the card disagrees with CPU")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def kernels_line(records, launches):
    """K1's entry: one decode layer's seven calls at M = SLOTS, summed."""
    layer = [r for r in records if r["m"] == SLOTS and r["name"] != "ragged"]
    total = {key: sum(r[key] for r in layer)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"kernels": [{
        "name": "ame_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ame_gemm.cu",
        "replaces": "src/repro/kernels/ame_gemm.py:78",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in layer)
        else "operations",
        "library_ms": total["library_ms"],
        "work": f"one decoder layer's 7 K1 calls at decode, M={SLOTS}, bf16",
    }]}


def main() -> int:
    name, _ = phase_device()
    import torch
    from repro_torch.configs import get
    cfg = get("qwen3-1.7b")
    phase_build()
    records = phase_kernels(cfg)
    dev = torch.device("cuda", torch.cuda.current_device())
    serve = phase_serve(cfg, dev)
    phase_small_reference(cfg, dev)
    print(json.dumps(kernels_line(records, serve["launches"])), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
