#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device  — require CUDA; print the card's name and power limit; TF32 off.
2. build   — build every kernel under src/repro_torch/kernels/csrc with
             nvcc (one process per source, all at once); print the build
             seconds and the ptxas register / shared-memory lines.
3. kernels — hold K1 (ame_gemm) against its plain version at the main
             paths' shapes (qwen3-1.7b and mamba2-370m projections) and the
             ragged test shapes; time the kernel, the plain version and
             torch.matmul (the library yardstick, which the port never
             calls) with CUDA events beside the bound.
4. ssd     — hold K4 (ssd_scan) against its plain version at the reference
             test shapes (f32, bf16), the impulse test and the main path's
             shapes (BH 32, P 64, N 128, chunk 128, f32 x, bf16 b/c) at
             T = 37, 64, 300 (two chunk boundaries, padded third chunk) and
             2048; time kernel and plain version beside the bound.
5. serve   — full-width qwen3-1.7b (28 layers) and then full-width
             mamba2-370m (48 layers), f32 parameters and bf16 compute from
             a seeded generator, each serves seeded requests through
             ``Server(backend="kernel")`` with every kernel count set to 0
             just before and read just after: 196 K1 launches per qwen3
             forward; 96 K1 launches per mamba forward and 48 K4 launches
             per mamba prefill of more than one token.  One prompt's
             prefill logits are held against ``backend="torch"``; a warm
             decode step (and, for mamba, a 300-token prefill) is timed and
             profiled; a reduced model on the card is held against the same
             model on the CPU.
6. report  — one JSON line of every ported kernel, then the last line
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
#: K4's tolerance against its plain version, per x dtype (atol, rtol): the
#: reference's values (tests/test_kernels.py:104-105)
K4_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (0.08, 0.08)}
#: serve: the longest prompt's prefill logits under backend="kernel" vs
#: "torch" on the card, (atol, rtol).  With f32 compute only the order of
#: the sums differs, so a wrong kernel cannot hide there (logits of the
#: seeded models are O(1)).
SERVE_F32_LOGITS_TOL = (1e-3, 1e-3)
#: the same with bf16 compute, as served: sums in another order round a
#: bf16 activation one ulp (2^-8 relative) apart now and then, and the
#: layers carry that on, 48 layers of the seeded mamba2-370m further than
#: 28 of qwen3-1.7b; bf16 compute itself moves their logits 0.08 and 0.83
#: from f32 compute.  The bf16-vs-f32 distance is printed, not a limit.
SERVE_LOGITS_ATOL = {"qwen3-1.7b": 0.25, "mamba2-370m": 0.5}
#: small reduced model (f32) on the card vs the CPU: f32 sum-order only
SMALL_TOL = 1e-4
SLOTS, MAX_NEW, N_REQUESTS = 4, 16, 6
#: mamba2-370m serve: one of the six prompts is this long, so the scan
#: crosses two chunk boundaries of 128 and pads the third chunk on the card
LONG_PROMPT = 300
#: cache positions per slot: qwen3's KV cache; mamba's prompts must fit
#: under it too (its recurrent state does not grow)
CACHE_LEN = {"qwen3-1.7b": 128, "mamba2-370m": 512}


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


def k1_layer(cfg):
    """(name, k, n) of the K1 calls of one layer of ``cfg``."""
    d = cfg.d_model
    if cfg.family == "ssm":
        from repro_torch.models import ssm
        d_inner, _, _, d_proj = ssm.dims(cfg)
        return [("in_proj", d, d_proj), ("out_proj", d_inner, d)]
    hd = cfg.head_dim_
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    return [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
            ("wi", d, cfg.d_ff), ("wg", d, cfg.d_ff), ("mlp.wo", cfg.d_ff, d)]


def k1_shapes(cfg, m_values=(1, 4, 64)):
    """(name, m, k, n) of one layer's K1 calls, per M."""
    return [(nm, m, k, n) for m in m_values for nm, k, n in k1_layer(cfg)]


def phase_kernels(cfgs):
    """K1 against its plain version; returns per-shape records."""
    import torch
    from repro_torch.kernels import ame_gemm as k1
    from repro_torch.kernels import ref
    from repro_torch.launch import hw

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    l2_bytes = 50 * 2 ** 20
    cases = [(cfg.name, nm, m, k, n, torch.bfloat16) for cfg in cfgs
             for nm, m, k, n in k1_shapes(cfg)]
    cases += [("test", "ragged", m, k, n, dt)
              for m, k, n in ((100, 130, 70), (257, 33, 129))
              for dt in (torch.float32, torch.bfloat16)]
    records = []
    for model, nm, m, k, n, dt in cases:
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
        rec = dict(model=model, name=nm, m=m, k=k, n=n,
                   dtype=str(dt).removeprefix("torch."),
                   max_abs_err=err, atol=atol, rtol=rtol, ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=1e3 * max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        records.append(rec)
        log(f"[kernels] ame_gemm {model} {nm:8s} (m,k,n)=({m},{k},{n}) "
            f"{rec['dtype']}: max_abs_err={err:.3g} (atol {atol}, rtol "
            f"{rtol}) {'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")
    return records


def k4_bound(bh, t, p, n, chunk, x_bytes, bc_bytes):
    """(bound ms, "bytes" | "operations") of one ssd_scan call.  Bytes: x,
    log_a, b, c read once and y written once.  Operations: per row and
    chunk of l steps, the cheaper of two exact forms of the scan: the
    sequential recurrence, 5 N P f32 FLOPs a step (decay the state, add
    the outer product b x, read out c S); or the chunked form on the causal
    half of its score block, l(l+1) N for C B^T at the b/c dtype's peak
    plus l(l+1) P + 4 l N P f32 for G X, C S and B^T X."""
    from repro_torch.launch import hw
    lc = min(chunk, t)
    nbytes = bh * t * (2 * p * x_bytes + 4 + 2 * n * bc_bytes)
    bc_peak = hw.PEAK_FLOPS if bc_bytes == 2 else hw.PEAK_FLOPS_F32
    t_ops = 0.0
    for t0 in range(0, t, lc):
        l = min(lc, t - t0)
        recurrence = 5 * l * n * p / hw.PEAK_FLOPS_F32
        chunked = l * (l + 1) * n / bc_peak \
            + (l * (l + 1) * p + 4 * l * n * p) / hw.PEAK_FLOPS_F32
        t_ops += bh * min(recurrence, chunked)
    t_bytes = nbytes / hw.HBM_BW
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def phase_ssd(cfg):
    """K4 against its plain version; returns per-shape records."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as k4

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    s = cfg.ssm
    bh = s.expand * cfg.d_model // s.head_dim          # one sequence's heads
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("test", shape, dt, dt) for dt in (f32, bf16)
             for shape in ((2, 64, 16, 8, 16), (1, 100, 32, 16, 32),
                           (3, 33, 8, 4, 16), (1, 16, 8, 8, 16))]
    cases += [("impulse", (1, 64, 4, 4, 16), f32, f32)]
    cases += [("main", (bh, t, s.head_dim, s.d_state, s.chunk), f32, bf16)
              for t in (37, 64, LONG_PROMPT, 2048)]
    records = []
    for kind, (rows, t, p, n, chunk), xdt, bdt in cases:
        if kind == "impulse":
            x = torch.zeros(rows, t, p, device=dev)
            x[0, 0] = 1.0
            la = torch.full((rows, t), -0.01, device=dev)
            b = c = torch.ones(rows, t, n, device=dev)
        else:
            x = (torch.randn(rows, t, p, generator=gen, device=dev)
                 * 0.5).to(xdt)
            la = -(torch.randn(rows, t, generator=gen, device=dev)
                   * 0.2).abs()
            b = (torch.randn(rows, t, n, generator=gen, device=dev)
                 * 0.5).to(bdt)
            c = (torch.randn(rows, t, n, generator=gen, device=dev)
                 * 0.5).to(bdt)
        got = k4.ssd_scan(x, la, b, c, chunk=chunk)
        torch.cuda.synchronize()
        want = ref.ssd_chunked(x, la, b, c, chunk=chunk)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"K4 {kind} {(rows, t, p, n)}: shape/dtype "
                                 f"{got.shape} {got.dtype} vs {want.shape} "
                                 f"{want.dtype}")
        atol, rtol = K4_TOL[str(xdt).removeprefix("torch.")]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        ok = bool((diff <= atol + rtol * want.float().abs()).all())
        if kind == "impulse":
            ok = ok and float(got[0, -1].abs().max()) > 0.1
        iters = 10 if t >= 1024 else 20
        ms = timed_ms(lambda *a: k4.ssd_scan(*a, chunk=chunk),
                      [(x, la, b, c)], iters)
        plain_ms = timed_ms(lambda *a: ref.ssd_chunked(*a, chunk=chunk),
                            [(x, la, b, c)], iters)
        bound_ms, bound_by = k4_bound(rows, t, p, n, chunk,
                                      x.element_size(), b.element_size())
        rec = dict(kind=kind, bh=rows, t=t, p=p, n=n, chunk=chunk,
                   x_dtype=str(xdt).removeprefix("torch."),
                   bc_dtype=str(bdt).removeprefix("torch."),
                   max_abs_err=err, atol=atol, rtol=rtol, ok=ok, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        records.append(rec)
        log(f"[ssd] ssd_scan {kind:7s} (bh,t,p,n,chunk)={(rows, t, p, n, chunk)} "
            f"x {rec['x_dtype']} b/c {rec['bc_dtype']}: max_abs_err={err:.3g} "
            f"(atol {atol}, rtol {rtol}) {'ok' if ok else 'FAIL'} | kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by})")
    bad = [r for r in records if not r["ok"]]
    if bad:
        raise AssertionError(f"K4 disagrees with its plain version: {bad}")
    return records


def _prompts(cfg):
    """Six seeded prompts of 8-64 tokens; for mamba2-370m the last is
    LONG_PROMPT tokens, so the server runs the multi-chunk scan."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = []
    for u in range(N_REQUESTS):
        n = int(rng.integers(8, 65))
        if cfg.family == "ssm" and u == N_REQUESTS - 1:
            n = LONG_PROMPT
        prompts.append(rng.integers(0, cfg.vocab_size, n).astype(np.int32))
    return prompts


def phase_serve(cfg, dev):
    """Serve seeded requests at full width through the kernels; returns
    the serve summary with each kernel's launches on this path."""
    import torch
    from repro_torch.kernels import ame_gemm as k1
    from repro_torch.kernels import ssd_scan as k4
    from repro_torch.models import model as lm
    from repro_torch.serve.loop import Request, Server

    ssm = cfg.family == "ssm"
    cache_len = CACHE_LEN[cfg.name]
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    srv = Server(cfg, params, slots=SLOTS, cache_len=cache_len,
                 backend="kernel", device=dev)
    torch.cuda.synchronize()
    n_params = lm.param_count(params)
    log(f"[serve] {cfg.name}: {n_params:,} parameters ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, compute {cfg.policy.compute_dtype}) "
        f"ready in {time.perf_counter() - t0:.1f}s")
    prompts = _prompts(cfg)
    reqs = [Request(uid=u, prompt=p, max_new=MAX_NEW)
            for u, p in enumerate(prompts)]
    for r in reqs:
        srv.submit(r)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    k1.launches = k4.launches = 0                     # main path starts
    t0 = time.perf_counter()
    done = srv.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ame_gemm": k1.launches,              # main path ends
                "ssd_scan": k4.launches}
    tokens = sum(len(r.out_tokens) for r in done)
    forwards = srv.prefills + srv.decode_steps
    want = {"ame_gemm": len(k1_layer(cfg)) * cfg.n_layers * forwards,
            "ssd_scan": cfg.n_layers * sum(len(p) > 1 for p in prompts)
            if ssm else 0}
    log(f"[serve] {len(done)} requests, {tokens} tokens, {srv.prefills} "
        f"prefills (prompts {sorted(len(p) for p in prompts)}) + "
        f"{srv.decode_steps} decode steps in {wall:.3f}s wall "
        f"(synchronised), {tokens / wall:.1f} tok/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    for name, n in launches.items():
        log(f"[serve] {name} launches: {n} (expected {want[name]})")
    if len(done) != N_REQUESTS:
        raise AssertionError(f"{len(done)} of {N_REQUESTS} requests served")
    if launches != want or launches["ame_gemm"] == 0 \
            or (ssm and launches["ssd_scan"] == 0):
        raise AssertionError("the main path did not go through the kernels "
                             "once per projection / per layer's scan")
    for r in done:
        if not (1 <= len(r.out_tokens) <= MAX_NEW
                and all(0 <= t < cfg.vocab_size for t in r.out_tokens)):
            raise AssertionError(f"request {r.uid}: bad tokens {r.out_tokens}")

    # the longest prompt's prefill logits, kernel vs the plain torch
    # backend, in f32 compute (the tight check) and in bf16 as served
    prompt = max(prompts, key=len)
    toks = {"tokens": torch.as_tensor(prompt[None], dtype=torch.long,
                                      device=dev)}
    cfg32 = cfg.with_policy(compute_dtype="float32")
    logits = {}
    for compute, c, p in (("bf16", cfg, srv.params), ("f32", cfg32, params)):
        for be in ("kernel", "torch"):
            lg, _ = lm.prefill(p, toks, c, cache_len, backend=be)
            logits[compute, be] = lg[:, :cfg.vocab_size].float()
    if any(lg.shape != (1, cfg.vocab_size) or not torch.isfinite(lg).all()
           for lg in logits.values()):
        raise AssertionError("prefill logits are not finite (1, vocab)")
    atol, rtol = SERVE_F32_LOGITS_TOL
    lk, lt = logits["f32", "kernel"], logits["f32", "torch"]
    err32 = float((lk - lt).abs().max())
    ok32 = bool(((lk - lt).abs() <= atol + rtol * lt.abs()).all())
    lk, lt = logits["bf16", "kernel"], logits["bf16", "torch"]
    err = float((lk - lt).abs().max())
    tol = SERVE_LOGITS_ATOL[cfg.name]
    noise = float((lt - logits["f32", "torch"]).abs().max())
    log(f"[serve] {len(prompt)}-token prefill logits kernel vs torch: f32 "
        f"compute max_abs_err={err32:.4g} (atol {atol}, rtol {rtol}) "
        f"{'ok' if ok32 else 'FAIL'}; bf16 compute max_abs_err={err:.4g} "
        f"(atol {tol}) {'ok' if err <= tol else 'FAIL'}; logits max |x| "
        f"{float(lt.abs().max()):.3g}; argmax {int(lk.argmax())} vs "
        f"{int(lt.argmax())}; diagnostic: torch bf16 vs f32 compute "
        f"{noise:.4g}")
    if not ok32 or err > tol:
        raise AssertionError("kernel and torch backends disagree")
    phase_breakdown(cfg, srv.params, dev)
    if ssm:
        phase_prefill_breakdown(cfg, srv.params, dev, prompt)
    del params, srv
    torch.cuda.empty_cache()
    return dict(requests=len(done), tokens=tokens, wall_s=wall,
                params=n_params, launches=launches)


def _profile(fn):
    """Device ms by kernel name and the launch count of one call of
    ``fn`` under torch.profiler."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, n_launch = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
            n_launch += e.count
    return kernels, n_launch


def _event_ms(fn, steps):
    """(CUDA-event ms, host wall ms) per call, mean of ``steps``."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, \
        1e3 * (time.perf_counter() - t0) / steps


def _log_profile(tag, what, step_ms, host_ms, steps, kernels, n_launch):
    busy = sum(kernels.values())
    log(f"[{tag}] {what}: {step_ms:.2f} ms (CUDA events, mean of {steps}), "
        f"{host_ms:.2f} ms host wall")
    if busy <= 0:
        log(f"[{tag}] the profiler saw no device time: kernel shares not "
            f"measured")
        return
    shares = []
    for name, key in (("ame_gemm", "ame_gemm_kernel"),
                      ("ssd_scan", "ssd_scan_kernel")):
        ms = sum(v for k, v in kernels.items() if key in k)
        if ms:
            shares.append(f"{name} {ms:.2f} ms ({100 * ms / busy:.1f}% of "
                          f"busy)")
    log(f"[{tag}] profiled: device busy {busy:.2f} ms in {n_launch} kernel "
        f"launches ({host_ms * 1e3 / n_launch:.1f} us of host time each) of "
        f"{len(kernels)} names; {'; '.join(shares)}; idle share of the "
        f"event-timed call {100 * max(0.0, 1 - busy / step_ms):.1f}%")
    for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        log(f"[{tag}]   {v:8.3f} ms  {k[:100]}")


def phase_breakdown(cfg, params, dev, steps=5):
    """Where a warm decode step's time goes (M = SLOTS; KV length 64 for
    attention): CUDA-event time per step, then one profiled step's device
    time by kernel (the kernels' share, the device's idle share)."""
    import torch
    from repro_torch.models import model as lm

    caches = lm.make_caches(cfg, SLOTS, CACHE_LEN[cfg.name], dev)
    toks = torch.zeros((SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((SLOTS,), 64, dtype=torch.long, device=dev)

    def step():
        lm.decode_step(params, toks, pos, caches, cfg, backend="kernel")
    step_ms, host_ms = _event_ms(step, steps)
    kernels, n_launch = _profile(step)
    _log_profile("breakdown", f"{cfg.name} warm decode step, M={SLOTS}",
                 step_ms, host_ms, steps, kernels, n_launch)


def phase_prefill_breakdown(cfg, params, dev, prompt, steps=3):
    """One prefill of ``prompt`` timed and profiled (K4's share)."""
    import torch
    from repro_torch.models import model as lm

    toks = {"tokens": torch.as_tensor(prompt[None], dtype=torch.long,
                                      device=dev)}

    def prefill():
        lm.prefill(params, toks, cfg, CACHE_LEN[cfg.name], backend="kernel")
    step_ms, host_ms = _event_ms(prefill, steps)
    kernels, n_launch = _profile(prefill)
    _log_profile("breakdown", f"{cfg.name} {len(prompt)}-token prefill",
                 step_ms, host_ms, steps, kernels, n_launch)


def phase_small_reference(cfg_full, dev, prompt_t):
    """Reduced model (f32) on the card, kernel backend, against the same
    parameters on the CPU with the plain backend: prefill + 3 decodes."""
    import numpy as np
    import torch
    from repro_torch.models import model as lm

    cfg = cfg_full.reduced()
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = _to(cpu, dev)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (2, prompt_t))
    outs = {}
    for name, p, where, be in (("cpu", cpu, "cpu", "torch"),
                               ("card", card, dev, "kernel")):
        t = torch.as_tensor(toks, dtype=torch.long, device=where)
        lg, c = lm.prefill(p, {"tokens": t}, cfg, prompt_t + 8, backend=be)
        seq = [lg.cpu()]
        pos = torch.full((2,), prompt_t, dtype=torch.long, device=where)
        for _ in range(3):
            nxt = seq[-1].argmax(-1).to(where)[:, None]
            lg, c = lm.decode_step(p, nxt, pos, c, cfg, backend=be)
            seq.append(lg.cpu())
            pos = pos + 1
        outs[name] = torch.stack(seq)
    err = float((outs["card"] - outs["cpu"]).abs().max())
    log(f"[small] reduced {cfg.name} f32, {prompt_t}-token prompts: card "
        f"(kernel) vs CPU (plain) max_abs_err={err:.3g} (tol {SMALL_TOL})")
    if not torch.isfinite(outs["card"]).all() or err > SMALL_TOL:
        raise AssertionError("reduced model on the card disagrees with CPU")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def kernels_line(k1_records, k4_records, serves):
    """K1's entry: one qwen3 decode layer's seven calls at M = SLOTS,
    summed.  K4's entry: one layer's scan of the LONG_PROMPT-token prefill
    of the mamba serve.  ``launches``: both main paths' counts."""
    layer = [r for r in k1_records
             if r["model"] == "qwen3-1.7b" and r["m"] == SLOTS]
    total = {key: sum(r[key] for r in layer)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    main = [r for r in k4_records
            if r["kind"] == "main" and r["t"] == LONG_PROMPT][0]
    by_path = {name: {model: s["launches"][name]
                      for model, s in serves.items()}
               for name in ("ame_gemm", "ssd_scan")}
    return {"kernels": [{
        "name": "ame_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ame_gemm.cu",
        "replaces": "src/repro/kernels/ame_gemm.py:78",
        "launches": sum(by_path["ame_gemm"].values()),
        "launches_by_path": by_path["ame_gemm"],
        "max_abs_err": max(r["max_abs_err"] for r in k1_records),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in layer)
        else "operations",
        "library_ms": total["library_ms"],
        "work": f"one qwen3-1.7b decoder layer's 7 K1 calls at decode, "
                f"M={SLOTS}, bf16",
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:170",
        "launches": sum(by_path["ssd_scan"].values()),
        "launches_by_path": by_path["ssd_scan"],
        "max_abs_err": max(r["max_abs_err"] for r in k4_records),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "work": f"one mamba2-370m layer's scan of a {LONG_PROMPT}-token "
                f"prefill: (BH,T,P,N)=({main['bh']},{main['t']},"
                f"{main['p']},{main['n']}), chunk {main['chunk']}, f32 x, "
                f"bf16 b/c; no single PyTorch call computes it",
    }]}


def main() -> int:
    name, _ = phase_device()
    import torch
    from repro_torch.configs import get
    qwen, mamba = get("qwen3-1.7b"), get("mamba2-370m")
    phase_build()
    k1_records = phase_kernels([qwen, mamba])
    k4_records = phase_ssd(mamba)
    dev = torch.device("cuda", torch.cuda.current_device())
    serves = {}
    for cfg, small_prompt in ((qwen, 16), (mamba, 40)):
        serves[cfg.name] = phase_serve(cfg, dev)
        phase_small_reference(cfg, dev, small_prompt)
    print(json.dumps(kernels_line(k1_records, k4_records, serves)),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
