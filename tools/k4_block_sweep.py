#!/usr/bin/env python3
"""K4's mma configurations and K2's passes, on one card.

    python3 tools/k4_block_sweep.py

The configurations the port does not ship are built from
``tools/csrc/*_sweep.cu``, which include the kernels' own sources and
instantiate them at more template values, into libraries of their own; the
port's wrappers launch only the shipped one.  Each configuration is first
held against its plain version (K4 at chip_smoke.K4_TOL, K2 bit for bit
against ``torch.add``), then timed by device time (chip_smoke.device_ms:
calls replayed from a CUDA graph).

K4 (ssd_scan): at the main paths' shapes (chip_smoke.phase_ssd: mamba2-
370m's BH 32, P 64, N 128 and zamba2-2.7b's BH 80, P 64, N 64; chunk 128,
f32 x, bf16 b/c, T = 37, 64, 300, 2048) and at a batch of two and of four
300-token mamba2-370m sequences (BH 64, 128), every (column block, ring
stages) of ``ssd_scan_sweep.cu`` and the fma variant; the shipped
(``ssd_scan.MMA_BLOCK_P``, ``MMA_STAGES``) is marked ``*``.

K2 (ame_elementwise): at chip_smoke.K2_MODEL_CASES, the add at every
(threads, 16-byte vectors a thread) of ``ame_elementwise_sweep.cu``, with
the operands cycled past the L2 (chip_smoke._rotation), beside
``torch.add`` timed before and after them; the shipped
``elementwise.PASS`` is marked ``*``.
"""
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402

SWEEP_CSRC = Path(__file__).resolve().parent / "csrc"
#: (column block, ring stages) of SSD_SWEEP_CONFIGS in ssd_scan_sweep.cu
K4_CONFIGS = ((16, 2), (32, 1), (64, 1))
#: (threads, vectors a thread) of EW_SWEEP_CONFIGS in
#: ame_elementwise_sweep.cu
K2_CONFIGS = tuple((t, v) for t in (128, 256, 512) for v in (1, 2, 4))


def _sweep_fn(lib_name: str, fn_name: str, argtypes):
    from repro_torch.kernels import _build
    fn = getattr(_build.load(lib_name, SWEEP_CSRC), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def sweep_k4(dev) -> None:
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as k4
    fn = _sweep_fn("ssd_scan_sweep", "ssd_scan_sweep",
                   k4.C_ARGTYPES + [ctypes.c_int] * 2 + [ctypes.c_void_p])

    def mma_at(cfg, chunk):
        def call(x, la, b, c):
            k4.check(x, la, b, c, chunk)
            out = torch.empty_like(x)
            rc = fn(*k4.c_args(x, la, b, c, out, chunk), *cfg,
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"ssd_scan_sweep {cfg}: cudaError {rc}")
            return out
        return call

    atol, rtol = chip_smoke.K4_TOL["float32"]
    gen = torch.Generator(device=dev).manual_seed(2)
    shapes = []
    for name in ("mamba2-370m", "zamba2-2.7b"):
        cfg = get(name)
        s = cfg.ssm
        bh = s.expand * cfg.d_model // s.head_dim      # one sequence's heads
        shapes += [(s, bh, t) for t in (37, 64, chip_smoke.LONG_PROMPT,
                                        2048)]
    s = get("mamba2-370m").ssm
    shapes += [(s, 64, chip_smoke.LONG_PROMPT),
               (s, 128, chip_smoke.LONG_PROMPT)]
    shipped = (k4.MMA_BLOCK_P, k4.MMA_STAGES)
    for s, bh, t in shapes:
        x = torch.randn(bh, t, s.head_dim, generator=gen, device=dev) * 0.5
        la = -(torch.randn(bh, t, generator=gen, device=dev) * 0.2).abs()
        b, c = [(torch.randn(bh, t, s.d_state, generator=gen, device=dev)
                 * 0.5).bfloat16() for _ in range(2)]
        want = ref.ssd_chunked(x, la, b, c, chunk=s.chunk)
        iters = 10 if t >= 1024 else 20
        times = {}
        for cfg in K4_CONFIGS + ("fma",):
            call = (lambda *a: k4.ssd_scan(*a, chunk=s.chunk, variant="fma")) \
                if cfg == "fma" else mma_at(cfg, s.chunk)
            got = call(x, la, b, c)
            torch.cuda.synchronize()
            if not bool(((got - want).abs()
                         <= atol + rtol * want.abs()).all()):
                raise AssertionError(f"ssd_scan {cfg} at ({bh}, {t}) "
                                     f"disagrees with its plain version")
            times[cfg] = chip_smoke.device_ms(call, [(x, la, b, c)], iters)
        print(f"[sweep] ssd_scan (bh,t,p,n)=({bh},{t},{s.head_dim},"
              f"{s.d_state}) device ms: " + ", ".join(
                  f"{cfg}{'*' if cfg == shipped else ''} "
                  f"{ms:.4f}" for cfg, ms in times.items()), flush=True)


def sweep_k2(dev) -> None:
    import torch
    from repro_torch.kernels import elementwise as k2
    fn = _sweep_fn("ame_elementwise_sweep", "ame_elementwise_sweep",
                   [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])

    def add_at(cfg):
        def call(a, b):
            out = torch.empty_like(a)
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                    k2.DTYPE_CODES[a.dtype], *cfg,
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"ame_elementwise_sweep {cfg}: "
                                   f"cudaError {rc}")
            return out
        return call

    gen = torch.Generator(device=dev).manual_seed(3)
    dtypes = {"float16": torch.float16, "bfloat16": torch.bfloat16}
    for (m, c), dt in chip_smoke.K2_MODEL_CASES:
        dt = dtypes[dt]
        nbytes = 3 * m * c * torch.finfo(dt).bits // 8
        args = [tuple(torch.randn(m, c, generator=gen, device=dev).to(dt)
                      for _ in range(2))
                for _ in range(chip_smoke._rotation(nbytes))]
        lib = [chip_smoke.device_ms(torch.add, args, 20)]
        times = {}
        for cfg in K2_CONFIGS:
            call = add_at(cfg)
            same, _ = chip_smoke._bits_equal(call(*args[0]),
                                             torch.add(*args[0]))
            if not same:
                raise AssertionError(f"ame_elementwise {cfg} at {(m, c)} "
                                     f"{dt} is not torch.add bit for bit")
            times[cfg] = chip_smoke.device_ms(call, args, 20)
        lib.append(chip_smoke.device_ms(torch.add, args, 20))
        print(f"[sweep] ame_elementwise add {(m, c)} {dt}: torch.add "
              f"{lib[0]:.4f} / {lib[1]:.4f} ms; (threads, vecs) device ms: "
              + ", ".join(f"{cfg}{'*' if cfg == k2.PASS else ''} {ms:.4f}"
                          for cfg, ms in times.items()), flush=True)
        best = min(times, key=times.get)
        print(f"[sweep] ame_elementwise add {(m, c)} {dt}: fastest {best} "
              f"{times[best]:.4f} ms, shipped {times[k2.PASS]:.4f} ms, "
              f"torch.add {lib[0]:.4f} / {lib[1]:.4f} ms", flush=True)


def main() -> int:
    import torch
    chip_smoke.phase_device()
    dev = torch.device("cuda")
    sweep_k4(dev)
    sweep_k2(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
