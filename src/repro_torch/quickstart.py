"""Quickstart: the paper's AME-on-PIM engine in five minutes, on the card.

Port of the reference's ``examples/quickstart.py``, in its three parts,
with its inputs and its printed lines:

1. Run AME instructions (mfadd/mfsub/mfmacc) on the functional Aquabolt-XL
   model and read the calibrated cycle costs (paper Figs 7-9).
2. Run an end-to-end GEMM entirely "in PIM mode" through the device
   runtime and compare against the reduction-free kernel K1 (``ame_gemm``,
   the hand-written CUDA kernel on the card, its plain version on the
   CPU).
3. Scale the same op across HBM pseudo-channels (the paper's future work)
   and dump an HBM-PIMulator-compatible command trace.

Cycles, FLOP/cycle and GFLOP/s are modeled Aquabolt-XL numbers: they do
not depend on the machine, and every line but the kernel's is the same on
the card and on the CPU.  The kernel line names what ran: K1's variant and
blocks on the card (f32 operands take the ``fma`` variant), the plain
version on the CPU.

  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

``--device`` defaults to the card and raises where there is none.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import AMEEngine, UnsupportedOnPIM, max_tile_mfmacc
from repro_torch.kernels import ame_gemm as k1
from repro_torch.kernels import ops, ref
from repro_torch.launch.device import resolve_device
from repro_torch.runtime import PIMRuntime, emit_trace, parse_trace, pim_gemm

#: K1 against its plain version in f32, (atol, rtol): the reference's f32
#: tolerance (tests/test_kernels.py); K1 runs FP32 FMA, never TF32, so
#: only the order of the sums differs
K1_TOL = (2e-5, 2e-5)


def _f16(rng, shape, scale, dev) -> torch.Tensor:
    """The next seeded normal draw times ``scale``, cast to float16 (as
    numpy casts, from float64) and moved to ``dev``."""
    x = (rng.standard_normal(shape) * scale).astype(np.float16)
    return torch.from_numpy(x).to(dev)


def _kernel_line(A: torch.Tensor, B: torch.Tensor) -> str:
    """K1 on A @ B in f32 (the kernel on a CUDA tensor, the plain version
    on a CPU one) against ``ref.gemm``: the printed line; raises past
    :data:`K1_TOL`."""
    a32, b32 = A.float(), B.float()
    got = ops.gemm(a32, b32, use_kernel=True)
    want = ref.gemm(a32, b32)
    err = float((got - want).abs().max())
    atol, rtol = K1_TOL
    if not bool(((got - want).abs() <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"K1 differs from ref.gemm by {err:.3g} "
                             f"(atol {atol}, rtol {rtol})")
    if a32.is_cuda:
        var = k1.variant(a32, b32)
        bm, bn, bk = k1.default_blocks(a32.shape[0], b32.shape[1], var)
        what = f"hand-written CUDA kernel K1, {var} {bm}x{bn}x{bk}"
    else:
        what = "plain version, CPU"
    return f"ame_gemm ({what}): max err {err:.2e}"


def main(device=None) -> int:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    # --- 1. AME instructions on the PIM engine ------------------------------
    eng = AMEEngine(device=dev)
    a = _f16(rng, (128, 64), 0.3, dev)
    b = _f16(rng, (128, 64), 0.3, dev)
    eng.msettilem(128), eng.msettilek(64)
    eng.mld(0, a)
    eng.mld(1, b)
    rep = eng.mfadd(0, 0, 1)
    print(f"mfadd.h.mm 128x64: {rep.cycles:.0f} cycles "
          f"({rep.flop_per_cycle:.1f} FLOP/cycle)")
    rep = eng.mfsub(0, 0, 1)           # emulated: MUL by -1 + ADD (SUB-PEP)
    print(f"mfsub.h.mm 128x64: {rep.cycles:.0f} cycles "
          f"(emulated, {rep.flop_per_cycle:.1f} FLOP/cycle)")
    try:
        eng.mfmax(0, 0, 1)
    except UnsupportedOnPIM as e:
        print(f"mfmax.h.mm: correctly unsupported -> {e}")

    # matrix multiply via the reduction-free outer-product dataflow
    eng2 = AMEEngine(device=dev)
    w = _f16(rng, (64, 32), 0.3, dev)
    eng2.msettilem(128), eng2.msettilek(64), eng2.msettilen(32)
    eng2.mld(0, a)
    eng2.mld(1, w)
    rep = eng2.mfmacc(0, 0, 1)
    out = eng2.mst(0).cpu().numpy()
    ref_out = a.cpu().numpy().astype(np.float32) \
        @ w.cpu().numpy().astype(np.float32)
    print(f"mfmacc.h 128x64x32: {rep.cycles:.0f} cycles, "
          f"max err vs fp32 {np.abs(out - ref_out).max():.3f}")

    head = max_tile_mfmacc()
    print(f"\npaper headline (128x4096 tiles): {head.flop_per_cycle:.1f} "
          f"FLOP/cycle, {head.gflops:.1f} GFLOP/s, "
          f"{head.launches} MAC-PEP launches  [paper: 59.4 / 14.9 / 256]")

    # --- 2. end-to-end GEMM in PIM mode + the kernel K1 ---------------------
    A = _f16(rng, (256, 192), 0.2, dev)
    B = _f16(rng, (192, 96), 0.2, dev)
    C_pim, rep1 = pim_gemm(A, B, device=dev)   # 1 pseudo-channel
    print(f"\npim_gemm 256x192x96: {rep1.makespan_cycles:.0f} modeled "
          f"cycles, {rep1.flop_per_cycle:.1f} FLOP/cycle at makespan")
    print(_kernel_line(A, B))

    # --- 3. the device runtime: multi-pseudo-channel scaling + traces -------
    C_2ch, rep2 = pim_gemm(A, B, channels=2, device=dev)   # output partitioning
    if not torch.equal(C_pim.view(torch.int16), C_2ch.view(torch.int16)):
        raise AssertionError("multi-channel execution differs from "
                             "single-channel")
    print(f"\n2 pseudo-channels: {rep2.summary()}")
    print(f"speedup vs 1ch: "
          f"{rep1.makespan_cycles / rep2.makespan_cycles:.2f}x (makespan)")

    # analytic mode sweeps paper-scale shapes without running numerics
    big = np.zeros((512, 4096), np.float16), np.zeros((4096, 512), np.float16)
    _, rep16 = pim_gemm(*big, channels=16, placement="2d-block",
                        execute=False, device=dev)
    print(f"16ch 512x4096x512 (analytic): {rep16.gflops:.0f} GFLOP/s, "
          f"util_min={min(rep16.utilizations()):.2f}")

    # every execution can be dumped as an HBM-PIMulator-style trace
    rt = PIMRuntime(channels=2, device=dev)
    rt.gemm(A[:32, :24], B[:24, :16])
    stats = parse_trace(emit_trace(rt.stack))
    print(f"command trace: {stats.pim_commands} PIM column commands, "
          f"{stats.launches} PEP launches, opcodes={dict(stats.opcodes)}")
    print("\nquickstart OK")
    return 0


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="where the engines and K1 run (default: the card)")
    return main(ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(_cli())
