#!/usr/bin/env python3
"""How far K4's split-bf16 tensor-core products move its outputs, on the CPU.

    PYTHONPATH=src python tools/k4_precision.py

Emulates the mma variant of ssd_scan (csrc/ssd_scan.cu) chunk by chunk:
the f32 prefix sum, C B^T from bf16 b and c with f32 sums, the decay mask
on G, and the three f32-accurate products done as sums of bf16 products,
each f32 operand v split into bf16 planes.  Two designs:

* two planes (hi = bf16(v), lo = bf16(v - hi), 16 bits):
  G X = G_hi X_hi + G_hi X_lo + G_lo X_hi, C S = C S_hi + C S_lo,
  B^T (w X) = B^T (wX)_hi + B^T (wX)_lo;
* three planes (hi, mid = bf16(v - hi), lo = bf16(v - hi - mid), 24 bits),
  the kernel's: G X takes the six products down to 2^-16 of the leading
  term (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid), C S and B^T (w X)
  three each (C and B are bf16 and exact).

exp(cum_i) multiplies C S in f32 afterwards and the state S stays f32
across chunks (exp(cum_L) S + B^T (w X)).  Each product of bf16 values is
exact in f32; the emulation sums them in f32 (torch.matmul on the CPU).
Prints, per case, the worst error of each design and of the plain version
(ref.ssd_chunked, all f32) against the sequential recurrence in f64, as a
fraction of K4's tolerance atol + rtol |y| (chip_smoke.K4_TOL); the kernel's
design above 1 fails.  Cases: the reference's test shapes (f32 x, bf16 b/c,
and one in bf16 x) and the main path's (2, 300, 64, 128) and (2, 2048, 64,
128) with inputs drawn as the tests draw them (log_a = -|0.2 N(0,1)|), plus
the main shape at a slow decay (log_a = -0.01 |N(0,1)|), where the state
carries over many chunks and the sums are long.
"""
import sys

import torch

from repro_torch.kernels import ref

TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (0.08, 0.08)}
CHUNK_MAX = 128
#: (BH, T, P, N, chunk), x dtype, b/c dtype, log_a scale
CASES = [((2, 64, 16, 8, 16), torch.float32, torch.bfloat16, 0.2),
         ((1, 100, 32, 16, 32), torch.float32, torch.bfloat16, 0.2),
         ((3, 33, 8, 4, 16), torch.float32, torch.bfloat16, 0.2),
         ((1, 16, 8, 8, 16), torch.float32, torch.bfloat16, 0.2),
         ((2, 64, 16, 8, 16), torch.bfloat16, torch.bfloat16, 0.2),
         ((2, 300, 64, 128, 128), torch.float32, torch.bfloat16, 0.2),
         ((2, 2048, 64, 128, 128), torch.float32, torch.bfloat16, 0.2),
         ((2, 300, 64, 128, 128), torch.float32, torch.bfloat16, 0.01)]


def split(v, planes: int = 3):
    """The bf16 planes of an f32 tensor, as f32, leading plane first."""
    out = []
    for _ in range(planes):
        p = v.bfloat16().float()
        out.append(p)
        v = v - p
    return out


def recurrence64(x, log_a, b, c):
    """The sequential recurrence in f64: S_t = a_t S + b_t x_t^T, y = c S."""
    xd, ad, bd, cd = (v.double() for v in (x, log_a, b, c))
    bh, t, p = x.shape
    s = torch.zeros(bh, b.shape[-1], p, dtype=torch.float64)
    ys = []
    for i in range(t):
        s = torch.exp(ad[:, i])[:, None, None] * s \
            + bd[:, i, :, None] * xd[:, i, None, :]
        ys.append(torch.einsum("bn,bnp->bp", cd[:, i], s))
    return torch.stack(ys, 1)


def emulate(x, log_a, b, c, chunk, planes: int = 3):
    """The mma kernel's arithmetic with ``planes`` bf16 planes a product."""
    bh, t, p = x.shape
    n = b.shape[-1]
    lc = min(chunk, t, CHUNK_MAX)
    xf, bf, cf = x.float(), b.float(), c.float()
    s = torch.zeros(bh, n, p)
    out = torch.empty(bh, t, p)
    for t0 in range(0, t, lc):
        sl = slice(t0, min(t0 + lc, t))
        xc, bc, cc = xf[:, sl], bf[:, sl], cf[:, sl]
        cum = torch.cumsum(log_a[:, sl], -1)
        rows = cum.shape[-1]
        keep = torch.ones(rows, rows, dtype=torch.bool).tril()
        diff = cum[:, :, None] - cum[:, None, :]
        g = torch.where(keep, (cc @ bc.transpose(1, 2))
                        * torch.exp(torch.where(keep, diff, 0.0)), 0.0)
        gs, xs = split(g, planes), split(xc, planes)
        # the pairs of planes down to 2^-8 (planes - 1) of the leading one
        y = sum(gs[i] @ xs[j] for i in range(planes) for j in range(planes)
                if i + j < planes)
        cs = sum(cc @ sp for sp in split(s, planes))
        y = y + torch.exp(cum)[..., None] * cs
        out[:, sl] = y
        w = torch.exp(cum[:, -1:] - cum)
        fresh = sum(bc.transpose(1, 2) @ wp
                    for wp in split(w[..., None] * xc, planes))
        s = torch.exp(cum[:, -1])[:, None, None] * s + fresh
    return out.to(x.dtype)


def inputs(case, gen):
    """x, log_a, b, c of one case of CASES, drawn from ``gen``."""
    (bh, t, p, n, _), xdt, bdt, decay = case
    x = (torch.randn(bh, t, p, generator=gen) * 0.5).to(xdt)
    la = -(torch.randn(bh, t, generator=gen) * decay).abs()
    b, c = [(torch.randn(bh, t, n, generator=gen) * 0.5).to(bdt)
            for _ in range(2)]
    return x, la, b, c


def errors(case, gen):
    """{design: (max abs err, worst err / limit, outputs over the limit)}
    of one case against the f64 recurrence."""
    x, la, b, c = inputs(case, gen)
    chunk = case[0][4]
    want = recurrence64(x, la, b, c)
    atol, rtol = TOL[case[1]]
    limit = atol + rtol * want.abs()
    got = {"three planes": emulate(x, la, b, c, chunk, 3),
           "two planes": emulate(x, la, b, c, chunk, 2),
           "plain f32": ref.ssd_chunked(x, la, b, c, chunk=chunk)}
    out = {}
    for name, y in got.items():
        diff = (y.double() - want).abs()
        out[name] = (float(diff.max()), float((diff / limit).max()),
                     int((diff > limit).sum()))
    return out


def main() -> int:
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for case in CASES:
        (bh, t, p, n, chunk), xdt, bdt, decay = case
        for name, (err, frac, over) in errors(case, gen).items():
            if name == "three planes":
                worst = max(worst, frac)
            print(f"(BH,T,P,N,chunk)={(bh, t, p, n, chunk)} x "
                  f"{str(xdt)[6:]} b/c {str(bdt)[6:]} log_a scale {decay}: "
                  f"{name:12s} max abs err {err:.3g}, worst err / limit "
                  f"{frac:.3f}, {over} outputs over the limit", flush=True)
    print(f"three planes (the kernel): worst err / limit over all cases "
          f"{worst:.3f}")
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
