#!/usr/bin/env python3
"""How far rounding P to bf16 moves K3's bf16 outputs, on the CPU.

    PYTHONPATH=src python tools/k3_p_precision.py

Emulates the bf16 flash_attention kernel's online softmax (tiles of 64
keys, f32 scores, statistics and accumulator) three ways — P @ V with P in
f32 (the reference's arithmetic), with P rounded to bf16 (as FA2 and SDPA
do), and with P split into two bf16 halves (P_hi + P_lo, the kernel's
choice) — on the model shapes of chip_smoke.py at reduced BH, with the
same peaked inputs (q, k at 3^0.5 randn, v at randn, bf16).  Prints each
variant's worst error against repro_torch.kernels.ref.attention as a
fraction of the one-ulp limit 2e-3 + 8e-3 |x|; above 1 fails.
"""
import torch

from repro_torch.kernels import ref

LIMIT = (2e-3, 8e-3)
BLOCK_K = 64
#: (BH, Tq, Tk, D), causal, window: chip_smoke.K3_MODEL_CASES at reduced BH
CASES = [((2, 2048, 2048, 128), True, 0), ((8, 16, 1024, 128), True, 0),
         ((1, 4096, 4096, 128), True, 2048), ((2, 2048, 2048, 256), True, 0)]


def online(q, k, v, causal, window, p_mode):
    bh, tq, d = q.shape
    tk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, tq, 1), ref.NEG)
    l = torch.zeros(bh, tq, 1)
    acc = torch.zeros(bh, tq, d)
    qpos = torch.arange(tq)[:, None] + tk - tq
    for k0 in range(0, tk, BLOCK_K):
        kpos = torch.arange(k0, min(k0 + BLOCK_K, tk))[None, :]
        keep = torch.ones(tq, kpos.shape[1], dtype=torch.bool)
        if causal:
            keep &= kpos <= qpos
        if window:
            keep &= kpos > qpos - window
        s = (qf @ kf[:, k0:k0 + BLOCK_K].transpose(1, 2)) * d ** -0.5
        s = torch.where(keep, s, torch.tensor(ref.NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        vt = vf[:, k0:k0 + BLOCK_K]
        if p_mode == "bf16":
            pv = p.bfloat16().float() @ vt
        elif p_mode == "hi+lo":
            hi = p.bfloat16().float()
            pv = hi @ vt + (p - hi).bfloat16().float() @ vt
        else:
            pv = p @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def main():
    gen = torch.Generator().manual_seed(0)
    for (bh, tq, tk, d), causal, window in CASES:
        q, k = [(torch.randn(bh, t, d, generator=gen) * 3 ** 0.5).bfloat16()
                for t in (tq, tk)]
        v = torch.randn(bh, tk, d, generator=gen).bfloat16()
        want = ref.attention(q, k, v, causal=causal, window=window).float()
        limit = LIMIT[0] + LIMIT[1] * want.abs()
        for mode in ("f32", "bf16", "hi+lo"):
            diff = (online(q, k, v, causal, window, mode).float() - want).abs()
            print(f"(BH,Tq,Tk,D)={(bh, tq, tk, d)} window={window} P {mode:5s}: "
                  f"max abs err {float(diff.max()):.4g}, worst err / limit "
                  f"{float((diff / limit).max()):.3f}, "
                  f"{int((diff > limit).sum())} outputs over the limit",
                  flush=True)


if __name__ == "__main__":
    main()
