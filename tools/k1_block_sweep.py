#!/usr/bin/env python3
"""K1's mma variant at every compiled block, on one card.

    python3 tools/k1_block_sweep.py

For each (m, k, n) of one qwen3-1.7b layer, one mamba2-370m layer and
one zamba2-2.7b mamba layer and shared block at m = 1, 4, 64 and, for the
last two, 300 (chip_smoke.k1_shapes), times ``ame_gemm`` in bf16
at each block of ``ame_gemm.MMA_BLOCKS`` by device time (chip_smoke.
device_ms: calls replayed from a CUDA graph, operands cycled past L2) and
marks the block ``default_blocks`` picks with ``*``.  Then sums each
layer's calls twice, at the default blocks and at each call's fastest
block, to show how far the default choice is from the best compiled one.
The ring depths and warp grids of ``MMA_CONFIG`` are compile-time values
and are not swept here.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels import ame_gemm as k1
    chip_smoke.phase_device()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    layers = {}
    for cfg in (get("qwen3-1.7b"), get("mamba2-370m"), get("zamba2-2.7b")):
        for nm, m, k, n in chip_smoke.k1_shapes(cfg):
            copies = max(1, min(16, -(-4 * 50 * 2 ** 20
                                     // ((m * k + k * n) * 2))))
            args = [(torch.randn(m, k, generator=gen, device=dev).bfloat16(),
                     torch.randn(k, n, generator=gen, device=dev).bfloat16())
                    for _ in range(copies)]
            pick = k1.default_blocks(m, n)
            times = {}
            for blk in k1.MMA_BLOCKS:
                def call(a, b, blk=blk):
                    return k1.ame_gemm(a, b, block_m=blk[0], block_n=blk[1],
                                       block_k=blk[2])
                times[blk] = chip_smoke.device_ms(call, args, 20)
            part = nm.partition(":")[0] if ":" in nm else "layer"
            layer = layers.setdefault((cfg.name, part, m),
                                      dict(default=0.0, best=0.0))
            layer["default"] += times[pick]
            layer["best"] += min(times.values())
            print(f"[sweep] {cfg.name} {nm:15s} (m,k,n)=({m},{k},{n}) device "
                  f"ms: " + ", ".join(f"{blk}{'*' if blk == pick else ''} "
                                      f"{ms:.4f}" for blk, ms in
                                      times.items()), flush=True)
    for (model, part, m), layer in layers.items():
        print(f"[sweep] {model} {part} m={m}: default blocks "
              f"{layer['default']:.4f} ms, fastest block per call "
              f"{layer['best']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
