"""Peaks of one NVIDIA H100 SXM, frozen from ``repro_torch.launch.hw``.

NVIDIA's data sheet, dense rates without sparsity, at the full 700 W
power limit; every run prints the card's name and power limit beside
its numbers.
"""

PEAK_FLOPS_BF16 = 989e12     # bf16/fp16 tensor-core FLOP/s
PEAK_FLOPS_F32 = 67e12       # float32 FMA FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # device-memory bytes/s


def peak_flops(dtype_bytes: int) -> float:
    """The peak that a product of operands of this width can reach."""
    return PEAK_FLOPS_BF16 if dtype_bytes <= 2 else PEAK_FLOPS_F32
