"""Target-hardware constants (one NVIDIA H100 SXM) for roofline terms.

Published data-sheet peaks of the SXM part, dense (no sparsity), at its
full 700 W power limit.  A card set below that limit runs slower under
load, so every measured time in this repository names the card and its
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them.
"""

PEAK_FLOPS = 989e12          # bf16/fp16 tensor-core FLOP/s, dense
PEAK_FLOPS_F32 = 67e12       # float32 FMA FLOP/s outside the tensor cores
HBM_BW = 3.35e12             # device-memory bytes/s
SMEM_PER_BLOCK = 232_448     # shared memory one block may use (227 KB)
