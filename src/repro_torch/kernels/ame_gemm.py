"""ame_gemm — output-stationary GEMM, the Hopper port of K1.

Port of ``repro/kernels/ame_gemm.py`` (``_gemm_kernel``, ``ame_gemm``,
``vmem_bytes``).  The kernels are in ``csrc/ame_gemm.cu``; each thread block
owns its output tile for the whole K walk, keeps the f32 accumulator in
registers and stores once, cast to ``out_dtype`` — no split-K across blocks
and no partial sums in device memory.  Two variants, chosen by
:func:`variant` before the launch from dtype, shape and alignment:

* ``"mma"`` — bf16/f16 operands whose rows start on 16 bytes (n and k
  multiples of 8, both pointers 16-byte aligned): ``mma.sync`` on the
  tensor cores, B streamed through a 4-6 stage ``cp.async`` ring, narrow N
  tiles so every serving shape fills the card, the 4 warps of a block
  splitting K and summing their partial tiles once in shared memory.
  :data:`MMA_BLOCKS` lists its tiles; :func:`default_blocks` picks one from
  (m, n) when the caller names none.
* ``"fma"`` — f32 operands (FP32 FMA, never TF32) and every shape the mma
  variant cannot copy in 16-byte pieces: the general CUDA-core kernel,
  :data:`BLOCKS`.

Neither variant falls back to the other or to the plain version: a
failed build or launch raises.  This wrapper validates, allocates the
output and launches on PyTorch's current stream; it never synchronises.

Block sizes: the TPU's bm = bn = 128, bk = 512 (double-buffered in VMEM)
would need 512 KiB of shared memory, past the 227 KB a block may use.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.launch import hw
from repro_torch.obs import spans

#: (block_m, block_n, block_k) of the fma kernel, instantiated in
#: csrc/ame_gemm.cu
BLOCKS = ((64, 64, 32), (32, 32, 32), (16, 16, 64))
DEFAULT_BM, DEFAULT_BN, DEFAULT_BK = BLOCKS[0]
#: (block_m, block_n, block_k) of the mma kernel -> (ring stages, warp
#: rows WM, warp columns WN), as instantiated in csrc/ame_gemm.cu
#: (AME_MMA_BLOCKS); the 4 warps split K WK = 4 / (WM WN) ways.  16-row
#: decode tiles, 64-row tiles for prompts up to 64 tokens, 128-row beyond.
MMA_CONFIG = {(16, 8, 256): (6, 1, 1), (16, 16, 256): (4, 1, 1),
              (64, 16, 128): (4, 2, 2), (64, 64, 64): (4, 2, 2),
              (128, 32, 64): (4, 4, 1), (128, 64, 64): (3, 2, 2)}
MMA_BLOCKS = tuple(MMA_CONFIG)
#: an N tile is taken only if the grid still has this many blocks
MIN_TILES = hw.SMS // 2
#: warps of an mma block
MMA_WARPS = 4

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MMA_DTYPES = (torch.bfloat16, torch.float16)

#: kernel launches since the last reset (the wrapper adds one per launch,
#: of either variant)
launches = 0
#: the same launches by variant
launches_by_variant = {"mma": 0, "fma": 0}

#: C arguments of ``ame_gemm`` and ``ame_gemm_mma`` (pointers to a, b, c;
#: m, n, k, in and out dtype codes, block_m, block_n, block_k; stream) and
#: of ``ame_gemm_mma_smem_bytes`` (block_m, block_n, block_k)
C_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
SMEM_ARGTYPES = [ctypes.c_int] * 3


def variant(a: torch.Tensor, b: torch.Tensor) -> str:
    """``"mma"`` for bf16/f16 operands whose every row starts on 16 bytes
    (k and n multiples of 8, 16-byte aligned pointers), else ``"fma"``."""
    return _variant(a.dtype, *b.shape, a.data_ptr(), b.data_ptr())


def _variant(dtype, k: int, n: int, pa: int, pb: int) -> str:
    if dtype in MMA_DTYPES and not (k % 8 or n % 8 or pa % 16 or pb % 16):
        return "mma"
    return "fma"


def default_blocks(m: int, n: int, kind: str = "mma") -> Tuple[int, int, int]:
    """The block used when the caller names none.  fma: 64 x 64 x 32.
    mma: 16 rows up to m = 16, 64 up to 64, else 128; then the widest N
    tile that still leaves :data:`MIN_TILES` blocks, or the narrowest where
    none does.  (On an H100 a wider tile reads B in longer rows and its A
    fewer times; below about one block for every second SM the lost
    parallelism costs more.)"""
    if kind == "fma":
        return BLOCKS[0]
    bm = 16 if m <= 16 else 64 if m <= 64 else 128
    tiles = [blk for blk in MMA_BLOCKS if blk[0] == bm]
    m_tiles = -(-m // bm)
    for blk in sorted(tiles, key=lambda b: -b[1]):
        if m_tiles * -(-n // blk[1]) >= MIN_TILES:
            return blk
    return min(tiles, key=lambda b: b[1])


def ame_gemm(a: torch.Tensor, b: torch.Tensor, *,
             block_m: Optional[int] = None, block_n: Optional[int] = None,
             block_k: Optional[int] = None,
             out_dtype: Optional[torch.dtype] = None,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C = A(m,k) @ B(k,n) on the card, f32 accumulation resident for the
    whole K walk, cast once to ``out_dtype`` (default ``a.dtype``).  Name
    all three block sizes or none; a named block must be compiled in for
    the variant the operands take.  ``out``, a contiguous (m, n) tensor
    of ``out_dtype`` on A's device, takes C in place of a new tensor.

    Takes CUDA tensors only: the CPU path is :func:`repro_torch.kernels.
    ref.gemm`, chosen by :func:`repro_torch.kernels.ops.gemm`.  Under a
    span recorder (:mod:`repro_torch.obs.spans`) each launch appends a
    K1 record to the open span.
    """
    global launches
    out_dtype = out_dtype or a.dtype
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"ame_gemm needs (m,k) @ (k,n), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPE_CODES \
            or out_dtype not in DTYPE_CODES:
        raise TypeError(f"ame_gemm takes float32/bfloat16/float16 operands "
                        f"of one dtype, got {a.dtype}, {b.dtype} -> "
                        f"{out_dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ame_gemm needs row-major contiguous operands")
    m, k = a.shape
    n = b.shape[1]
    pa, pb = a.data_ptr(), b.data_ptr()
    kind = _variant(a.dtype, k, n, pa, pb)
    blocks = (block_m, block_n, block_k)
    if blocks == (None, None, None):
        blocks = default_blocks(m, n, kind)
    elif blocks not in (MMA_BLOCKS if kind == "mma" else BLOCKS):
        raise ValueError(f"block {blocks} is not compiled in for the "
                         f"{kind} variant; choose one of "
                         f"{MMA_BLOCKS if kind == 'mma' else BLOCKS}")
    if max(m, n, k) >= 2 ** 31 or -(-m // blocks[0]) > 65535:
        raise ValueError(f"shape {(m, k, n)} exceeds the kernel's index range")
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"ame_gemm needs both operands on one CUDA device, "
                         f"got {a.device} and {b.device}")
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    elif tuple(out.shape) != (m, n) or out.dtype != out_dtype \
            or out.device != a.device or not out.is_contiguous():
        raise ValueError(f"ame_gemm out must be a contiguous {(m, n)} "
                         f"{out_dtype} tensor on {a.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    if m == 0 or n == 0:
        return out
    fn = _build.entry("ame_gemm", "ame_gemm_mma" if kind == "mma"
                      else "ame_gemm", C_ARGTYPES)
    rc = fn(pa, pb, out.data_ptr(), m, n, k,
            DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype], *blocks,
            torch._C._cuda_getCurrentRawStream(a.device.index))
    if rc:
        raise _build.launch_error(rc, f"ame_gemm {kind}",
                                  f"(m,k,n)={(m, k, n)} {a.dtype}->"
                                  f"{out_dtype} block {blocks}")
    launches += 1
    launches_by_variant[kind] += 1
    spans.record_launch("k1", m, k, n, a.element_size(), out.element_size())
    return out


def smem_bytes(block_m: int = DEFAULT_BM, block_n: int = DEFAULT_BN,
               block_k: int = DEFAULT_BK, dtype_bytes: int = 2,
               kind: str = "fma") -> int:
    """Shared-memory claim of one block (``ame_gemm_mma_smem_bytes`` in the
    source for mma).  fma: the A and B tiles of one K step, static.  mma,
    dynamic: the ring of stages, each A as block_m rows of block_k + 8
    (padded) and B as block_k x block_n, 2-byte elements — or the WK
    partial f32 tiles summed after the walk, if larger."""
    if kind == "fma":
        return (block_m * block_k + block_k * block_n) * dtype_bytes
    stages, wm, wn = MMA_CONFIG[(block_m, block_n, block_k)]
    ring = stages * (block_m * (block_k + 8) + block_k * block_n) * 2
    return max(ring, MMA_WARPS // (wm * wn) * block_m * block_n * 4)
