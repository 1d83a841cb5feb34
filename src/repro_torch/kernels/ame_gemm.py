"""ame_gemm — output-stationary GEMM, the Hopper port of K1.

Port of ``repro/kernels/ame_gemm.py`` (``_gemm_kernel``, ``ame_gemm``,
``vmem_bytes``).  The kernel is ``csrc/ame_gemm.cu``: each thread block owns
one output tile, walks all of K inside the block with the f32 accumulator
in registers, and stores once, cast to ``out_dtype`` — no split-K and no
partial sums in device memory.  This wrapper validates, allocates the
output and launches on PyTorch's current stream; it never synchronises.

Block sizes: the TPU's bm = bn = 128, bk = 512 (double-buffered in VMEM)
would need 512 KiB of shared memory, past the 227 KB a block may use.
Here the tile is held in shared memory once per K step and the defaults
are 64 x 64 x 32; :data:`BLOCKS` lists the configurations compiled in.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DEFAULT_BM = 64
DEFAULT_BN = 64
DEFAULT_BK = 32
#: (block_m, block_n, block_k) instantiated in csrc/ame_gemm.cu
BLOCKS = ((64, 64, 32), (32, 32, 32), (16, 16, 64))

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("ame_gemm")
    fn = lib.ame_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ame_gemm(a: torch.Tensor, b: torch.Tensor, *,
             block_m: int = DEFAULT_BM, block_n: int = DEFAULT_BN,
             block_k: int = DEFAULT_BK,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A(m,k) @ B(k,n) on the card, f32 accumulation resident for the
    whole K walk, cast once to ``out_dtype`` (default ``a.dtype``).

    Takes CUDA tensors only: the CPU path is :func:`repro_torch.kernels.
    ref.gemm`, chosen by :func:`repro_torch.kernels.ops.gemm`.
    """
    global launches
    out_dtype = out_dtype or a.dtype
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"ame_gemm needs both operands on one CUDA device, "
                         f"got {a.device} and {b.device}")
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
    if (block_m, block_n, block_k) not in BLOCKS:
        raise ValueError(f"block ({block_m}, {block_n}, {block_k}) is not "
                         f"compiled in; choose one of {BLOCKS}")
    m, k = a.shape
    n = b.shape[1]
    if max(m, n, k) >= 2 ** 31 or -(-m // block_m) > 65535:
        raise ValueError(f"shape {(m, k, n)} exceeds the kernel's index range")
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    rc = _lib().ame_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
        DTYPE_CODES[a.dtype], DTYPE_CODES[out_dtype],
        block_m, block_n, block_k,
        torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ame_gemm launch failed: cudaError {rc} at "
                           f"(m,k,n)={(m, k, n)} {a.dtype}->{out_dtype}")
    launches += 1
    return out


def smem_bytes(block_m: int = DEFAULT_BM, block_n: int = DEFAULT_BN,
               block_k: int = DEFAULT_BK, dtype_bytes: int = 2) -> int:
    """Shared-memory claim of one block: the A and B tiles of one K step
    (the f32 accumulator lives in registers)."""
    return (block_m * block_k + block_k * block_n) * dtype_bytes
