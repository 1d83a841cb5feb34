"""ssd_scan — Mamba2 SSD chunked scan, the Hopper port of K4.

Port of ``repro/kernels/ssd_scan.py`` (``_ssd_kernel``, ``ssd_scan``).  The
kernel is ``csrc/ssd_scan.cu``: each thread block walks every chunk of one
(batch x head) row in order with its slice of the (N, P) f32 state resident
in shared memory — the TPU's sequential chunk grid axis becomes that loop —
and the grid splits P into :data:`BLOCK_P`-wide column blocks.  The chunk
length ``min(chunk, T)`` is passed at run time and the ragged last chunk is
masked in the kernel, so no padded copy of the inputs is made.  This wrapper
validates, allocates the output and launches on PyTorch's current stream;
it never synchronises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.launch import hw

DEFAULT_CHUNK = 128
#: columns of S and y one block owns (kBlockP in csrc/ssd_scan.cu)
BLOCK_P = 16

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.ssd_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(chunk: int = DEFAULT_CHUNK, d_state: int = 128) -> int:
    """Dynamic shared memory of one block at chunk length ``chunk`` and
    state width ``d_state`` (``ssd_scan_smem_bytes`` in the source): the
    state and x slices (N, BP) and (L, BP), b and c (L, N+1), the score
    block (L, L+1) and two (L,) vectors, all f32."""
    l, n = chunk, d_state
    return 4 * (n * BLOCK_P + l * BLOCK_P + 2 * l * (n + 1) + l * (l + 1)
                + 2 * l)


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """Batched SSD scan on the card: x (BH,T,P), log_a (BH,T) f32,
    b/c (BH,T,N) -> y (BH,T,P) in ``x.dtype``.  x and b/c are each f32 or
    bf16; the state, the prefix sum and every product are f32.

    Takes CUDA tensors only: the CPU path is :func:`repro_torch.kernels.
    ref.ssd_chunked`, chosen by :func:`repro_torch.kernels.ops.ssd`.
    """
    global launches
    tensors = (x, log_a, b, c)
    if not all(v.is_cuda and v.device == x.device for v in tensors):
        raise ValueError(f"ssd_scan needs every operand on one CUDA device, "
                         f"got {[str(v.device) for v in tensors]}")
    if x.dim() != 3 or log_a.shape != x.shape[:2] or b.dim() != 3 \
            or b.shape[:2] != x.shape[:2] or c.shape != b.shape:
        raise ValueError(f"ssd_scan needs x (BH,T,P), log_a (BH,T), b/c "
                         f"(BH,T,N), got {tuple(x.shape)}, "
                         f"{tuple(log_a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    if x.dtype not in DTYPE_CODES or b.dtype not in DTYPE_CODES \
            or c.dtype != b.dtype or log_a.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes f32/bf16 x, f32/bf16 b and c of "
                        f"one dtype and f32 log_a, got x {x.dtype}, log_a "
                        f"{log_a.dtype}, b {b.dtype}, c {c.dtype}")
    if not all(v.is_contiguous() for v in tensors):
        raise ValueError("ssd_scan needs contiguous operands")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    bh, t, p = x.shape
    n = b.shape[-1]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lc = min(chunk, t)
    if smem_bytes(lc, n) > hw.SMEM_PER_BLOCK:
        raise ValueError(f"chunk {lc} x d_state {n} needs "
                         f"{smem_bytes(lc, n)} B of shared memory, over the "
                         f"{hw.SMEM_PER_BLOCK} B a block may use")
    if max(bh, t, p, n) >= 2 ** 31:
        raise ValueError(f"shape {(bh, t, p, n)} exceeds the kernel's index "
                         f"range")
    rc = _lib().ssd_scan(
        x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
        out.data_ptr(), bh, t, p, n, lc, DTYPE_CODES[x.dtype],
        DTYPE_CODES[b.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {rc} at "
                           f"(bh,t,p,n,L)={(bh, t, p, n, lc)} x {x.dtype} "
                           f"b/c {b.dtype}")
    launches += 1
    return out
