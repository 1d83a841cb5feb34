"""flash_attention — online-softmax attention, the Hopper port of K3.

Port of ``repro/kernels/attention.py`` (``_attn_kernel``,
``flash_attention``).  The kernels are in ``csrc/flash_attention.cu``: grid
(ceil(Tq / block_q), BH); each thread block walks every KV tile its
``block_q`` query rows can see, in a loop, and stores once — the TPU's
``"arbitrary"`` KV grid axis becomes that loop.  Queries are end-aligned to
the keys; causal, sliding-window and KV-padding masks as in the reference.
Two kernels, chosen by dtype before the launch (both hand-written; neither
falls back to the other):

* bfloat16 — FlashAttention-2 on the tensor cores: ``mma.sync`` for
  Q K^T and P V, the softmax statistics in registers, K and V tiles
  double-buffered by ``cp.async``, P split into two bf16 halves so P V keeps
  ~16 bits of P.  :data:`MMA_BLOCKS`; a 16-row, one-warp block for Tq <= 16.
* float32 — the CUDA-core kernel (FP32 FMA: the reference's f32 tolerance
  of 2e-5 is beyond TF32 and bf16).  :data:`BLOCKS`.

This wrapper validates, allocates the output and launches on PyTorch's
current stream; it never synchronises.  Tiles are staged at a head width
DP, the smallest of :data:`HEAD_DIMS` at or above D (zeros past D).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.launch import hw

#: (block_q, block_k) of the f32 kernel, instantiated in
#: csrc/flash_attention.cu
BLOCKS = ((64, 64), (64, 32), (32, 32), (16, 16))
#: (block_q, block_k) of the bf16 tensor-core kernel, instantiated in
#: csrc/flash_attention.cu; block_q / 16 warps of 16 rows
MMA_BLOCKS = ((64, 64), (64, 32), (16, 64), (16, 32))
#: staged head widths instantiated in csrc/flash_attention.cu
HEAD_DIMS = (64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the wrapper adds one per launch,
#: of either kernel)
launches = 0

_LIB = None


def _lib() -> ctypes.CDLL:
    """The flash_attention library, its entry points' argtypes set, loaded
    once."""
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        lib.flash_attention.argtypes = [ctypes.c_void_p] * 4 \
            + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def padded_dim(d: int) -> int:
    """The staged head width DP for head dim ``d`` (``padded_dim`` in the
    source); raises for a head dim the kernel does not take."""
    for dp in HEAD_DIMS:
        if 1 <= d <= dp:
            return dp
    raise ValueError(f"head dim {d} is not supported (1..{HEAD_DIMS[-1]})")


def blocks_for(dtype: torch.dtype) -> Tuple[Tuple[int, int], ...]:
    """The (block_q, block_k) pairs compiled in for ``dtype``."""
    return MMA_BLOCKS if dtype == torch.bfloat16 else BLOCKS


def default_blocks(d: int, dtype: torch.dtype = torch.float32,
                   tq: Optional[int] = None) -> Tuple[int, int]:
    """(block_q, block_k) used when the caller names none.  f32: 64 x 64
    up to DP = 128; 64 x 32 at DP = 256, where 64 x 64 would take 210 KiB
    of shared memory and leave one block per SM.  bf16: block_q 16 (one
    warp) for Tq <= 16, else 64; block_k 64 up to DP = 128 and 32 at
    DP = 256, where the (16, DP) f32 accumulator of a warp already holds
    128 registers a thread."""
    wide = padded_dim(d) <= 128
    if dtype == torch.bfloat16:
        return (16 if tq is not None and tq <= 16 else 64, 64 if wide else 32)
    return (64, 64) if wide else (64, 32)


def smem_bytes(block_q: int, block_k: int, d: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one block (``flash_attention_smem_bytes``
    in the source).  f32: Q (block_q, DP+1), K and V (block_k, DP+1), the
    score block (block_q, block_k+1) and three (block_q,) statistics, all
    f32.  bf16: Q (block_q rows) and two buffers each of K and V (block_k
    rows), rows of DP + 8 bf16."""
    dp = padded_dim(d)
    if dtype == torch.bfloat16:
        return 2 * (block_q + 4 * block_k) * (dp + 8)
    ld = dp + 1
    return 4 * (block_q * ld + 2 * block_k * ld + block_q * (block_k + 1)
                + 3 * block_q)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None) -> torch.Tensor:
    """q (BH, Tq, D), k/v (BH, Tk, D) -> (BH, Tq, D) in q's dtype on the
    card; Tq is end-aligned to Tk, scale D^-0.5, f32 softmax statistics.

    Refuses ``causal`` with Tq > Tk: the first Tq - Tk rows then see no key,
    where the reference's answer is a NaN (plain version) or an average of
    v that depends on the block size (Pallas kernel).  Takes CUDA tensors
    only: the CPU path is :func:`repro_torch.kernels.ref.attention`, chosen
    by :func:`repro_torch.kernels.ops.attention`.
    """
    global launches
    tensors = (q, k, v)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention needs q (BH,Tq,D) and k/v "
                         f"(BH,Tk,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32/bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention needs contiguous operands")
    bh, tq, d = q.shape
    tk = k.shape[1]
    padded_dim(d)                   # raises for a head dim over 256
    if tk < 1:
        raise ValueError("flash_attention needs at least one key (Tk >= 1)")
    if causal and tq > tk:
        raise ValueError(f"causal attention with Tq {tq} > Tk {tk}: the "
                         f"first {tq - tk} query rows would see no key")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    dq, dk = default_blocks(d, q.dtype, tq)
    bq = dq if block_q is None else block_q
    bk = dk if block_k is None else block_k
    compiled = blocks_for(q.dtype)
    if (bq, bk) not in compiled:
        raise ValueError(f"block ({bq}, {bk}) is not compiled in for "
                         f"{q.dtype}; choose one of {compiled}")
    smem = smem_bytes(bq, bk, d, q.dtype)
    if smem > hw.SMEM_PER_BLOCK:
        raise ValueError(f"block ({bq}, {bk}) at head dim {d} needs {smem} B "
                         f"of shared memory, over the {hw.SMEM_PER_BLOCK} B "
                         f"a block may use")
    if bh > 65535 or max(tq, tk) * d >= 2 ** 31:
        raise ValueError(f"shape {(bh, tq, tk, d)} exceeds the kernel's "
                         f"index range")
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"flash_attention needs q, k, v on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, tq, tk,
        d, d ** -0.5, int(bool(causal)), int(window), DTYPE_CODES[q.dtype],
        bq, bk, torch._C._cuda_getCurrentRawStream(q.device.index))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc} "
                           f"at (bh,tq,tk,d)={(bh, tq, tk, d)} {q.dtype} "
                           f"block ({bq}, {bk})")
    launches += 1
    return out
