"""ame_elementwise — fused mfadd / mfsub / mfmul (+ ReLU), the Hopper port
of K2.

Port of ``repro/kernels/elementwise.py`` (``_ew_kernel``,
``ame_elementwise``).  The kernel is ``csrc/ame_elementwise.cu``: one
launch, one pass of a grid that covers the contiguous operands, each thread
loading :data:`PASS`'s 16-byte vectors of a and of b (streaming cache
hints) before any arithmetic where all three pointers are aligned, and a
scalar tail in the same launch; the operation done once in f32 and rounded
once to the operand type, ReLU after the rounding.  The TPU's (256, 512)
tiles and pad-and-slice have no counterpart.  This wrapper validates,
allocates the output and launches on PyTorch's current stream; it never
synchronises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

KINDS = {"add": 0, "sub": 1, "mul": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: (threads a block, 16-byte vectors a thread) of the pass (kThreads, kVecs
#: in the source), chosen by tools/k4_block_sweep.py
PASS = (128, 1)

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0

_fn = None


def _kernel():
    """The C entry point with its argtypes set, looked up once."""
    global _fn
    if _fn is None:
        f = _build.load("ame_elementwise").ame_elementwise
        f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def ame_elementwise(a: torch.Tensor, b: torch.Tensor, *, kind: str = "add",
                    relu: bool = False) -> torch.Tensor:
    """``a + b``, ``a - b`` or ``a * b`` over a 2-D (m, c) pair of one shape
    and dtype (f32, bf16, f16) on the card, optionally ReLU'd on writeback;
    the output has ``a``'s shape and dtype.

    Takes CUDA tensors only: the CPU path is :func:`repro_torch.kernels.
    ref.elementwise`, chosen by :func:`repro_torch.kernels.ops.elementwise`.
    """
    global launches
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError(f"ame_elementwise needs two (m, c) operands of one "
                         f"shape, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPE_CODES:
        raise TypeError(f"ame_elementwise takes float32/bfloat16/float16 "
                        f"operands of one dtype, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ame_elementwise needs contiguous operands")
    if not (a.is_cuda and b.is_cuda) or a.device != b.device:
        raise ValueError(f"ame_elementwise needs both operands on one CUDA "
                         f"device, got {a.device} and {b.device}")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    rc = _kernel()(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                   DTYPE_CODES[a.dtype], KINDS[kind], int(bool(relu)),
                   torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ame_elementwise launch failed: cudaError {rc} "
                           f"at {tuple(a.shape)} {a.dtype} {kind} "
                           f"relu={relu}")
    launches += 1
    return out
