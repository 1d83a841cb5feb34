"""ssd_scan — Mamba2 SSD chunked scan, the Hopper port of K4.

Port of ``repro/kernels/ssd_scan.py`` (``_ssd_kernel``, ``ssd_scan``).  The
kernels are in ``csrc/ssd_scan.cu``: each thread block walks every chunk of
one (batch x head) row in order with its slice of the (N, P) f32 state on
chip — the TPU's sequential chunk grid axis becomes that loop; no state goes
through device memory — and the grid splits P into column blocks.  Two
variants, chosen by :func:`variant` before the launch:

* ``"mma"`` — bf16 b and c, f32 or bf16 x, N a multiple of 16 up to
  :data:`MMA_MAX_N`, P a multiple of :data:`MMA_BLOCK_P`, rows on 16
  bytes: the score block, G X, C S and the state update on ``mma.sync``
  (f32 operands split into three bf16 planes, so every product is
  f32-accurate), the state in registers, chunks staged by a two-stage
  ``cp.async`` ring.
* ``"fma"`` — everything else (f32 b / c, the reference's narrow shapes):
  the CUDA-core kernel, 16 columns a block.

Neither variant falls back to the other or to the plain version: a failed
build or launch raises.  The operands are read through their strides (unit
stride on the last dim), so the model's (B, T, H, .) layout and a b / c
expanded over heads need no copy.  The chunk length ``min(chunk, T)`` is
passed at run time and the ragged last chunk is masked in the kernel, so no
padded copy is made.  This wrapper validates, allocates the output (in x's
layout) and launches on PyTorch's current stream; it never synchronises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.launch import hw

DEFAULT_CHUNK = 128
#: columns of S and y one block owns (kFmaBlockP, kMmaBlockP in
#: csrc/ssd_scan.cu), and the mma kernel's ring stages (kMmaStages)
FMA_BLOCK_P = 16
MMA_BLOCK_P = 16
MMA_STAGES = 2
#: the mma kernel's tile: chunks of up to this many rows (a longer chunk is
#: walked as chunks of this length, the same function) and state dims up to
#: this many (one 16-row block for each of its 8 warps)
MMA_MAX_CHUNK = 128
MMA_MAX_N = 128
VARIANT_CODES = {"fma": 0, "mma": 1}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset (the wrapper adds one per launch,
#: of either variant), and the same split by variant
launches = 0
launches_by_variant = {"mma": 0, "fma": 0}

#: the C arguments every entry point of the source starts with (pointers
#: to x, log_a, b, c, y; nb, nh, t, p, n, l, x_dtype, bc_dtype; strides)
C_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 \
    + [ctypes.POINTER(ctypes.c_longlong)]

_fns = {}


def _fn(name: str):
    """The C entry point ``name`` with its argtypes set, looked up once."""
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load("ssd_scan")
        f = lib.ssd_scan
        f.argtypes = C_ARGTYPES + [ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fns["ssd_scan"] = f
        f = lib.ssd_scan_smem_bytes
        f.argtypes = [ctypes.c_int] * 4
        f.restype = ctypes.c_int
        _fns["ssd_scan_smem_bytes"] = f
        fn = _fns[name]
    return fn


def _aligned(v: torch.Tensor) -> bool:
    """Every row of ``v`` starts on 16 bytes (pointer and the strides of
    every dim but the last)."""
    size = v.element_size()
    return v.data_ptr() % 16 == 0 and all(
        (s * size) % 16 == 0 or d == 1
        for s, d in zip(v.stride()[:-1], v.shape[:-1]))


def variant(x: torch.Tensor, b: torch.Tensor,
            c: Optional[torch.Tensor] = None) -> str:
    """``"mma"`` for bf16 b / c (``c`` defaults to ``b``), f32 or bf16 x,
    16 <= N <= :data:`MMA_MAX_N` with N % 16 == 0, P a multiple of
    :data:`MMA_BLOCK_P` and x, b, c rows on 16 bytes; else ``"fma"``.  Any
    T and any chunk length.  The output is allocated in x's layout (or
    contiguous), so its rows are aligned whenever x's are."""
    c = b if c is None else c
    n, p = b.shape[-1], x.shape[-1]
    if (b.dtype == c.dtype == torch.bfloat16 and x.dtype in DTYPE_CODES
            and n % 16 == 0 and 16 <= n <= MMA_MAX_N
            and p % MMA_BLOCK_P == 0
            and all(_aligned(v) for v in (x, b, c))):
        return "mma"
    return "fma"


_choose = variant


def smem_bytes(chunk: int = DEFAULT_CHUNK, d_state: int = 128, *,
               variant: str = "mma",
               x_dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one block at chunk length ``chunk`` and
    state width ``d_state`` (``ssd_scan_smem_bytes`` in the source).

    fma: the state and x slices (N, 16) and (L, 16), b and c (L, N+1), the
    score block (L, L+1) and two (L,) vectors, all f32.  mma:
    :data:`MMA_STAGES` ring buffers of x (L', BP) in x's dtype, b and c
    (L', N+8) bf16 and log_a (L'), each part rounded up to 16 bytes, plus
    three bf16 planes of X (L', BP+8) and of S (N, BP+8), cum (L') and
    L' / 32 partial y blocks (16, BP) f32, with L' = min(L, 128) rounded
    up to 16 and BP = :data:`MMA_BLOCK_P`."""
    l, n = chunk, d_state
    if variant == "fma":
        return 4 * (n * FMA_BLOCK_P + l * FMA_BLOCK_P + 2 * l * (n + 1)
                    + l * (l + 1) + 2 * l)
    if variant != "mma":
        raise ValueError(f"variant must be 'mma' or 'fma', got {variant!r}")
    bp, st = MMA_BLOCK_P, MMA_STAGES
    lp = -(-min(l, MMA_MAX_CHUNK) // 16) * 16
    xs = 4 if x_dtype == torch.float32 else 2

    def a16(v):
        return -(-v // 16) * 16
    stage = a16(lp * bp * xs) + 2 * a16(lp * (n + 8) * 2) + a16(lp * 4)
    return st * stage + 3 * (lp + n) * (bp + 8) * 2 + a16(lp * 4) \
        + lp // 32 * 16 * bp * 4


def _four(v: torch.Tensor, lead: int) -> tuple:
    """(batch, head, time) element strides of a (BH, T, .) or (B, H, T, .)
    operand (``lead`` leading dims); a 3-D operand is one batch."""
    s = v.stride()
    return (0,) + tuple(s[:2]) if lead == 1 else tuple(s[:3])


def check(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
          c: torch.Tensor, chunk: int) -> None:
    """Raise unless ``ssd_scan`` takes these operands (either variant)."""
    tensors = (x, log_a, b, c)
    if not all(v.is_cuda and v.device == x.device for v in tensors):
        raise ValueError(f"ssd_scan needs every operand on one CUDA device, "
                         f"got {[str(v.device) for v in tensors]}")
    lead = x.dim() - 2
    if lead not in (1, 2) or log_a.shape != x.shape[:-1] \
            or b.dim() != x.dim() or b.shape[:-1] != x.shape[:-1] \
            or c.shape != b.shape:
        raise ValueError(f"ssd_scan needs x (BH,T,P), log_a (BH,T), b/c "
                         f"(BH,T,N), or the same with (B,H) leading, got "
                         f"{tuple(x.shape)}, {tuple(log_a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if x.dtype not in DTYPE_CODES or b.dtype not in DTYPE_CODES \
            or c.dtype != b.dtype or log_a.dtype != torch.float32:
        raise TypeError(f"ssd_scan takes f32/bf16 x, f32/bf16 b and c of "
                        f"one dtype and f32 log_a, got x {x.dtype}, log_a "
                        f"{log_a.dtype}, b {b.dtype}, c {c.dtype}")
    if any(v.stride(-1) != 1 and v.shape[-1] > 1 for v in (x, b, c)):
        raise ValueError("ssd_scan needs a unit stride on the last dim of "
                         "x, b and c")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    *rows, t, p = x.shape
    if max(math.prod(rows), t, p, b.shape[-1]) >= 2 ** 31:
        raise ValueError(f"shape {tuple(x.shape)} x N {b.shape[-1]} exceeds "
                         f"the kernel's index range")


def c_args(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor, out: torch.Tensor, chunk: int) -> tuple:
    """The leading C arguments (:data:`C_ARGTYPES`) of a call on checked
    operands writing ``out``, at chunk length ``min(chunk, T)``."""
    lead = x.dim() - 2
    *rows, t, p = x.shape
    nb, nh = (1, rows[0]) if lead == 1 else rows
    strides = (ctypes.c_longlong * 15)(*(
        _four(x, lead) + _four(out, lead) + _four(log_a[..., None], lead)
        + _four(b, lead) + _four(c, lead)))
    return (x.data_ptr(), log_a.data_ptr(), b.data_ptr(), c.data_ptr(),
            out.data_ptr(), nb, nh, t, p, b.shape[-1], min(chunk, t),
            DTYPE_CODES[x.dtype], DTYPE_CODES[b.dtype], strides)


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = DEFAULT_CHUNK,
             variant: Optional[str] = None) -> torch.Tensor:
    """Batched SSD scan on the card: x (BH,T,P) or (B,H,T,P), log_a
    (BH,T) / (B,H,T) f32, b/c (BH,T,N) / (B,H,T,N) -> y in ``x.dtype`` and
    x's layout.  x and b/c are each f32 or bf16; the state, the prefix sum
    and every product are f32(-accurate).  Operands may be strided views
    with a unit stride on their last dim (b / c may be expanded over
    heads).

    ``variant`` defaults to :func:`variant`'s choice; naming ``"mma"``
    where that choice is ``"fma"`` raises.

    Takes CUDA tensors only: the CPU path is :func:`repro_torch.kernels.
    ref.ssd_chunked`, chosen by :func:`repro_torch.kernels.ops.ssd`.
    """
    global launches
    check(x, log_a, b, c, chunk)
    best = _choose(x, b, c)
    kind = variant or best
    if kind not in VARIANT_CODES:
        raise ValueError(f"variant must be 'mma' or 'fma', got {kind!r}")
    if kind == "mma" and best != "mma":
        raise ValueError("the mma variant needs bf16 b/c, N % 16 == 0 and "
                         f"N <= {MMA_MAX_N}, P % {MMA_BLOCK_P} == 0 and "
                         f"16-byte aligned rows; got x {x.dtype} "
                         f"{tuple(x.shape)} b/c {b.dtype} {tuple(b.shape)}")
    t, n = x.shape[-2], b.shape[-1]
    lc = min(chunk, t)
    need = smem_bytes(lc, n, variant=kind, x_dtype=x.dtype)
    if need > hw.SMEM_PER_BLOCK:
        raise ValueError(f"chunk {lc} x d_state {n} needs {need} B of "
                         f"shared memory ({kind}), over the "
                         f"{hw.SMEM_PER_BLOCK} B a block may use")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    rc = _fn("ssd_scan")(*c_args(x, log_a, b, c, out, chunk),
                         VARIANT_CODES[kind],
                         torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: cudaError {rc} at "
                           f"{tuple(x.shape)} N {n} chunk {lc} x {x.dtype} "
                           f"b/c {b.dtype} variant {kind}")
    launches += 1
    launches_by_variant[kind] += 1
    return out
