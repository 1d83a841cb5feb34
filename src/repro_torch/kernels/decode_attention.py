"""decode_attention — one query position per slot over its KV cache, read
in place, in one launch (``csrc/decode_attention.cu``).

Replaces no Pallas kernel: the reference's decode attention is plain jnp
(``repro/models/attention.py:97-99``).  The port's plain version is the
decode call of :func:`repro_torch.models.attention.chunked_attention`,

    chunked_attention(q, k, v, causal=True, q_offset=qpos,
                      kv_positions=kpos)

which copies every 1,024-position chunk of the bf16 cache to f32 and takes
about 64 launches a layer.  The kernel computes the same function in f32
(only the order of the sums differs), reads only each slot's live keys,
``min(qpos + 1, clen)`` of them, and covers every query head of a GQA
group from one read of the group's K and V.  ``models/attention.py``
routes a window-free decode of CUDA tensors here, the sharded step with
each rank's local shards where the KV heads divide the model axis; a
rolling cache, a cache sharded on head_dim and a CPU tensor keep
``chunked_attention``.

The grid is sized from ``clen`` and the SM count (:func:`splits`), never
from the positions on the device, so the wrapper never synchronises.  A
slot's key range is split over several blocks when the grid would
otherwise leave the card idle; the last of a slot's blocks merges the
splits in the same launch, counting arrivals in a per-device buffer of
zeros that the kernel leaves zeroed (so launches that share it run on one
stream, one after another, as the serve path's do).  This wrapper
validates, allocates the output and the splits' workspace and launches on
PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.launch import hw
from repro_torch.obs import spans

#: head dims instantiated in csrc/decode_attention.cu
HEAD_DIMS = (32, 64, 80, 128, 256)
#: query heads a block covers (G), instantiated; a group of g heads takes
#: the smallest G >= g, or chunks of 8 beyond 8
GROUPS = (1, 2, 4, 8)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the most key splits of one (slot, KV head, head chunk) (kMaxSplits)
MAX_SPLITS = 64
#: a split takes at least this many keys
MIN_SPLIT = 64
#: the grid aims at this many blocks an SM with every slot full (at the
#: chat cell's step, 16 read 0.0275 ms on an H100, 8 0.0319 and 32 0.0299)
BLOCKS_PER_SM = 16
#: C arguments of ``decode_attention`` (pointers to q, k, v, kv_positions,
#: q_positions; q_positions is int64; pointers to out, the workspace, the
#: arrival counts; b, h, hkv, d, clen, G, split_len, nsplit; scale; dtype
#: code; stream)
C_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
    + [ctypes.c_int] * 8 + [ctypes.c_float] + [ctypes.c_int] \
    + [ctypes.c_void_p]

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0


def group_block(g: int) -> int:
    """G, the query heads one block covers, for a group of ``g`` heads."""
    return next((G for G in GROUPS if G >= g), GROUPS[-1])


def splits(b: int, blocks: int, clen: int) -> Tuple[int, int]:
    """``(split_len, nsplit)`` for ``b`` slots of ``blocks`` (KV head, head
    chunk) pairs over a cache of ``clen`` positions: enough splits for
    :data:`BLOCKS_PER_SM` blocks an SM when every slot is full, none
    shorter than :data:`MIN_SPLIT` keys, at most :data:`MAX_SPLITS`."""
    want = -(-hw.SMS * BLOCKS_PER_SM // (b * blocks))
    n = max(1, min(want, MAX_SPLITS, -(-clen // MIN_SPLIT)))
    split_len = -(-clen // n)
    return split_len, -(-clen // split_len)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_positions: torch.Tensor,
                     q_positions: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, 1, H, D), k/v (B, clen, Hkv, D), ``kv_positions`` (B, clen)
    int32 (-1 unwritten), ``q_positions`` (B,) int32/int64 -> (B, 1, H, D)
    in q's dtype on the card (``out``, a contiguous tensor of q's shape,
    dtype and device, in place of a new one).  Causal over each slot's
    cache: key j is seen where 0 <= kv_positions[b, j] <= q_positions[b],
    among the first ``min(q_positions[b] + 1, clen)`` slots.

    Takes CUDA tensors only, forward-only (the output carries no autograd
    history); under a span recorder each launch appends a
    ``decode_attention`` record to the open span.
    """
    global launches
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 \
            or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"decode_attention needs q (B,1,H,D) and k/v "
                         f"(B,clen,Hkv,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    clen, hkv = k.shape[1], k.shape[2]
    if tuple(kv_positions.shape) != (b, clen) \
            or kv_positions.dtype != torch.int32 \
            or tuple(q_positions.shape) != (b,) \
            or q_positions.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"decode_attention needs kv_positions (B,clen) "
                         f"int32 and q_positions (B,) int32/int64, got "
                         f"{tuple(kv_positions.shape)} {kv_positions.dtype}"
                         f", {tuple(q_positions.shape)} {q_positions.dtype}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32/bfloat16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not compiled in; choose one of "
                         f"{HEAD_DIMS}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"{h} query heads do not split into groups over "
                         f"{hkv} KV heads")
    tensors = (q, k, v, kv_positions, q_positions)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention needs contiguous operands")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention needs q, k, v on 16-byte "
                         "boundaries")
    if clen < 1 or b < 1:
        raise ValueError(f"decode_attention needs a slot and a cache "
                         f"position, got B {b}, clen {clen}")
    g = h // hkv
    G = group_block(g)
    blocks = hkv * -(-g // G)
    if b > 65535 or blocks > 65535 or clen >= 2 ** 31:
        raise ValueError(f"shape {(b, clen, hkv, g, d)} exceeds the kernel's "
                         f"grid")
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"decode_attention needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    _build.forward_only("decode_attention", q, k, v)
    split_len, nsplit = splits(b, blocks, clen)
    if out is None:
        out = torch.empty_like(q)
    elif out.shape != q.shape or out.dtype != q.dtype \
            or out.device != q.device or not out.is_contiguous() \
            or out.data_ptr() % 16:
        raise ValueError(f"decode_attention out must be a contiguous "
                         f"{tuple(q.shape)} {q.dtype} tensor on {q.device} "
                         f"on 16 bytes, got {tuple(out.shape)} {out.dtype}")
    ws = torch.empty(b * blocks * nsplit * G * (d + 2) if nsplit > 1 else 0,
                     dtype=torch.float32, device=q.device)
    counts = _build.arrival_counts(q.device, b * blocks)
    fn = _build.entry("decode_attention", "decode_attention", C_ARGTYPES)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kv_positions.data_ptr(), q_positions.data_ptr(),
            int(q_positions.dtype == torch.int64), out.data_ptr(),
            ws.data_ptr(), counts.data_ptr(), b, h, hkv, d, clen, G,
            split_len, nsplit, d ** -0.5, DTYPE_CODES[q.dtype],
            torch._C._cuda_getCurrentRawStream(q.device.index))
    if rc:
        raise _build.launch_error(rc, "decode_attention",
                                  f"(b,clen,hkv,g,d)={(b, clen, hkv, g, d)} "
                                  f"{q.dtype}")
    launches += 1
    spans.record_launch("decode_attention", b, hkv, g, d, clen,
                        k.element_size())
    return out
