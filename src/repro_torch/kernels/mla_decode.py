"""mla_decode — MLA's absorbed decode attention over the latent cache, read
in place, in one launch (``csrc/mla_decode.cu``).

Replaces no Pallas kernel: the reference attends MLA in plain jnp.  The
port's plain version is :func:`plain`, the decode branch of
:func:`repro_torch.models.attention.mla_apply` as it is written for CPU
tensors,

    chunked_attention(qq, cat([ckv, kr], -1)[:, :, None], ckv[:, :, None],
                      causal=True, q_offset=pos)

which concatenates the whole latent cache on every layer and multiplies
every head against every cache position in f32.  The kernel computes the
same function (only the order of the sums differs) on the tensor cores:
bf16 products summed in f32, the softmax in f32, P kept to ~16 bits; it
reads ``ckv`` and ``kr`` where they are stored and only each slot's live
positions, ``min(pos + 1, clen)`` of them.  ``models/attention.py``
routes a bf16 MLA decode of plain CUDA tensors here; CPU tensors, f32,
the sharded step's DTensors and every prefill keep ``chunked_attention``.

The grid is sized from B, H, clen and the SM count (:func:`splits`),
never from the positions on the device, so the wrapper never
synchronises.  A slot's key range is split over several blocks when the
grid would otherwise leave the card idle; the last of a slot's blocks
merges the splits in the same launch, counting arrivals in a per-device
buffer of zeros that the kernel leaves zeroed (so launches that share it
run on one stream, one after another, as the serve path's do).  This
wrapper validates, allocates the output and the splits' workspace and
launches on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.launch import hw
from repro_torch.obs import spans

#: (r, rd), the latent and rope widths instantiated in csrc/mla_decode.cu:
#: DeepSeek-V3's and every reduced configuration's
WIDTHS = ((512, 64), (32, 16))
#: query heads a block covers (kRows); more heads take more blocks
ROWS = 64
#: keys a staged tile (kKeys); a split is a whole number of tiles
KEYS = 32
#: the most key splits of one (slot, head block) (kMaxSplits)
MAX_SPLITS = 32
#: a split takes at least this many keys
MIN_SPLIT = 64
#: the grid aims at this many blocks an SM with every slot full; one block
#: fills an SM's shared memory
WAVES = 4
#: C arguments of ``mla_decode`` (pointers to qq, ckv, kr, pos; pos is
#: int64; pointers to out, the workspace, the arrival counts; b, h, r, rd,
#: clen, split_len, nsplit; scale; stream)
C_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3 \
    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]

#: kernel launches since the last reset (the wrapper adds one per launch)
launches = 0


def plain(qq: torch.Tensor, ckv: torch.Tensor, kr: torch.Tensor,
          pos: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """The kernel's function in plain PyTorch: MLA's decode attention as
    ``mla_apply`` computes it on CPU tensors, over the whole cache."""
    from repro_torch.models.attention import chunked_attention
    kk = torch.cat([ckv, kr], -1)[:, :, None, :]
    return chunked_attention(qq, kk, ckv[:, :, None, :], causal=True,
                             chunk=chunk, q_offset=pos)


def splits(b: int, blocks: int, clen: int) -> Tuple[int, int]:
    """``(split_len, nsplit)`` for ``b`` slots of ``blocks`` head blocks
    over a cache of ``clen`` positions: enough splits for :data:`WAVES`
    blocks an SM when every slot is full, none shorter than
    :data:`MIN_SPLIT` keys, at most :data:`MAX_SPLITS`, each a whole
    number of :data:`KEYS`-key tiles."""
    want = -(-hw.SMS * WAVES // (b * blocks))
    n = max(1, min(want, MAX_SPLITS, -(-clen // MIN_SPLIT)))
    split_len = -(-clen // n)
    split_len = -(-split_len // KEYS) * KEYS
    return split_len, -(-clen // split_len)


def mla_decode(qq: torch.Tensor, ckv: torch.Tensor, kr: torch.Tensor,
               pos: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """qq (B, 1, H, r + rd), ckv (B, clen, r), kr (B, clen, rd), all bf16,
    ``pos`` (B,) int32/int64 -> (B, 1, H, r) bf16 on the card (``out``, a
    contiguous tensor of that shape on qq's device, in place of a new
    one).  Key j of slot b is ``[ckv[b, j], kr[b, j]]``, its value
    ``ckv[b, j]``, seen where j <= pos[b]; scores scaled by
    ``(r + rd) ** -0.5``.

    Takes CUDA tensors only, forward-only (the output carries no autograd
    history); under a span recorder each launch appends an ``mla_decode``
    record to the open span.
    """
    global launches
    if qq.dim() != 4 or qq.shape[1] != 1 or ckv.dim() != 3 or kr.dim() != 3 \
            or ckv.shape[:2] != kr.shape[:2] or ckv.shape[0] != qq.shape[0] \
            or qq.shape[3] != ckv.shape[2] + kr.shape[2]:
        raise ValueError(f"mla_decode needs qq (B,1,H,r+rd), ckv (B,clen,r) "
                         f"and kr (B,clen,rd), got {tuple(qq.shape)}, "
                         f"{tuple(ckv.shape)}, {tuple(kr.shape)}")
    b, _, h, d = qq.shape
    clen, r = ckv.shape[1], ckv.shape[2]
    rd = d - r
    if tuple(pos.shape) != (b,) or pos.dtype not in (torch.int32,
                                                     torch.int64):
        raise ValueError(f"mla_decode needs pos (B,) int32/int64, got "
                         f"{tuple(pos.shape)} {pos.dtype}")
    if any(t.dtype != torch.bfloat16 for t in (qq, ckv, kr)):
        raise TypeError(f"mla_decode takes bfloat16 qq, ckv, kr, got "
                        f"{qq.dtype}, {ckv.dtype}, {kr.dtype}")
    if (r, rd) not in WIDTHS:
        raise ValueError(f"latent and rope widths {(r, rd)} are not compiled "
                         f"in; choose one of {WIDTHS}")
    tensors = (qq, ckv, kr, pos)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mla_decode needs contiguous operands")
    if any(t.data_ptr() % 16 for t in (qq, ckv, kr)):
        raise ValueError("mla_decode needs qq, ckv, kr on 16-byte "
                         "boundaries")
    if clen < 1 or b < 1 or h < 1:
        raise ValueError(f"mla_decode needs a slot, a head and a cache "
                         f"position, got B {b}, H {h}, clen {clen}")
    blocks = -(-h // ROWS)
    if b > 65535 or blocks > 65535 or clen >= 2 ** 31:
        raise ValueError(f"shape {(b, clen, h)} exceeds the kernel's grid")
    if not all(t.is_cuda and t.device == qq.device for t in tensors):
        raise ValueError(f"mla_decode needs every operand on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    _build.forward_only("mla_decode", qq, ckv, kr)
    shape = (b, 1, h, r)
    if out is None:
        out = torch.empty(shape, dtype=qq.dtype, device=qq.device)
    elif tuple(out.shape) != shape or out.dtype != qq.dtype \
            or out.device != qq.device or not out.is_contiguous() \
            or out.data_ptr() % 16:
        raise ValueError(f"mla_decode out must be a contiguous {shape} "
                         f"{qq.dtype} tensor on {qq.device} on 16 bytes, got "
                         f"{tuple(out.shape)} {out.dtype}")
    split_len, nsplit = splits(b, blocks, clen)
    ws = torch.empty(b * blocks * nsplit * ROWS * (r + 2) if nsplit > 1
                     else 0, dtype=torch.float32, device=qq.device)
    counts = _build.arrival_counts(qq.device, b * blocks)
    fn = _build.entry("mla_decode", "mla_decode", C_ARGTYPES)
    rc = fn(qq.data_ptr(), ckv.data_ptr(), kr.data_ptr(), pos.data_ptr(),
            int(pos.dtype == torch.int64), out.data_ptr(), ws.data_ptr(),
            counts.data_ptr(), b, h, r, rd, clen, split_len, nsplit,
            d ** -0.5, torch._C._cuda_getCurrentRawStream(qq.device.index))
    if rc:
        raise _build.launch_error(rc, "mla_decode",
                                  f"(b,clen,h,r,rd)={(b, clen, h, r, rd)}")
    launches += 1
    spans.record_launch("mla_decode", b, h, r, rd, clen, qq.element_size())
    return out
