"""Dispatch between the hand-written kernels and their plain versions.

Port of ``repro/kernels/ops.py``.  ``use_kernel`` takes the place of
``use_pallas``.  A CPU tensor always takes the plain version; a CUDA
tensor with ``use_kernel=True`` launches the kernel, or the call raises.
There is no fallback from a failed build or launch.

The kernel path is forward-only, as the reference's Pallas path is (a
``jax.grad`` through it fails): the wrappers fill their outputs through
``ctypes``, so those outputs carry no autograd history.  With
``use_kernel=True`` a call raises when gradients are enabled and an
operand requires one, on the CPU as on the card, so that a gradient is
never dropped without a word.

DTensor operands (a sharded step, ``launch/steps``) run the same dispatch
on each rank's local shards: K1 through ``models.layers.sharded_matmul``,
K4 through :func:`ssd4`.

Every launch of a hand-written kernel on the model path (K1 from
:func:`gemm`, the decode attention and MLA's decode attention from
``models/attention.py``) goes
through :func:`launch`, which looks the wrapper up by name on this module
at the call, so that a wrapper put in its place is the one called, and
which hands the launch to :data:`split` while one is set:
``models/decode_graph.py`` sets it while it captures a decode step, to
launch each kernel between the captured pieces.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import ref
from repro_torch.kernels._build import forward_only
from repro_torch.kernels.ame_gemm import ame_gemm
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.elementwise import ame_elementwise
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.sharding.context import placed

#: while a decode step is captured, the function that takes each launch
#: in its place (``split(name, args, kw)``; see :func:`launch`)
split: Optional[Callable] = None


def launch(name: str, *args, **kw):
    """``ops.<name>(*args, **kw)``: a hand-written kernel's launch through
    the attribute of this module that holds its wrapper, or handed to
    :data:`split` while one is set."""
    if split is not None:
        return split(name, args, kw)
    return globals()[name](*args, **kw)


def gemm(a: torch.Tensor, b: torch.Tensor, *, use_kernel: bool = False,
         out_dtype: Optional[torch.dtype] = None, **blocks) -> torch.Tensor:
    """C = A @ B via the output-stationary kernel or its plain version."""
    if use_kernel:
        forward_only("ops.gemm", a, b)
    if use_kernel and a.is_cuda:
        return launch("ame_gemm", a, b, out_dtype=out_dtype, **blocks)
    return ref.gemm(a, b, out_dtype=out_dtype)


def elementwise(kind: str, a: torch.Tensor, b: torch.Tensor, *,
                relu: bool = False, use_kernel: bool = False) -> torch.Tensor:
    """Fused mfadd/mfsub/mfmul (+ ReLU) via the kernel or its plain
    version."""
    if use_kernel:
        forward_only("ops.elementwise", a, b)
    if use_kernel and a.is_cuda:
        return ame_elementwise(a, b, kind=kind, relu=relu)
    return ref.elementwise(kind, a, b, relu=relu)


def ssd(x, log_a, b, c, *, use_kernel: bool = False, chunk: int = 128):
    """Batched Mamba2 SSD scan, x (BH,T,P) (chunked in both paths — the
    sequential recurrence lives only in ``ref.ssd_scan`` as the oracle)."""
    if use_kernel:
        forward_only("ops.ssd", x, log_a, b, c)
    if use_kernel and x.is_cuda:
        return ssd_scan(x, log_a, b, c, chunk=chunk)
    return ref.ssd_chunked(x, log_a, b, c, chunk=chunk)


def ssd4(x, log_a, b, c, *, use_kernel: bool = False, chunk: int = 128):
    """4-D SSD: x (B,H,T,P), log_a (B,H,T), b/c (B,H,T,N).  The kernel
    reads strided views (unit stride on P and N; b/c may be expanded over
    heads), so the model's (B,T,H,.) layout is passed without a copy and y
    comes back in x's layout."""
    if isinstance(x, DTensor):
        return _ssd4_local(x, log_a, b, c, use_kernel, chunk)
    if use_kernel:
        forward_only("ops.ssd4", x, log_a, b, c)
    if use_kernel and x.is_cuda:
        return ssd_scan(x, log_a, b, c, chunk=chunk)
    return ref.ssd_chunked4(x, log_a, b, c, chunk=chunk)


def _ssd4_local(x, log_a, b, c, use_kernel: bool, chunk: int):
    """:func:`ssd4` of DTensors on each rank's local shards: every (batch,
    head) row scans on its own, so the operands take x's shards of those
    two dims (T, P and N are gathered) and y keeps them."""
    mesh = x.device_mesh
    pl = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
          for p in x.placements]
    fn = local_map(lambda *a: ssd4(*a, use_kernel=use_kernel, chunk=chunk),
                   out_placements=pl, in_placements=(pl,) * 4,
                   device_mesh=mesh)
    return fn(*(placed(t, mesh, pl) for t in (x, log_a, b, c)))


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              use_kernel: bool = False, **blocks):
    """Attention over q (BH,Tq,D), k/v (BH,Tk,D), queries end-aligned, via
    the online-softmax kernel or its plain version; ``blocks`` are the
    kernel's ``block_q``/``block_k``."""
    if use_kernel:
        forward_only("ops.attention", q, k, v)
    if use_kernel and q.is_cuda:
        return flash_attention(q, k, v, causal=causal, window=window,
                               **blocks)
    return ref.attention(q, k, v, causal=causal, window=window)
