"""Operand residency: device-resident tensor handles for the PIM runtime.

PrIM's central lesson is that host<->PIM transfer dominates real PIM
workloads unless data stays resident.  The scheduler's default path
re-ships every operand shard per op — correct accounting for one-shot
ops, but wrong for the serve-loop regime where the same weight matrix is
reused every decode step.  This module is the residency layer:

* :class:`DeviceTensor` — a handle to a host array whose shards live on
  the stack's pseudo-channels.  The handle records *which* 2D boxes of
  the tensor are resident on *which* channel (mirrored into each
  :class:`~repro_torch.runtime.device.PIMDevice`'s residency table); the
  scheduler consults it per shard and charges **zero** h2d for resident
  regions, appending a ``reuse`` event so traces stay replayable.
* :func:`place` — eagerly uploads an array's shards per a placement
  policy (the "load the weights once" step), charging the one-time h2d
  and returning the handle.  Handles may also be created lazily: a miss
  during an op transfers the shard *and* marks it resident, so repeated
  ops converge to zero weight traffic either way.

Outputs can stay resident too (``keep_output=True`` on the scheduler
ops): the op then charges no d2h for exact-cover output shards; the
drain is deferred until :meth:`DeviceTensor.to_host`, and a chained op
consuming the handle on the same channel boxes never pays it at all —
the GEMM->elementwise epilogue fusion the ROADMAP names.

Numerics are unchanged by residency: ``execute=True`` runs the same
per-channel engines over the same host mirror, so resident-handle
outputs are bit-exact with the fresh-transfer path (property-tested).
Analytic handles (shape-only, ``values=None``) support paper-scale
sweeps without materializing weights.

Port of ``repro.runtime.residency``: the FP16 mirror the engines compute
from is a ``torch.float16`` tensor on the stack's device (the card by
default), made from a numpy array or a tensor.
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.isa import ROWNUM
from repro_torch.runtime.device import BYTES_PER_ELEM, PIMStack, box_bytes

Box = Tuple[int, int, int, int]

_uid = itertools.count(1)


def as_f16(x, device) -> torch.Tensor:
    """``x`` as a float16 tensor on ``device``: a numpy array (or
    anything numpy takes) is rounded by numpy, as the reference rounds
    it, a tensor by ``.to``; no copy when ``x`` already is one there."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float16)
    return torch.from_numpy(np.array(x, np.float16)).to(device)

#: Tokens per KV page.  Equal to ROWNUM so one K-cache page is exactly one
#: 128-row placement block (and one transposed-V page one 128-column K
#: group) under the ``paged`` placement policy — page boxes and shard
#: operand boxes coincide, which is what makes the residency containment
#: check hit without geometry translation.
KV_BLOCK_TOKENS = ROWNUM


class DeviceTensor:
    """A 2D tensor with per-channel shard residency on a :class:`PIMStack`
    (or a :class:`~repro_torch.runtime.cluster.PIMCluster`, addressed through
    its flat channel view — residency tables are per-device either way).

    ``values`` is the host mirror (an FP16 tensor on the stack's device)
    that execute-mode engines compute from — residency changes
    *accounting*, never numerics.  ``values`` is
    ``None`` for analytic (shape-only) handles, which only cost-model
    sweeps may consume.

    ``pending_d2h`` holds output boxes computed on-device but not yet
    drained to the host; :meth:`to_host` charges their d2h then returns
    the mirror.

    ``copy=True`` (the default, and what :meth:`PIMRuntime.place` uses)
    snapshots the caller's array: on real hardware resident data cannot
    change without a transfer, so later host-side mutation of the source
    must not leak into the "resident" copy.  The scheduler's own
    ``keep_output`` handles pass ``copy=False`` — they deliberately alias
    the op's output buffer so the host-side K-split reduction lands in
    the mirror.
    """

    def __init__(self, stack: PIMStack, shape: Tuple[int, int],
                 values=None, copy: bool = True):
        if len(shape) != 2:
            raise ValueError(
                f"DeviceTensor models 2D operands; got shape {shape} — "
                f"reshape/flatten to (rows, cols) before placing")
        self.uid = next(_uid)
        self.stack = stack
        self.shape = tuple(shape)
        if values is None:
            self.values = None
        else:
            self.values = as_f16(values, stack.torch_device)
            if copy and self.values is values:
                self.values = self.values.clone()
        self.pending_d2h: List[Tuple[int, Box]] = []   # (channel, box)

    # -- residency queries / updates (delegate to the device tables) --------

    def is_resident(self, channel: int, box: Box) -> bool:
        return self.stack[channel].has_resident(self.uid, box)

    def mark_resident(self, channel: int, box: Box,
                      pin: bool = False) -> bool:
        """Record residency; under a device capacity bound the device may
        refuse (box streamed, not resident) or evict LRU tensors first.
        ``pin=True`` protects the region from eviction until
        :meth:`to_host` drains it (kept outputs — the only copy of a
        result lives on-channel until then).  Returns whether the box is
        now resident."""
        return self.stack[channel].add_resident(self.uid, box, pin=pin)

    @property
    def resident_bytes(self) -> int:
        """Total bytes of this tensor resident across all channels
        (> host size when placements replicate regions)."""
        return sum(d.resident_bytes_of(self.uid) for d in self.stack)

    # -- host materialization ------------------------------------------------

    def to_host(self) -> Optional[torch.Tensor]:
        """Drain pending output shards (charged as d2h) and return a copy
        of the mirror (``None`` for analytic handles).  Drained regions
        become evictable again (unpinned)."""
        for channel, box in self.pending_d2h:
            dev = self.stack[channel]
            dev.pim_to_host(box_bytes(box))
            dev.unpin(self.uid)
        self.pending_d2h = []
        return self.values.clone() if self.values is not None else None

    def evict(self) -> None:
        """Drop all residency (capacity reclaim).  No traffic is charged;
        un-drained outputs are lost unless :meth:`to_host` ran first."""
        for dev in self.stack:
            dev.drop_resident(self.uid)
        self.pending_d2h = []

    def resolve(self) -> torch.Tensor:
        """Host mirror for execute-mode engines; rejects analytic handles."""
        assert self.values is not None, \
            "analytic (shape-only) DeviceTensor cannot be executed " \
            "numerically; pass execute=False or place a real array"
        return self.values

    def __repr__(self) -> str:
        mode = "analytic" if self.values is None else "numeric"
        return (f"DeviceTensor(uid={self.uid}, shape={self.shape}, "
                f"{mode}, resident_bytes={self.resident_bytes})")


class PagedTensor(DeviceTensor):
    """A :class:`DeviceTensor` that *grows* along one axis in fixed
    :data:`KV_BLOCK_TOKENS`-sized pages — the KV-cache operand shape.

    A K cache is ``(tokens, head_dim)`` growing along axis 0; a V cache
    is stored transposed ``(head_dim, tokens)`` growing along axis 1 so
    the context GEMV ``probs @ V`` runs as ``V^T``-resident K-split
    shards.  Either way the *fixed* axis must fit one placement block
    (``head_dim <= ROWNUM``) so each page's box coincides with exactly
    one ``paged``-placement shard operand box.

    Growth is an *append*, never a re-layout: page ``i`` keeps its box
    and (under ``paged`` placement) its channel forever, so the resident
    prefix is never re-shipped.  Only the trailing partial page's box
    changes as it fills; re-marking it resident supersedes the old
    contained box (see ``PIMDevice.add_resident``).  The host mirror is
    kept in a capacity buffer grown page-at-a-time, with ``values``
    exposed as the logical-extent view.
    """

    def __init__(self, stack: PIMStack, fixed: int, grow_axis: int = 0,
                 numeric: bool = False):
        if grow_axis not in (0, 1):
            raise ValueError(f"grow_axis must be 0 or 1, got {grow_axis}")
        if not 1 <= fixed <= ROWNUM:
            raise ValueError(
                f"fixed dim {fixed} must be in [1, {ROWNUM}] so a page "
                f"spans exactly one placement block")
        shape = (0, fixed) if grow_axis == 0 else (fixed, 0)
        super().__init__(stack, shape, values=None)
        self.grow_axis = grow_axis
        self.fixed = fixed
        self.numeric = numeric
        self.tokens = 0
        self._buf: Optional[torch.Tensor] = None   # capacity >= tokens

    @property
    def num_blocks(self) -> int:
        return -(-self.tokens // KV_BLOCK_TOKENS)

    def block_box(self, idx: int) -> Box:
        """Operand-coordinate box of page ``idx`` at the current extent
        (the trailing page's box grows until the page fills)."""
        lo = idx * KV_BLOCK_TOKENS
        hi = min(lo + KV_BLOCK_TOKENS, self.tokens)
        assert lo < hi, f"page {idx} empty at {self.tokens} tokens"
        if self.grow_axis == 0:
            return (lo, hi, 0, self.fixed)
        return (0, self.fixed, lo, hi)

    def append(self, count: int,
               values=None) -> int:
        """Grow the logical extent by ``count`` tokens and return the
        index of the first page touched by the new entries.  ``values``
        (``(count, fixed)`` or ``(fixed, count)`` matching ``grow_axis``)
        fills the numeric mirror; accounting (h2d of the new entries,
        residency re-mark) is the KV manager's job, not this handle's.
        """
        if count <= 0:
            raise ValueError(f"append count must be positive, got {count}")
        first_block = self.tokens // KV_BLOCK_TOKENS
        lo, self.tokens = self.tokens, self.tokens + count
        if self.numeric:
            cap = -(-self.tokens // KV_BLOCK_TOKENS) * KV_BLOCK_TOKENS
            full = ((cap, self.fixed) if self.grow_axis == 0
                    else (self.fixed, cap))
            if self._buf is None or self._buf.shape[self.grow_axis] < cap:
                buf = torch.zeros(full, dtype=torch.float16,
                                  device=self.stack.torch_device)
                if self._buf is not None:
                    if self.grow_axis == 0:
                        buf[:lo] = self._buf[:lo]
                    else:
                        buf[:, :lo] = self._buf[:, :lo]
                self._buf = buf
            if values is not None:
                new = as_f16(values, self.stack.torch_device)
                if self.grow_axis == 0:
                    self._buf[lo:self.tokens] = new
                else:
                    self._buf[:, lo:self.tokens] = new
            self.values = (self._buf[:self.tokens] if self.grow_axis == 0
                           else self._buf[:, :self.tokens])
        self.shape = ((self.tokens, self.fixed) if self.grow_axis == 0
                      else (self.fixed, self.tokens))
        return first_block

    def __repr__(self) -> str:
        mode = "numeric" if self.numeric else "analytic"
        return (f"PagedTensor(uid={self.uid}, shape={self.shape}, "
                f"axis={self.grow_axis}, blocks={self.num_blocks}, {mode}, "
                f"resident_bytes={self.resident_bytes})")
