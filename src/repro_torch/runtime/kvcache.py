"""Paged KV-cache residency: the growing operand of attention decode.

DecodeOffload made the decode *weights* resident; the other decode
bandwidth sink is the per-step attention score/context GEMVs against a
KV cache that grows one token per step.  This module makes that cache a
first-class resident operand:

* Per request, per layer, per kv head, a K cache ``(tokens, head_dim)``
  and a transposed V cache ``(head_dim, tokens)`` live as
  :class:`~repro_torch.runtime.residency.PagedTensor` handles growing in
  :data:`~repro_torch.runtime.residency.KV_BLOCK_TOKENS`-token pages.
* The per-step K/V append is a **resident elementwise write**: only the
  new token's bytes cross the bus (charged on the owning channel, marked
  ``# KVAPPEND`` in the trace), and re-marking the grown trailing-page
  box supersedes the old one — the prefix is never re-shipped, so
  steady-state per-step h2d is independent of context length.
* Page ``i`` is owned by channel ``chans[i % len(chans)]`` — exactly the
  ``paged`` placement policy's block-cyclic assignment, so the score
  GEMV (``K @ q``), the in-place softmax epilogue, and the context GEMV
  (``V^T @ probs``) all hit residency page-for-page as the context
  grows.
* Under a ``capacity_bytes`` budget, appends evict the **oldest
  non-trailing pages of the coldest request** (deterministic: requests
  ordered by last-decoded step, pages ascending; ``# KVEVICT`` markers,
  zero traffic now).  Evicted pages are restored before the victim
  request next decodes — real h2d plus a host-link ``reupload`` charge
  on clusters — so 32k+ contexts under capacity pressure are honestly
  modeled.  Pages lost to injected channel failures need no handling
  here: the wiped residency misses at the next GEMV and
  ``FaultInjector.on_reship`` charges the recovery.

Numerics are unchanged by any of this (the host mirrors are never
dropped), so a numeric decode offload can cross-check attention-on-PIM
outputs against an FP32 reference across evictions and faults.

Port of ``repro.runtime.kvcache``; a numeric page mirror is a float16
tensor on the runtime's device.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

from repro_torch.runtime.device import BYTES_PER_ELEM, box_bytes
from repro_torch.runtime.placement import box_contains
from repro_torch.runtime.residency import KV_BLOCK_TOKENS, PagedTensor


class _RequestKV:
    """One request's KV tensors: ``k[layer][head]`` / ``vt[layer][head]``."""

    __slots__ = ("rid", "k", "vt", "tokens", "last_step", "evicted")

    def __init__(self, rid: Hashable, stack, n_layers: int,
                 n_kv_heads: int, head_dim: int, numeric: bool):
        self.rid = rid
        self.k = [[PagedTensor(stack, head_dim, grow_axis=0,
                               numeric=numeric)
                   for _ in range(n_kv_heads)] for _ in range(n_layers)]
        self.vt = [[PagedTensor(stack, head_dim, grow_axis=1,
                                numeric=numeric)
                    for _ in range(n_kv_heads)] for _ in range(n_layers)]
        self.tokens = 0
        self.last_step = 0          # manager clock at last decode
        self.evicted: set = set()   # page indices currently off-device

    @property
    def num_blocks(self) -> int:
        return -(-self.tokens // KV_BLOCK_TOKENS)

    def tensors(self):
        for layer_k, layer_vt in zip(self.k, self.vt):
            for tk, tv in zip(layer_k, layer_vt):
                yield tk
                yield tv


class KVCacheManager:
    """Owns every request's paged KV residency on one runtime.

    ``channels_for_layer(layer) -> flat channel ids`` supplies the
    channel subset each layer's pages cycle over — the same subset the
    caller runs that layer's attention GEMVs on (home stack channels,
    minus failed ones), so page owners and ``paged``-placement shard
    channels coincide and residency hits page-for-page.

    ``capacity_bytes`` bounds the *total* resident KV bytes across all
    requests (``None`` = unbounded).  The floor is the per-request
    trailing pages — those are never evicted (the decode step is about
    to grow them) — so a budget below one page per tensor stays over
    budget gracefully rather than thrashing.
    """

    def __init__(self, rt, *, n_layers: int, n_kv_heads: int,
                 head_dim: int,
                 channels_for_layer: Callable[[int], Sequence[int]],
                 capacity_bytes: Optional[int] = None,
                 numeric: bool = False, metrics=None):
        if not 1 <= head_dim <= KV_BLOCK_TOKENS:
            raise ValueError(
                f"head_dim {head_dim} must be in [1, {KV_BLOCK_TOKENS}] "
                f"so one KV page spans exactly one placement block — use "
                f"a reduced config")
        self.rt = rt
        self.n_layers = n_layers
        self.n_kv_heads = n_kv_heads
        self.head_dim = head_dim
        self.channels_for_layer = channels_for_layer
        self.capacity_bytes = capacity_bytes
        self.numeric = numeric
        self.metrics = metrics
        self._reqs: Dict[Hashable, _RequestKV] = {}
        self._clock = 0
        self._present = 0           # resident KV bytes, manager's ledger
        self.append_bytes = 0
        self.evict_bytes = 0
        self.restore_bytes = 0
        self.evictions = 0          # page-evict events (per tensor page)

    # -- request lifecycle ---------------------------------------------------

    def request(self, rid: Hashable) -> _RequestKV:
        st = self._reqs.get(rid)
        if st is None:
            st = self._reqs[rid] = _RequestKV(
                rid, self.rt.stack, self.n_layers, self.n_kv_heads,
                self.head_dim, self.numeric)
        return st

    def begin_decode(self, rid: Hashable) -> _RequestKV:
        """Mark ``rid`` as the currently decoding (hottest) request and
        restore any pages evicted under capacity pressure."""
        st = self.request(rid)
        self._clock += 1
        st.last_step = self._clock
        if st.evicted:
            self._restore(st)
        return st

    def tokens(self, rid: Hashable) -> int:
        st = self._reqs.get(rid)
        return st.tokens if st is not None else 0

    def tensors(self, rid: Hashable, layer: int,
                head: int) -> Tuple[PagedTensor, PagedTensor]:
        st = self._reqs[rid]
        return st.k[layer][head], st.vt[layer][head]

    def release(self, rid: Hashable) -> int:
        """Drop a finished request's KV entirely (capacity reclaim, no
        traffic).  Returns the resident bytes freed."""
        st = self._reqs.pop(rid, None)
        if st is None:
            return 0
        freed = 0
        for b in range(st.num_blocks):
            if b not in st.evicted:
                freed += self._block_bytes(st, b)
        for t in st.tensors():
            t.evict()
        self._present -= freed
        return freed

    # -- appends (the per-step resident write) -------------------------------

    def append_tokens(self, rid: Hashable, layer: int, count: int,
                      k_vals: Optional[Sequence] = None,
                      v_vals: Optional[Sequence] = None,
                      after=None):
        """Grow one layer's K/V by ``count`` tokens across all kv heads.

        Only the new tokens' bytes are charged (h2d on each touched
        page's owner channel, ``# KVAPPEND``-marked); the grown trailing
        page is re-marked resident, superseding its old box.  ``k_vals``
        / ``v_vals`` are per-head ``(count, head_dim)`` / ``(head_dim,
        count)`` numeric payloads.  On an async runtime the append is
        submitted as one timeline op (returned; the attention GEMVs
        reading these tensors then start after the write lands);
        serialized runtimes return ``None``.
        """
        st = self.request(rid)
        if after is not None and not isinstance(after, (list, tuple)):
            after = (after,)        # a bare OpHandle chains too
        chans = tuple(sorted(self.channels_for_layer(layer)))
        marks = {c: len(self.rt.stack[c].events) for c in chans}
        busy: Dict[int, float] = {}
        uids: List[int] = []
        appended = 0
        # this layer's own extent, not st.tokens: layers append one at a
        # time within a step, so the request-level count lags until the
        # last layer lands
        lo = st.k[layer][0].tokens
        for j in range(self.n_kv_heads):
            pairs = ((st.k[layer][j],
                      None if k_vals is None else k_vals[j]),
                     (st.vt[layer][j],
                      None if v_vals is None else v_vals[j]))
            for t, vals in pairs:
                t.append(count, vals)
                uids.append(t.uid)
                b0 = lo // KV_BLOCK_TOKENS
                b1 = (t.tokens - 1) // KV_BLOCK_TOKENS
                for b in range(b0, b1 + 1):
                    blo = b * KV_BLOCK_TOKENS
                    bhi = min(blo + KV_BLOCK_TOKENS, t.tokens)
                    nb = (bhi - max(blo, lo)) * t.fixed * BYTES_PER_ELEM
                    owner = chans[b % len(chans)]
                    dev = self.rt.stack[owner]
                    busy[owner] = busy.get(owner, 0.0) \
                        + dev.host_to_pim(nb)
                    dev.events.append(("kvappend", nb))
                    t.mark_resident(owner, t.block_box(b))
                    appended += nb
                    self._present += nb
        self.append_bytes += appended
        st.tokens = max(st.tokens, lo + count)
        handle = None
        if self.rt.timeline is not None:
            handle = self.rt._submit_async(
                "kvappend", busy, 0, marks, reads=(), writes=tuple(uids),
                after=after, report=None, result=None)
        if self.metrics is not None:
            self.metrics.counter(
                "kv.append_bytes", unit="bytes",
                help="new-token KV bytes written in place").inc(appended)
        self._enforce_capacity()
        return handle

    # -- capacity: paged eviction / restore ----------------------------------

    def _block_bytes(self, st: _RequestKV, b: int) -> int:
        """Resident bytes of page ``b`` across all of one request's
        tensors (K and V^T of every layer and head)."""
        span = min((b + 1) * KV_BLOCK_TOKENS, st.tokens) \
            - b * KV_BLOCK_TOKENS
        return (span * self.head_dim * BYTES_PER_ELEM
                * 2 * self.n_kv_heads * self.n_layers)

    def _enforce_capacity(self) -> None:
        if self.capacity_bytes is None:
            return
        while self._present > self.capacity_bytes:
            victim: Optional[Tuple[_RequestKV, int]] = None
            for st in sorted(self._reqs.values(),
                             key=lambda s: (s.last_step, str(s.rid))):
                # only pages every tensor has materialized: mid-prefill
                # (layers append one at a time) the laggards' pages
                # don't exist yet, so the request is briefly immune
                full = min((t.tokens for t in st.tensors()), default=0)
                nblocks = -(-full // KV_BLOCK_TOKENS)
                cand = [b for b in range(nblocks - 1)
                        if b not in st.evicted]
                if cand:
                    victim = (st, cand[0])
                    break
            if victim is None:
                return      # only trailing pages left: over budget, stable
            self._evict_block(*victim)

    def _evict_block(self, st: _RequestKV, b: int) -> None:
        """Drop page ``b`` of every tensor of ``st`` (oldest page of the
        coldest request): residency forgotten, ``# KVEVICT``-marked, zero
        traffic now — the restore pays the re-ship."""
        for layer in range(self.n_layers):
            chans = tuple(sorted(self.channels_for_layer(layer)))
            owner = chans[b % len(chans)]
            dev = self.rt.stack[owner]
            for j in range(self.n_kv_heads):
                for t in (st.k[layer][j], st.vt[layer][j]):
                    box = t.block_box(b)
                    nb = box_bytes(box)
                    dev.drop_resident_box(t.uid, box)
                    dev.events.append(("kvevict", nb))
                    self.evict_bytes += nb
                    self._present -= nb
                    self.evictions += 1
        st.evicted.add(b)
        if self.metrics is not None:
            self.metrics.counter(
                "kv.evictions", unit="pages",
                help="KV pages evicted under capacity pressure").inc(
                2 * self.n_kv_heads * self.n_layers)

    def _restore(self, st: _RequestKV) -> None:
        """Re-ship every evicted page of ``st`` before it decodes again:
        real h2d on each page's owner plus a host-link ``reupload``
        charge on clusters (the host re-carries the pages from its
        mirror, like lost weights)."""
        link = getattr(self.rt.stack, "link", None)
        marks_all: Dict[int, int] = {}
        busy: Dict[int, float] = {}
        uids: List[int] = []
        restored = 0
        for b in sorted(st.evicted):
            for layer in range(self.n_layers):
                chans = tuple(sorted(self.channels_for_layer(layer)))
                owner = chans[b % len(chans)]
                dev = self.rt.stack[owner]
                marks_all.setdefault(owner, len(dev.events))
                for j in range(self.n_kv_heads):
                    for t in (st.k[layer][j], st.vt[layer][j]):
                        box = t.block_box(b)
                        nb = box_bytes(box)
                        # a GEMV that ran between the evict and this
                        # restore already re-shipped the page at its
                        # residency miss — reclaim it on the ledger
                        # without paying the transfer twice
                        if any(box_contains(rb, box)
                               for rb in dev.resident.get(t.uid, ())):
                            self._present += nb
                            continue
                        busy[owner] = busy.get(owner, 0.0) \
                            + dev.host_to_pim(nb)
                        if link is not None:
                            link.charge("reupload", nb)
                        t.mark_resident(owner, box)
                        uids.append(t.uid)
                        restored += nb
                        self._present += nb
        self.restore_bytes += restored
        st.evicted.clear()
        if self.rt.timeline is not None:
            self.rt._submit_async(
                "kvrestore", busy, 0, marks_all, reads=(),
                writes=tuple(uids), after=None, report=None, result=None)
        if self.metrics is not None:
            self.metrics.counter(
                "kv.restore_bytes", unit="bytes",
                help="evicted KV pages re-shipped before decode").inc(
                restored)

    # -- reporting -----------------------------------------------------------

    @property
    def resident_kv_bytes(self) -> int:
        """The manager's ledger of on-device KV bytes (what the capacity
        budget is enforced against)."""
        return self._present

    def summary(self) -> Dict:
        return {
            "requests": len(self._reqs),
            "tokens": {str(st.rid): st.tokens
                       for st in self._reqs.values()},
            "resident_kv_bytes": self._present,
            "append_bytes": self.append_bytes,
            "evict_bytes": self.evict_bytes,
            "restore_bytes": self.restore_bytes,
            "evictions": self.evictions,
        }
