"""Data-placement policies: partitioning one op across pseudo-channels.

A placement maps a GEMM/GEMV iteration space (M, K, N) onto pseudo-channels
as a list of :class:`Shard` — axis-aligned boxes that form a *disjoint exact
cover* of the M x K x N compute cuboid (property-tested).  Channel-level
placement, not kernel code, decides whether multi-channel PIM scales (AMD's
*Balanced Data Placement for GEMV Acceleration with PIM*, 2024) — hence
placements are pluggable and named:

* ``row-striped``  — contiguous runs of 128-row blocks per channel, full K
  and N.  Pure output partitioning: bit-exact with a single-channel run,
  but starves channels when M / 128 < channels (skinny GEMV).
* ``2d-block``     — channels factored into a near-square (pr x pc) grid
  over M x N, full K.  Also pure output partitioning; for GEMM
  512x4096x512 on 16 channels every channel gets exactly the paper's
  128x4096x128 max tile.
* ``balanced``     — AMD-style: equalize per-channel MAC passes.  With at
  least one row block per channel this is LPT (longest-processing-time)
  assignment of row blocks; with fewer blocks than channels it splits K
  (AAM-aligned) so every channel works, at the price of a host-side
  reduction of FP16 partials (accounted by the scheduler).

Shards with ``k0 > 0`` or ``k1 < K`` are *partial* products; the scheduler
reduces them on the host in ascending-k order.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Tuple

from repro_torch.core.engine import gemm_tiles
from repro_torch.core.isa import AAM_BLOCKS, ROWNUM


@dataclasses.dataclass(frozen=True)
class Shard:
    """One channel's axis-aligned box of the (M, K, N) iteration space.

    ``stack`` is the leading placement axis of a multi-stack cluster
    (``channel`` is then local to that stack); bare single-stack
    decompositions keep the default ``stack=0`` with cluster-flat ==
    local channel ids, so every pre-cluster call site is unchanged.
    """

    channel: int
    m0: int
    m1: int
    k0: int
    k1: int
    n0: int
    n1: int
    stack: int = 0

    @property
    def rows(self) -> int:
        return self.m1 - self.m0

    @property
    def ks(self) -> int:
        return self.k1 - self.k0

    @property
    def ns(self) -> int:
        return self.n1 - self.n0

    @property
    def flops(self) -> int:
        return 2 * self.rows * self.ks * self.ns

    @property
    def volume(self) -> int:
        return self.rows * self.ks * self.ns

    def is_partial(self, k: int) -> bool:
        """True if this shard computes a partial product needing reduction."""
        return self.k0 > 0 or self.k1 < k

    # -- operand footprints (2D boxes in each operand's own coordinates) ----
    #
    # The residency layer (repro_torch.runtime.residency) keys per-channel
    # resident regions by these boxes, so "is this shard's A slice already
    # on its channel?" is a containment check against the same geometry the
    # scheduler transfers.

    @property
    def a_box(self) -> Tuple[int, int, int, int]:
        """Footprint of this shard in the A operand: (m0, m1, k0, k1)."""
        return (self.m0, self.m1, self.k0, self.k1)

    @property
    def b_box(self) -> Tuple[int, int, int, int]:
        """Footprint of this shard in the B operand: (k0, k1, n0, n1)."""
        return (self.k0, self.k1, self.n0, self.n1)

    @property
    def out_box(self) -> Tuple[int, int, int, int]:
        """Footprint of this shard in the output: (m0, m1, n0, n1)."""
        return (self.m0, self.m1, self.n0, self.n1)


def box_contains(outer: Tuple[int, int, int, int],
                 inner: Tuple[int, int, int, int]) -> bool:
    """True if 2D box ``inner`` lies entirely inside ``outer``."""
    return (outer[0] <= inner[0] and inner[1] <= outer[1]
            and outer[2] <= inner[2] and inner[3] <= outer[3])


def shard_mac_passes(s: Shard) -> int:
    """Exact MAC-PEP loop passes the engine issues for this shard."""
    return sum(math.ceil((c1 - c0) / AAM_BLOCKS) * (j1 - j0)
               for _, _, j0, j1, c0, c1 in gemm_tiles(s.rows, s.ks, s.ns))


def validate_cover(shards: List[Shard], m: int, k: int, n: int) -> None:
    """Assert the shards are a disjoint exact cover of M x K x N."""
    vol = 0
    for s in shards:
        assert 0 <= s.m0 < s.m1 <= m and 0 <= s.k0 < s.k1 <= k \
            and 0 <= s.n0 < s.n1 <= n, f"shard out of bounds: {s}"
        vol += s.volume
    assert vol == m * k * n, f"cover volume {vol} != {m * k * n}"
    for i, a in enumerate(shards):         # disjointness: no box overlap
        for b in shards[i + 1:]:
            if (a.m0 < b.m1 and b.m0 < a.m1 and a.k0 < b.k1
                    and b.k0 < a.k1 and a.n0 < b.n1 and b.n0 < a.n1):
                raise AssertionError(f"overlapping shards: {a} / {b}")


def _row_blocks(m: int) -> List[range]:
    return [range(i0, min(i0 + ROWNUM, m)) for i0 in range(0, m, ROWNUM)]


def _chunks(total: int, parts: int) -> List[int]:
    """Split ``total`` into ``parts`` near-equal non-negative integers."""
    q, r = divmod(total, parts)
    return [q + (1 if i < r else 0) for i in range(parts)]


def row_striped(m: int, k: int, n: int, channels: int) -> List[Shard]:
    """Contiguous runs of 128-row blocks per channel; full K, full N."""
    blocks = _row_blocks(m)
    sizes = _chunks(len(blocks), min(channels, len(blocks)))
    shards, b = [], 0
    for ch, nb in enumerate(sizes):
        if nb == 0:
            continue
        m0 = blocks[b].start
        m1 = blocks[b + nb - 1].stop
        shards.append(Shard(ch, m0, m1, 0, k, 0, n))
        b += nb
    return shards


def block_2d(m: int, k: int, n: int, channels: int) -> List[Shard]:
    """Near-square (pr x pc) channel grid over M x N; full K per shard."""
    blocks = _row_blocks(m)
    pr = max(1, min(int(math.sqrt(channels)), len(blocks)))
    while channels % pr:
        pr -= 1
    pc = min(channels // pr, n)
    row_sizes = _chunks(len(blocks), pr)
    col_sizes = _chunks(n, pc)
    shards, ch, b = [], 0, 0
    for rsz in row_sizes:
        if rsz == 0:
            continue
        m0, m1 = blocks[b].start, blocks[b + rsz - 1].stop
        b += rsz
        n0 = 0
        for csz in col_sizes:
            if csz == 0:
                continue
            shards.append(Shard(ch, m0, m1, 0, k, n0, n0 + csz))
            ch += 1
            n0 += csz
    return shards


def balanced(m: int, k: int, n: int, channels: int) -> List[Shard]:
    """Equalize per-channel MAC passes (AMD balanced placement).

    With >= 1 row block per channel: LPT assignment of row blocks to the
    least-loaded channel (ties broken by channel id), which also handles
    ragged last blocks.  With fewer blocks than channels: split each
    block's K range across its share of channels, AAM-aligned, so every
    channel contributes — the scheduler reduces the FP16 partials.
    """
    blocks = _row_blocks(m)
    if len(blocks) >= channels:
        load = [0] * channels
        shards: List[Shard] = []
        order = sorted(blocks, key=lambda blk: -Shard(
            0, blk.start, blk.stop, 0, k, 0, n).volume)
        for blk in order:
            ch = min(range(channels), key=lambda c: (load[c], c))
            s = Shard(ch, blk.start, blk.stop, 0, k, 0, n)
            load[ch] += shard_mac_passes(s)
            shards.append(s)
        return sorted(shards, key=lambda s: (s.channel, s.m0))

    # fewer row blocks than channels: split K, AAM_BLOCKS-aligned
    shares = _chunks(channels, len(blocks))
    kgroups = math.ceil(k / AAM_BLOCKS)
    shards, ch = [], 0
    for blk, share in zip(blocks, shares):
        share = max(1, min(share, kgroups))
        g0 = 0
        for gsz in _chunks(kgroups, share):
            if gsz == 0:
                continue
            k0 = g0 * AAM_BLOCKS
            k1 = min((g0 + gsz) * AAM_BLOCKS, k)
            shards.append(Shard(ch, blk.start, blk.stop, k0, k1, 0, n))
            ch += 1
            g0 += gsz
    return shards


def paged(m: int, k: int, n: int, channels: int) -> List[Shard]:
    """Block-cyclic placement for *growing* operands (the KV cache).

    ``row-striped``/``balanced`` re-balance the whole operand whenever M
    (or K) grows past a block boundary, so the block->channel assignment
    of the *prefix* moves and every decode step re-ships context that is
    already resident.  ``paged`` fixes each 128-sized block to a channel
    by index — growth appends new blocks without touching old ones, so
    resident prefix boxes hit forever:

    * M > ROWNUM: one shard per 128-row block, ``channel = block % C``,
      full K and N (a K cache ``(ctx, head_dim)`` growing along rows).
    * M <= ROWNUM: 128-column K groups (AAM-aligned; 128 % AAM_BLOCKS
      == 0), ``channel = group % C`` (a transposed V cache
      ``(head_dim, ctx)`` growing along columns); the K-split partials
      are host-reduced by the scheduler like ``balanced``'s.

    The two cases compose: the score GEMV's output row block *b* and the
    context GEMV's K group *b* land on the same channel, so a kept score
    output is consumed in place by the context op with zero traffic.
    """
    blocks = _row_blocks(m)
    if len(blocks) > 1:
        return [Shard(i % channels, blk.start, blk.stop, 0, k, 0, n)
                for i, blk in enumerate(blocks)]
    kgroups = [range(k0, min(k0 + ROWNUM, k)) for k0 in range(0, k, ROWNUM)]
    return [Shard(g % channels, 0, m, grp.start, grp.stop, 0, n)
            for g, grp in enumerate(kgroups)]


PLACEMENTS: Dict[str, Callable[[int, int, int, int], List[Shard]]] = {
    "row-striped": row_striped,
    "2d-block": block_2d,
    "balanced": balanced,
    "paged": paged,
}


def get_placement(name: str) -> Callable[[int, int, int, int], List[Shard]]:
    try:
        return PLACEMENTS[name]
    except KeyError:
        raise KeyError(f"unknown placement {name!r}; "
                       f"available: {sorted(PLACEMENTS)}") from None


def placement_shards(policy: str, m: int, k: int, n: int,
                     channels: int) -> Tuple[Shard, ...]:
    """Memoized, cover-validated shard decomposition.

    Placement functions are pure in ``(policy, m, k, n, channels)``, and
    the serve loop's decode path recomputes the identical decomposition
    every step — so the scheduler resolves shards through this cache.
    Returns an immutable tuple (callers must not mutate shard lists), with
    :func:`validate_cover` run once per distinct key instead of per op.

    ``paged`` operands *grow*: a KV cache whose M (or K) dimension changes
    every decode step would mint a fresh cache entry per step and a
    32k-token decode would pin thousands of dead decompositions.  Paged
    decompositions therefore bypass memoization entirely (they are cheap
    — one shard per block, constructively disjoint, so no O(shards^2)
    cover validation either) and the lru_cache only ever holds
    fixed-shape keys.
    """
    if policy == "paged":
        return tuple(paged(m, k, n, channels))
    return _placement_shards_cached(policy, m, k, n, channels)


@functools.lru_cache(maxsize=4096)
def _placement_shards_cached(policy: str, m: int, k: int, n: int,
                             channels: int) -> Tuple[Shard, ...]:
    shards = tuple(get_placement(policy)(m, k, n, channels))
    validate_cover(list(shards), m, k, n)
    return shards


def cluster_shards(policy: str, m: int, k: int, n: int, stacks: int,
                   channels_per_stack: int) -> Tuple[Shard, ...]:
    """Memoized ``(stack, channel)`` decomposition across a cluster.

    The placement policy runs over the *flat* channel space
    (``stacks * channels_per_stack`` — so a reshape of the same total
    channel count produces the identical shard geometry, hence makespan
    parity), then each flat channel id splits into the leading stack
    axis: contiguous channel runs map to contiguous stacks.  Which boxes
    land with channels of *different* stacks is exactly what the
    scheduler's host-link ledger charges.

    Like :func:`placement_shards`, ``paged`` keys (growing KV shapes)
    bypass the lru_cache.
    """
    if policy == "paged":
        return _cluster_shards_impl(policy, m, k, n, stacks,
                                    channels_per_stack)
    return _cluster_shards_cached(policy, m, k, n, stacks,
                                  channels_per_stack)


def _cluster_shards_impl(policy: str, m: int, k: int, n: int, stacks: int,
                         channels_per_stack: int) -> Tuple[Shard, ...]:
    flat = placement_shards(policy, m, k, n, stacks * channels_per_stack)
    return tuple(dataclasses.replace(
        s, stack=s.channel // channels_per_stack,
        channel=s.channel % channels_per_stack) for s in flat)


_cluster_shards_cached = functools.lru_cache(maxsize=4096)(
    _cluster_shards_impl)


def stack_restricted_shards(policy: str, m: int, k: int, n: int,
                            stack: int,
                            channels_per_stack: int) -> Tuple[Shard, ...]:
    """Memoized decomposition of one op onto a *single* stack of a
    cluster (the decode-offload regime: each layer's weights live on
    their home stack, re-decomposed every step).  Channel ids are local
    to ``stack``.  ``paged`` keys bypass the lru_cache."""
    if policy == "paged":
        return _stack_restricted_impl(policy, m, k, n, stack,
                                      channels_per_stack)
    return _stack_restricted_cached(policy, m, k, n, stack,
                                    channels_per_stack)


def _stack_restricted_impl(policy: str, m: int, k: int, n: int, stack: int,
                           channels_per_stack: int) -> Tuple[Shard, ...]:
    flat = placement_shards(policy, m, k, n, channels_per_stack)
    return tuple(dataclasses.replace(s, stack=stack) for s in flat)


_stack_restricted_cached = functools.lru_cache(maxsize=4096)(
    _stack_restricted_impl)


def subset_shards(policy: str, m: int, k: int, n: int,
                  flat_channels: Tuple[int, ...],
                  channels_per_stack: int) -> Tuple[Shard, ...]:
    """Memoized decomposition of one op onto an explicit *subset* of a
    stack's (or cluster's) flat channel ids.

    The async scheduler runs independent ops of one dependency level on
    disjoint channel groups — q/k/v of a decode layer concurrently on
    their home stack's channels — so the placement policy runs over
    ``len(flat_channels)`` virtual channels and each virtual id maps to
    its flat id (then splits into ``(stack, channel)``).  The same
    subset used for ``place`` and the consuming ops yields identical
    shard geometry, so residency hits exactly as on full-width ops.

    ``paged`` keys (growing KV shapes) bypass the lru_cache.
    """
    if policy == "paged":
        return _subset_shards_impl(policy, m, k, n, flat_channels,
                                   channels_per_stack)
    return _subset_shards_cached(policy, m, k, n, flat_channels,
                                 channels_per_stack)


def _subset_shards_impl(policy: str, m: int, k: int, n: int,
                        flat_channels: Tuple[int, ...],
                        channels_per_stack: int) -> Tuple[Shard, ...]:
    if len(set(flat_channels)) != len(flat_channels):
        raise ValueError(f"duplicate channel ids in subset {flat_channels}")
    flat = placement_shards(policy, m, k, n, len(flat_channels))
    out = []
    for s in flat:
        f = flat_channels[s.channel]
        out.append(dataclasses.replace(
            s, stack=f // channels_per_stack, channel=f % channels_per_stack))
    return tuple(out)


_subset_shards_cached = functools.lru_cache(maxsize=4096)(
    _subset_shards_impl)
