"""Device-level PIM runtime: the layer between per-channel engines and
workloads.

Layers (bottom-up): ISA -> PEP -> channel interpreter -> AMEEngine (one
pseudo-channel) -> **this runtime** (multi-pseudo-channel stack).  See
``docs/runtime.md``.  Port of ``repro.runtime``: the ledgers, reports and
traces are the reference's; the engines' numerics run as torch ops on the
runtime's device (the card unless the caller passes another), and results
are float16 tensors there.

  device     — PIMStack / PIMDevice: 16 pseudo-channels, each an
               independent AMEEngine + host<->PIM transfer accounting
               + per-channel operand-residency tables (optionally
               capacity-bounded with LRU spill)
  cluster    — PIMCluster: N stacks behind one scheduler and one shared
               host link; inter-stack traffic charged at link bandwidth
  placement  — pluggable data-placement policies (row-striped, 2d-block,
               AMD-style balanced) + operand-footprint boxes + the
               leading stack axis of cluster decompositions
  residency  — DeviceTensor handles: operands/outputs resident per
               channel, zero h2d on reuse (PIMRuntime.place)
  scheduler  — PIMRuntime: partitions GEMM/GEMV/element-wise ops per the
               placement, dispatches per-channel command streams
               asynchronously (makespan = max over channels), overlaps
               transfers with PEP execution, reports RuntimeReport
  timeline   — async dependency-aware op timeline (async_mode=True):
               OpHandle futures, per-channel + per-link clocks, shard
               starts at max(dep retire, channel free, link free)
  trace      — HBM-PIMulator-compatible command-trace emitter + parser
               (resident reuses and async TSTART/TEND schedule markers
               round-trip as replay-neutral comments)
  kvcache    — KVCacheManager: paged per-request KV residency (appends,
               capacity eviction, restore)
"""
from repro_torch.runtime.cluster import (
    HOST_LINK_BANDWIDTH_BYTES_PER_S,
    HOST_LINK_BYTES_PER_CYCLE,
    HostLinkLedger,
    PIMCluster,
    host_link_cycles,
)
from repro_torch.runtime.device import (
    CHANNEL_BANDWIDTH_BYTES_PER_S,
    PIMDevice,
    PIMStack,
    TRANSFER_BYTES_PER_COMMAND,
    transfer_cycles,
)
from repro_torch.runtime.kvcache import KVCacheManager
from repro_torch.runtime.placement import (
    PLACEMENTS,
    Shard,
    balanced,
    block_2d,
    box_contains,
    cluster_shards,
    get_placement,
    paged,
    placement_shards,
    row_striped,
    shard_mac_passes,
    stack_restricted_shards,
    subset_shards,
    validate_cover,
)
from repro_torch.runtime.residency import (
    BYTES_PER_ELEM,
    KV_BLOCK_TOKENS,
    DeviceTensor,
    PagedTensor,
    box_bytes,
)
from repro_torch.runtime.scheduler import (
    ENGINE_MODES,
    ChannelReport,
    PIMRuntime,
    RuntimeReport,
    pim_gemm,
    pim_gemv,
)
from repro_torch.runtime.timeline import OpHandle, Timeline
from repro_torch.runtime.trace import (
    TraceStats,
    dump_trace,
    emit_trace,
    parse_trace,
    strip_timestamps,
)

__all__ = [
    "HOST_LINK_BANDWIDTH_BYTES_PER_S", "HOST_LINK_BYTES_PER_CYCLE",
    "HostLinkLedger", "PIMCluster", "host_link_cycles",
    "CHANNEL_BANDWIDTH_BYTES_PER_S", "PIMDevice", "PIMStack",
    "TRANSFER_BYTES_PER_COMMAND", "transfer_cycles",
    "PLACEMENTS", "Shard", "balanced", "block_2d", "box_contains",
    "cluster_shards", "get_placement", "paged", "placement_shards",
    "row_striped", "shard_mac_passes", "stack_restricted_shards",
    "subset_shards", "validate_cover",
    "BYTES_PER_ELEM", "KV_BLOCK_TOKENS", "DeviceTensor", "PagedTensor",
    "box_bytes", "KVCacheManager",
    "ENGINE_MODES", "ChannelReport", "PIMRuntime", "RuntimeReport",
    "pim_gemm", "pim_gemv",
    "OpHandle", "Timeline",
    "TraceStats", "dump_trace", "emit_trace", "parse_trace",
    "strip_timestamps",
]
