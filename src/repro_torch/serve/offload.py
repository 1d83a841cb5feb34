"""Decode-path PIM offload: resident-weight GEMV accounting for serving.

The serve loop's decode step is GEMV-heavy (batch is small, weights are
huge) — exactly the regime AMD's balanced-placement work targets and the
regime where PrIM says host<->PIM transfer decides everything.  This
module is the offload sidecar: it mirrors each decode step's matmuls onto
a :class:`~repro_torch.runtime.scheduler.PIMRuntime` whose weights were placed
**once** as resident :class:`~repro_torch.runtime.residency.DeviceTensor`
handles (balanced placement), so the steady-state per-step h2d traffic is
the activation vectors alone — weight re-transfer amortizes to zero after
step 1.

The default sidecar is *accounting-only*: the numeric decode keeps
running through the serve loop's model (weights are shape-only analytic
handles, never materialized — full-scale configs stay placeable), while
every step
yields a :class:`StepRecord` combining the accumulated
:class:`RuntimeReport`s into a PIM-vs-host roofline:

    pim_s  = sum of per-op makespans / PIM_FREQ_HZ      (ops serialize)
    host_s = max(flops / peak_flops, bytes / hbm_bw)    (host roofline)

``numeric=True`` (small configs only) additionally *runs* every decode
matmul on the per-channel engines: weights are materialized (seeded
FP16) and placed resident, each step's activations flow through the
batched engines, and every output — the lm_head logits included — is
cross-checked against an FP32 reference of the same matmul set within
FP16 accumulation tolerance.  The ledgers are identical to the analytic
sidecar's (execute/analytic parity is property-tested), so the roofline
trajectory is unchanged; the numerics close the ROADMAP
"numeric decode-on-PIM" item.

``async_mode=True`` replaces the barrier-per-op accounting with the
runtime's dependency-aware timeline (:mod:`repro_torch.runtime.timeline`):
each decode step is submitted as an op DAG — q/k/v concurrent, attention
output as the join, gate/up concurrent, router before its experts — with
every concurrency group placed on *disjoint channel groups* of the home
stack (per-op launch floors dominate decode-shaped matmuls, so giving
independent ops their own channels beats re-serializing them over the
full width), and :meth:`DecodeOffload.pipeline` wave-pipelines a batch
of independent decode requests: layer blocks on different home stacks
process different requests concurrently.  Serialized mode is the
default and is byte-identical in ledgers and traces to the previous
behavior.

``kv_offload=True`` extends the sidecar past the weight matmuls to the
*whole* attention step: each request's KV cache lives resident in
:data:`~repro_torch.runtime.residency.KV_BLOCK_TOKENS`-token pages
(:class:`~repro_torch.runtime.kvcache.KVCacheManager`), the per-step K/V
append is an in-place resident write (new-token bytes only), and the
score GEMV (``K @ q``), in-place softmax epilogue, and context GEMV
(``V^T @ probs``) run on the layer's home-stack channels under the
``paged`` placement — so steady-state per-step h2d stays independent of
context length.  ``kv_capacity_bytes`` bounds resident KV with paged
LRU eviction (oldest pages of the coldest request; re-ship charged as
``reupload`` link traffic).  Numeric mode cross-checks every head's
attention output against the FP32 reference, evictions and
injected faults included.

``dump`` writes the trajectory as ``results/dryrun/*.pim_offload.json``
so future changes to the cost model have a BENCH baseline to diff.

Port of ``repro.serve.offload``.  The ledgers, step records and traces
are the reference's; the seeded draws (weights, routes, KV, activations)
are its ``numpy`` generators, so both packages see the same values.  In
numeric mode the weights are drawn once, placed resident on the
runtime's device (the card unless the caller passes ``device=``), and
every step's activations live there too; the FP32 references are
``torch.matmul``/``torch.softmax`` in float32 on that device, with TF32
off.  The host roofline prices against the port's H100 descriptor
(:mod:`repro_torch.launch.hw`) unless the caller passes other
``peak_flops``/``hbm_bw`` (the parity tests pass the reference's).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import json
from typing import Dict, Hashable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.isa import PIM_FREQ_HZ
from repro_torch.faults.injector import NoHealthyChannelsError
from repro_torch.launch import hw
from repro_torch.runtime import (
    BYTES_PER_ELEM,
    DeviceTensor,
    KVCacheManager,
    OpHandle,
    PIMRuntime,
)
from repro_torch.serve.traffic import (  # noqa: F401  (re-exported)
    DecodeMatmul,
    RoutingProfile,
    decode_matmuls,
)
from repro_torch.sharding.rules import (
    ExpertPlacement,
    ame_pim_expert_placement,
    ame_pim_stack_map,
)

F16 = np.float16

#: numeric mode materializes every decode weight on the host — refuse
#: configs past this, the regime stays "small config, cross-check"
NUMERIC_MAX_WEIGHT_BYTES = 64 << 20

#: FP32 references, content-addressed: (sha1(weight bytes), batch,
#: device) -> reference output on that device.  Module-level so offload
#: instances over the same seeded weights share entries; weights are
#: immutable after placement and activations are deterministic per
#: (in_dim, batch), so entries never go stale.
_REF_CACHE: Dict[Tuple[bytes, int, str], torch.Tensor] = {}

#: |y_pim - y_fp32| ceiling for the numeric cross-check.  The PIM engines
#: round the accumulator to FP16 per ascending-k step while the reference
#: accumulates in FP32, so the gap is genuine FP16 accumulation error —
#: O(sqrt(k) * 2^-11 * |y|) for the decode shapes, far below this bound.
NUMERIC_ATOL = 0.05


def _fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 with TF32 off: the yardstick the numeric
    cross-checks measure FP16 accumulation error against."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Async step DAG: stages, channel-group splits
# ---------------------------------------------------------------------------

#: dependency level of each matmul family inside one decoder layer —
#: same level = no data dependency (submitted concurrently on disjoint
#: channel groups), levels serialize.  Dense and MoE layers never mix
#: families within one layer, so the shared level numbers are per-layer
#: stage indices, not a global ordering.
_STAGE_OF = {
    "attn.wq": 0, "attn.wk": 0, "attn.wv": 0,     # independent projections
    "attn.wo": 1,                                 # joins q/k/v (attention)
    "mlp.wi": 2, "mlp.wg": 2,                     # gate/up concurrent
    "moe.router": 2,                              # routing decision first
    "mlp.wo": 3,
    "moe.expert.wi": 3, "moe.expert.wg": 3,       # all active experts
    "moe.expert.wo": 4,
}


@dataclasses.dataclass(frozen=True)
class _AsyncOp:
    """One weight matmul instance inside the async step DAG."""

    name: str
    out_dim: int
    in_dim: int
    handle: DeviceTensor
    channels: Tuple[int, ...]     # flat channel ids the op (and its
    #                               weight placement) is pinned to


@functools.lru_cache(maxsize=None)
def _probe_cycles(m: int, k: int, channels: int, placement: str,
                  batch: int = 1) -> float:
    """Makespan of one resident-weight (m, k) @ (k, batch) decode matmul
    on ``channels`` channels — the split-search cost oracle.  A subset
    op's shard geometry equals a ``len(subset)``-channel stack's, so a
    throwaway analytic runtime measures exactly what the subset costs
    (it computes nothing, so it lives on the CPU whatever device the
    offload runs on).
    """
    rt = PIMRuntime(channels=channels, device="cpu")
    h = rt.place((m, k), placement=placement, other_dim=batch)
    _, rep = rt.gemm(h, np.zeros((k, batch), F16), placement=placement,
                     execute=False)
    return rep.makespan_cycles


@functools.lru_cache(maxsize=None)
def _group_split(shapes: Tuple[Tuple[int, int], ...], n_channels: int,
                 placement: str, batch: int = 1) -> Tuple[int, ...]:
    """Channel counts for one concurrency group's ops (sum =
    ``n_channels``, each >= 1).

    Starts proportional to each op's weight volume (largest remainder),
    then greedily moves single channels toward the bottleneck op while
    the group's makespan — max over ops of the probed subset makespan —
    improves.  The probe is exact, so AAM-aligned K-split quantization
    (a 5-channel split may cost the same as 4) is accounted, not
    approximated.  ``batch`` is the decode batch the split is tuned for
    (splits are fixed at weight-placement time; ``DecodeOffload``'s
    ``split_batch=`` chooses the regime, default single-slot decode).
    """
    g = len(shapes)
    assert 1 <= g <= n_channels, (g, n_channels)
    if g == 1:
        return (n_channels,)
    works = [m * k for m, k in shapes]
    tot = sum(works)
    raw = [n_channels * w / tot for w in works]
    alloc = [max(1, int(r)) for r in raw]
    while sum(alloc) > n_channels:      # min-1 clamping may overshoot
        # only donors above the floor: a clamped tiny op (raw < 1) is
        # exactly the entry the overshoot metric favors, and must keep
        # its channel — one exists since sum > n_channels >= g
        i = max((i for i in range(g) if alloc[i] > 1),
                key=lambda i: (alloc[i] - raw[i], alloc[i]))
        alloc[i] -= 1
    order = sorted(range(g), key=lambda i: raw[i] - alloc[i], reverse=True)
    for i in order:                     # largest remainder first
        if sum(alloc) == n_channels:
            break
        alloc[i] += 1
    while sum(alloc) < n_channels:      # g > remainders: round-robin
        alloc[min(range(g), key=lambda i: alloc[i])] += 1

    def times(a):
        return [_probe_cycles(shapes[i][0], shapes[i][1], a[i], placement,
                              batch)
                for i in range(g)]

    cur = times(alloc)
    for _ in range(4 * n_channels):
        best = None
        for i in range(g):              # grow the bottleneck...
            for j in range(g):          # ...at any donor's expense
                if i == j or alloc[j] <= 1:
                    continue
                trial = list(alloc)
                trial[i] += 1
                trial[j] -= 1
                tt = times(trial)
                if max(tt) < max(cur) and \
                        (best is None or max(tt) < max(best[1])):
                    best = (trial, tt)
        if best is None:
            break
        alloc, cur = best[0], best[1]
    return tuple(alloc)


# ---------------------------------------------------------------------------
# Per-step records and the offload sidecar
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepRecord:
    """PIM-vs-host roofline of one decode step."""

    step: int
    batch: int
    pim_cycles: float
    pim_s: float
    h2d_bytes: int              # host->PIM this step (activations at steady)
    d2h_bytes: int
    reuse_bytes: int            # weight traffic avoided by residency
    flops: int
    host_s: float               # host roofline time for the same math
    host_bound: str             # 'memory' | 'compute'
    numeric: bool = False       # matmuls executed on the engines this step
    numeric_max_err: float = 0.0    # max |y_pim - y_fp32| over the step
    logits_max_err: float = 0.0     # same, lm_head output only
    overlapped: bool = False    # async DAG step: pim_cycles is the
    #                             timeline makespan, not a sum of ops
    # -- KV-resident attention (kv_offload=True; all zero otherwise) --
    kv_tokens: int = 0          # total context tokens across requests
    kv_host_bytes: int = 0      # host HBM KV read bytes folded into host_s
    attn_cycles: float = 0.0    # PIM cycles in attention ops (append +
    #                             score + softmax + context; serialized
    #                             sum — async overlaps them in pim_cycles)
    attn_max_err: float = 0.0   # max |attn_pim - attn_fp32| this step

    @property
    def pim_vs_host(self) -> float:
        """host_s / pim_s — >1 means PIM wins the roofline."""
        return self.host_s / self.pim_s if self.pim_s else 0.0

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["pim_vs_host"] = self.pim_vs_host
        return d


def _rid_key(rid: Hashable) -> int:
    """Stable 32-bit key of a request id for seeded KV draws (``hash``
    is process-randomized for strings)."""
    return int.from_bytes(
        hashlib.sha1(str(rid).encode()).digest()[:4], "big")


class DecodeOffload:
    """Sidecar: one serve loop's decode path on resident PIM.

    Weights are placed once at construction with the given placement;
    :meth:`step` replays one decode step's matmuls through the runtime
    and records the roofline.  Attach to a
    :class:`repro_torch.serve.loop.Server`
    via its ``pim_offload`` argument, or drive it directly (the residency
    benchmark sweep does).

    Default mode is accounting-only (analytic, shape-only handles).  With
    ``numeric=True`` the weights are materialized (seeded FP16) and every
    step's matmuls — activations included — execute on the per-channel
    engines, cross-checked element-wise against an FP32 reference
    (:func:`_fp32_matmul`); the lm_head output is the step's logits and
    its deviation is tracked separately (``logits_max_err``).  Small
    configs only (:data:`NUMERIC_MAX_WEIGHT_BYTES`).

    ``stacks > 1`` runs the sidecar on a multi-stack
    :class:`~repro_torch.runtime.cluster.PIMCluster`: every weight instance is
    homed on its *layer's* stack per the ``ame_pim`` layers map
    (:func:`~repro_torch.sharding.rules.ame_pim_stack_map` — contiguous layer
    blocks, one layer's attention/MLP/experts/router together, lm_head
    with the last layer), weights are placed on their home stack only, and
    every step's matmuls run stack-restricted — so per-stack capacity,
    upload distribution, and the host-link ledger all scale past one
    stack while numerics and per-op ledgers stay those of a
    ``channels``-wide decomposition.

    ``async_mode=True`` switches the runtime to the dependency-aware
    timeline and each step to an op DAG: independent matmuls of one
    layer (q/k/v; gate/up; a routing level's experts) are placed on
    disjoint channel groups of their home stack (:func:`_group_split`)
    and submitted concurrently; dependent levels chain with ``after=``
    edges.  ``pim_cycles`` then reports the step's *timeline makespan*
    (``StepRecord.overlapped``), and :meth:`pipeline` wave-pipelines a
    batch of independent single-slot decode requests across the layer
    blocks' home stacks.

    ``kv_offload=True`` adds the attention step itself: per request
    (ids via ``step(batch, request_ids=...)``; :meth:`kv_prefill` /
    :meth:`kv_release` bracket the serve-loop lifecycle), each layer's
    K/V append lands as an in-place resident page write and every kv
    head runs score GEMV -> softmax -> context GEMV on the layer's
    home-stack channels under the ``paged`` placement.  Only the new
    token's KV bytes and the q vectors cross the bus per step — the
    resident prefix re-ships **zero** bytes, so per-step h2d is flat in
    context length (the context GEMV's K-split partials still drain
    d2h for the host reduction; that is the one context-proportional
    stream, and it is output-sized, not cache-sized).
    ``kv_capacity_bytes`` bounds resident KV via
    :class:`~repro_torch.runtime.kvcache.KVCacheManager` paged eviction.

    Reproducibility: weights *and* per-step activations derive
    deterministically from the constructor's ``seed=`` (activations from
    per-``(in_dim, batch)`` child generators, so their values do not
    depend on draw order or weight count) — repeated offload runs in one
    process see identical data, and the FP32 reference of each
    numeric matmul is cached per ``(weight, batch)`` key instead of
    recomputed every step.  The deliberate trade: numeric steps of one
    run now repeat the same accumulation pattern per (shape, batch)
    instead of drawing fresh values per step — vary ``seed=`` (or
    ``batch``) across runs to exercise different patterns.

    ``device`` is where the runtime's engines compute and the numeric
    mode's weights, activations and FP32 references live (the card by
    default).  ``peak_flops``/``hbm_bw`` price ``StepRecord.host_s``
    (default: the port's H100 descriptor).
    """

    def __init__(self, cfg: ArchConfig, *, channels: int = 16,
                 stacks: int = 1,
                 placement: str = "balanced", numeric: bool = False,
                 seed: int = 0, atol: float = NUMERIC_ATOL,
                 engine: str = "batched", async_mode: bool = False,
                 split_batch: int = 1, metrics=None, faults=None,
                 kv_offload: bool = False,
                 kv_capacity_bytes: Optional[int] = None,
                 routing: Optional[RoutingProfile] = None,
                 replicate_experts: int = 0,
                 expert_placement: str = "greedy",
                 migrate_threshold: Optional[float] = None,
                 migrate_min_tokens: int = 256,
                 link_topology: str = "shared", device=None,
                 peak_flops: Optional[float] = None,
                 hbm_bw: Optional[float] = None):
        self.cfg = cfg
        self.peak_flops = float(peak_flops if peak_flops is not None
                                else hw.PEAK_FLOPS)
        self.hbm_bw = float(hbm_bw if hbm_bw is not None else hw.HBM_BW)
        self.placement = placement
        self.numeric = numeric
        self.atol = atol
        self.stacks = stacks
        self.seed = seed
        self.async_mode = async_mode
        # -- routed-MoE expert parallelism (strictly additive when off:
        # routing=None leaves every code path below byte-identical) --
        self.routing = routing
        self.replicate_experts = replicate_experts
        self.expert_policy = expert_placement
        self.migrate_threshold = migrate_threshold
        self.migrate_min_tokens = migrate_min_tokens
        if routing is not None:
            if cfg.moe is None:
                raise ValueError(
                    "routing= models per-expert dispatch and requires an "
                    f"MoE config, not {cfg.name!r}")
            if async_mode or numeric:
                raise ValueError(
                    "routed-MoE dispatch is serialized accounting-only; "
                    "async_mode=/numeric= are unsupported with routing=")
            n_moe = cfg.n_layers - cfg.moe.first_dense_layers
            if (routing.n_layers, routing.n_experts) != \
                    (n_moe, cfg.moe.num_experts):
                raise ValueError(
                    f"routing profile is {routing.n_layers}x"
                    f"{routing.n_experts}; {cfg.name} has {n_moe} MoE "
                    f"layers x {cfg.moe.num_experts} experts")
        # repro_torch.obs registry shared down into the runtime (per-op and
        # host-link streams land in the same registry as the per-step
        # offload.* metrics below); None = zero observability overhead
        self.metrics = metrics
        # the decode batch the async channel-group splits are tuned for
        # (splits are fixed at weight-placement time — weights live on
        # their groups — so pick the serving regime here, not per step)
        self._split_batch = split_batch
        self.rt = PIMRuntime(channels=channels, stacks=stacks,
                             engine=engine, async_mode=async_mode,
                             link_topology=link_topology,
                             metrics=metrics, faults=faults, device=device)
        self.matmuls = decode_matmuls(cfg)
        if numeric and self.weight_bytes > NUMERIC_MAX_WEIGHT_BYTES:
            raise ValueError(
                f"numeric decode offload materializes every weight; "
                f"{self.weight_bytes} bytes exceeds the small-config cap "
                f"{NUMERIC_MAX_WEIGHT_BYTES} — use a cfg.reduced()")
        rng = np.random.default_rng(seed)
        # (matmul, [(home stack or None, handle), ...]) — every instance
        # homed on its *layer's* stack (ame_pim layers map), so one
        # layer's attention, MLP/expert, and router weights share a stack
        # and the hidden-state hand-off between them never crosses it
        layer_stacks = ame_pim_stack_map(cfg, stacks)["layers"] \
            if stacks > 1 else None
        # live per-layer home map (failover remaps dead stacks' entries)
        self.stack_map: Optional[List[int]] = \
            list(layer_stacks) if layer_stacks is not None else None
        self.weights: List[Tuple[DecodeMatmul,
                                 List[Tuple[Optional[int],
                                            DeviceTensor]]]] = []
        #: async step DAG: consecutive stages chain, ops within a stage
        #: run concurrently on their disjoint channel groups
        self._stages: List[List[_AsyncOp]] = []
        self._step_tail: Optional[List[OpHandle]] = None
        if async_mode:
            self._build_async_plan(rng, layer_stacks)
        else:
            for m in self.matmuls:
                if routing is not None and \
                        m.name.startswith("moe.expert."):
                    # routed mode homes expert weights per the skew-
                    # driven placement (the bank below), not per-layer
                    self.weights.append((m, []))
                    continue
                homes = [layer_stacks[ell]
                         for ell in self._family_layers(m)] \
                    if stacks > 1 else [None] * m.count
                handles = []
                for home in homes:
                    handles.append((home, self.rt.place(
                        self._draw_weight(rng, m), placement=placement,
                        stack=home)))
                self.weights.append((m, handles))
        # -- routed-MoE expert bank / dispatch state ----------------------
        #: [moe_layer][expert] -> [(home stack, (wi, wg?, wo) handles)],
        #: primary home first (the ExpertPlacement homes order)
        self.expert_bank: List[List[List[
            Tuple[Optional[int], Tuple[DeviceTensor, ...]]]]] = []
        #: [moe_layer] -> shared-expert handles on the layer's home stack
        self.shared_bank: List[List[
            Tuple[Optional[int], Tuple[DeviceTensor, ...]]]] = []
        self._placement: Optional[ExpertPlacement] = None
        self._placement_profile: Optional[RoutingProfile] = None
        #: per-layer expert-selection histogram observed since the last
        #: placement (what drift-triggered migration compares against)
        self.observed: Optional[RoutingProfile] = None
        self._route_rng = None
        self.tokens_per_stack: List[int] = [0] * stacks
        self.moe_counters: Dict[str, int] = {
            "routed_tokens": 0, "replica_hits": 0, "migrations": 0}
        if routing is not None:
            self._placement = ame_pim_expert_placement(
                routing, stacks, replicate=replicate_experts,
                policy=expert_placement)
            self._placement_profile = routing.copy()
            self.observed = RoutingProfile.empty(
                routing.n_layers, routing.n_experts)
            self._route_rng = np.random.default_rng((seed, 32452867))
            self._build_expert_bank()
        self.upload_bytes = sum(d.xfer.h2d_bytes for d in self.rt.stack)
        self.upload_bytes_per_stack: Optional[List[int]] = None
        if stacks > 1:
            self.upload_bytes_per_stack = [
                sum(d.xfer.h2d_bytes for d in stk)
                for stk in self.rt.stack.stacks]
        self.steps: List[StepRecord] = []
        self.last_logits: Optional[torch.Tensor] = None   # numeric mode
        self._act_cache: Dict[Tuple[int, int], object] = {}
        self._ref_keys: Dict[int, bytes] = {}    # weight uid -> content key
        # -- KV-resident attention (strictly additive when off) --
        self.kv: Optional[KVCacheManager] = None
        self._kv_group = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
        if kv_offload:
            self.kv = KVCacheManager(
                self.rt, n_layers=cfg.n_layers,
                n_kv_heads=max(1, cfg.n_kv_heads),
                head_dim=cfg.head_dim_,
                channels_for_layer=self._kv_channels,
                capacity_bytes=kv_capacity_bytes,
                numeric=numeric, metrics=metrics)

    def _draw_weight(self, rng, m: DecodeMatmul):
        """Weight payload for one instance of family ``m``: seeded FP16
        values in numeric mode (drawn on the host once; placing them
        moves them to the runtime's device), a shape-only analytic
        handle spec otherwise."""
        if self.numeric:
            return (rng.standard_normal((m.out_dim, m.in_dim))
                    * 0.05).astype(F16)
        return (m.out_dim, m.in_dim)

    def _stack_channels(self, home: Optional[int]) -> Tuple[int, ...]:
        """Flat channel ids of one home stack (all channels on 1 stack)."""
        if home is None:
            return tuple(range(len(self.rt.stack)))
        cps = self.rt.stack.channels_per_stack
        return tuple(range(home * cps, (home + 1) * cps))

    # -- routed-MoE expert parallelism (routing=) ----------------------------

    def _expert_specs(self) -> List[Tuple[str, int, int]]:
        """(name, out_dim, in_dim) of one routed expert's matmuls."""
        moe, d = self.cfg.moe, self.cfg.d_model
        specs = [("moe.expert.wi", moe.d_ff_expert, d)]
        if self.cfg.act in ("swiglu", "geglu"):
            specs.append(("moe.expert.wg", moe.d_ff_expert, d))
        specs.append(("moe.expert.wo", d, moe.d_ff_expert))
        return specs

    @property
    def expert_bytes(self) -> int:
        """FP16 bytes of one expert's weights (a migration's payload)."""
        return sum(o * i for _, o, i in self._expert_specs()) \
            * BYTES_PER_ELEM

    def _home_arg(self, home: Optional[int]) -> Optional[int]:
        """The ``stack=`` argument for a placement home (single-stack
        runtimes take None — there is no stack axis to restrict to)."""
        return home if self.stacks > 1 else None

    def _place_expert(self, home: Optional[int],
                      specs: Sequence[Tuple[str, int, int]]
                      ) -> Tuple[DeviceTensor, ...]:
        """Place one expert's weight set resident on ``home``."""
        return tuple(self.rt.place((o, i), placement=self.placement,
                                   stack=self._home_arg(home))
                     for _, o, i in specs)

    def _build_expert_bank(self) -> None:
        """Place every routed expert (replicas included) on its
        :class:`~repro_torch.sharding.rules.ExpertPlacement` homes, and the
        shared experts on their layer's home stack."""
        moe = self.cfg.moe
        fd = moe.first_dense_layers
        specs = self._expert_specs()
        for li, homes_row in enumerate(self._placement.homes):
            self.expert_bank.append(
                [[(h, self._place_expert(h, specs)) for h in homes]
                 for homes in homes_row])
            layer_home = self.stack_map[fd + li] \
                if self.stack_map is not None else None
            self.shared_bank.append(
                [(layer_home, self._place_expert(layer_home, specs))
                 for _ in range(moe.n_shared)])

    def set_routing(self, profile: RoutingProfile) -> None:
        """Swap the live routing distribution (traffic drift) without
        re-placing: subsequent steps sample from ``profile``, the
        observed histogram drifts away from the placement's, and —
        with ``migrate_threshold=`` set — :meth:`_maybe_migrate`
        eventually re-places from the observed counts."""
        if self.routing is None:
            raise ValueError("set_routing requires a routed offload "
                             "(construct with routing=)")
        if (profile.n_layers, profile.n_experts) != \
                (self.routing.n_layers, self.routing.n_experts):
            raise ValueError(
                f"profile shape {profile.n_layers}x{profile.n_experts} "
                f"!= {self.routing.n_layers}x{self.routing.n_experts}")
        self.routing = profile

    def _sample_routes(self, li: int, batch: int
                       ) -> List[Tuple[int, ...]]:
        """Per-token expert selections for MoE layer ``li``: ``top_k``
        distinct experts drawn from the live routing distribution.
        Seeded at construction, so the route stream is a pure function
        of (seed, step sequence)."""
        probs = np.asarray(self.routing.probs(li), dtype=np.float64)
        k = self.cfg.moe.top_k
        if np.count_nonzero(probs) < k:
            # degenerate histogram (fewer active experts than top_k):
            # Laplace-smooth so replace=False stays drawable
            probs = probs + 1.0 / probs.size
        probs = probs / probs.sum()
        return [tuple(int(e) for e in self._route_rng.choice(
                    probs.size, size=k, replace=False, p=probs))
                for _ in range(batch)]

    def _routed_moe_step(self, batch: int) -> Tuple[float, int, int]:
        """One decode step's routed expert sub-step.

        Per MoE layer: sample each token's ``top_k`` experts, group the
        tokens by expert, send each group to its expert's home stack —
        a replicated expert's tokens split one-by-one to the
        least-loaded home (by tokens assigned this layer) — and run the
        expert GEMVs stack-restricted.  Stacks work *in parallel* within
        a layer (expert parallelism), so the layer's cycle cost is the
        max over stacks of their summed op makespans; layers serialize.
        Cross-stack activation movement (tokens whose expert lives off
        the layer's home stack) is charged on the host link as
        ``xstack`` traffic — under ``link_topology="switched"`` the
        hidden-state block leaves the source stack's link *once* and the
        switch multicasts it, instead of once per destination.

        Returns ``(cycles, flops, act_bytes)`` for the step record.
        """
        cfg, moe = self.cfg, self.cfg.moe
        fd = moe.first_dense_layers
        d_model = cfg.d_model
        specs = self._expert_specs()
        total_cycles = 0.0
        flops = 0
        act_bytes = 0
        routed = hits = 0
        for li in range(self.routing.n_layers):
            layer_home = self.stack_map[fd + li] \
                if self.stack_map is not None else None
            groups: Dict[int, List[int]] = {}
            for t, experts in enumerate(self._sample_routes(li, batch)):
                for e in experts:
                    groups.setdefault(e, []).append(t)
            counts = {e: len(ts) for e, ts in groups.items()}
            # two-pass dispatch: single-home experts are fixed load, so
            # land them first; replicated experts' tokens then valley-
            # fill, one by one, onto the least-loaded replica home
            # (largest group first — the hottest expert has the most
            # freedom to level the stacks)
            load: collections.Counter = collections.Counter()
            assign: Dict[Tuple[int, Optional[int]],
                         Tuple[Tuple[DeviceTensor, ...], List[int]]] = {}

            def _put(e: int, home: Optional[int], t: int) -> None:
                load[home] += 1
                entry = assign.get((e, home))
                if entry is None:
                    entry = assign[(e, home)] = (
                        next(hs for h, hs in self.expert_bank[li][e]
                             if h == home), [])
                entry[1].append(t)

            flex: List[Tuple[int, List[int]]] = []
            for e in sorted(groups):
                bank = self.expert_bank[li][e]
                if len(bank) == 1:
                    for t in groups[e]:
                        _put(e, bank[0][0], t)
                else:
                    flex.append((e, groups[e]))
            # fewest-homes first: the widest-replicated (hottest) group
            # dispatches last, when it has full sight of the valleys
            for e, toks in sorted(
                    flex, key=lambda et: (len(self.expert_bank[li][et[0]]),
                                          -len(et[1]), et[0])):
                bank = self.expert_bank[li][e]
                for t in toks:
                    home = min((h for h, _ in bank),
                               key=lambda h: (load[h], h))
                    if home != bank[0][0]:
                        hits += 1
                    _put(e, home, t)
            self.observed.record_counts(li, counts)
            routed += sum(counts.values())
            stack_cycles: collections.Counter = collections.Counter()
            for (e, home), (handles, toks) in sorted(assign.items()):
                nt = len(toks)
                for (_, _, in_dim), h in zip(specs, handles):
                    x = self._activation(in_dim, nt)
                    _, rep = self.rt.gemm(h, x, placement=self.placement,
                                          execute=False,
                                          stack=self._home_arg(home))
                    stack_cycles[home] += rep.makespan_cycles
                    flops += rep.total_flops
                    act_bytes += in_dim * nt * BYTES_PER_ELEM
                self.tokens_per_stack[home or 0] += nt
            # shared experts run every token on the layer's home stack
            for home, handles in self.shared_bank[li]:
                for (_, _, in_dim), h in zip(specs, handles):
                    x = self._activation(in_dim, batch)
                    _, rep = self.rt.gemm(h, x, placement=self.placement,
                                          execute=False,
                                          stack=self._home_arg(home))
                    stack_cycles[home] += rep.makespan_cycles
                    flops += rep.total_flops
                    act_bytes += in_dim * batch * BYTES_PER_ELEM
            if self.stacks > 1:
                dest_tokens: Dict[int, Set[int]] = {}
                for (e, home), (_, toks) in assign.items():
                    if home != layer_home:
                        dest_tokens.setdefault(home, set()).update(toks)
                if dest_tokens:
                    cluster = self.rt.stack
                    if cluster.links is not None:
                        # multicast: the hidden-state block is read out
                        # of the source stack's link once; the switch
                        # fans it out to every destination
                        union: Set[int] = set()
                        for s in dest_tokens.values():
                            union |= s
                        cluster.link_for(layer_home).charge(
                            "xstack",
                            d_model * len(union) * BYTES_PER_ELEM)
                    else:
                        for dst in sorted(dest_tokens):
                            cluster.link.charge(
                                "xstack", d_model * len(dest_tokens[dst])
                                * BYTES_PER_ELEM)
            total_cycles += max(stack_cycles.values(), default=0.0)
        self.moe_counters["routed_tokens"] += routed
        self.moe_counters["replica_hits"] += hits
        if self.metrics is not None:
            m = self.metrics
            m.counter("moe.routed_tokens", unit="tokens",
                      help="expert-token assignments dispatched by the "
                           "routed-MoE layer").inc(routed)
            m.counter("moe.replica_hits", unit="tokens",
                      help="routed tokens served by a non-primary "
                           "expert replica").inc(hits)
            for s, v in enumerate(self.tokens_per_stack):
                m.gauge(f"moe.tokens_stack{s}", unit="tokens",
                        help="cumulative routed expert-tokens "
                             "dispatched to this stack").set(v)
        return total_cycles, flops, act_bytes

    def _maybe_migrate(self) -> None:
        """Step-boundary expert migration: when the observed routing
        histogram has drifted past ``migrate_threshold`` (total-
        variation distance, max over layers) from the profile the
        current placement was computed from, re-place from the observed
        counts.  Experts whose home set changed get their weights placed
        on the added homes (charged as ``reupload`` on the destination
        stack's link, marked ``# MIGRATE`` in the trace) and evicted
        from the removed ones; unchanged homes keep their resident
        handles — no traffic."""
        if self.routing is None or self.migrate_threshold is None:
            return
        if self.observed.total_tokens < self.migrate_min_tokens:
            return
        if self.observed.drift(self._placement_profile) \
                <= self.migrate_threshold:
            return
        new = ame_pim_expert_placement(
            self.observed, self.stacks, replicate=self.replicate_experts,
            policy=self.expert_policy)
        specs = self._expert_specs()
        ebytes = self.expert_bytes
        fd = self.cfg.moe.first_dense_layers
        cluster = self.rt._cluster
        moved = 0
        for li, row in enumerate(new.homes):
            for e, homes in enumerate(row):
                old = self.expert_bank[li][e]
                if list(homes) == [h for h, _ in old]:
                    continue
                src = old[0][0]
                keep = dict(old)
                bank = []
                for h in homes:
                    if h in keep:
                        bank.append((h, keep.pop(h)))
                        continue
                    bank.append((h, self._place_expert(h, specs)))
                    moved += 1
                    if cluster is not None:
                        cluster.link_for(h).charge("reupload", ebytes)
                        dev = cluster.device(h, 0)
                    else:
                        dev = self.rt.stack.devices[0]
                    dev.events.append(
                        ("migrate", (fd + li, e, src or 0, h or 0,
                                     ebytes)))
                for handles in keep.values():
                    for h2 in handles:
                        h2.evict()
                self.expert_bank[li][e] = bank
        self._placement = new
        self._placement_profile = self.observed.copy()
        self.observed = RoutingProfile.empty(
            self.observed.n_layers, self.observed.n_experts)
        if moved:
            self.moe_counters["migrations"] += moved
            if self.metrics is not None:
                self.metrics.counter(
                    "moe.migrations", unit="experts",
                    help="expert replica homes moved by drift-triggered "
                         "re-placement").inc(moved)

    @property
    def replica_hit_rate(self) -> float:
        """Fraction of routed tokens a non-primary replica absorbed."""
        tot = self.moe_counters["routed_tokens"]
        return self.moe_counters["replica_hits"] / tot if tot else 0.0

    def moe_summary(self) -> Dict:
        """Routed-MoE dispatch summary (the bench-facing view)."""
        toks = self.tokens_per_stack
        mean = sum(toks) / len(toks) if toks else 0.0
        return {
            "policy": self.expert_policy,
            "replicate": self.replicate_experts,
            "stacks": self.stacks,
            "routed_tokens": self.moe_counters["routed_tokens"],
            "replica_hits": self.moe_counters["replica_hits"],
            "replica_hit_rate": self.replica_hit_rate,
            "migrations": self.moe_counters["migrations"],
            "tokens_per_stack": list(toks),
            "observed_max_over_mean":
                (max(toks) / mean) if mean else 1.0,
            "placement_max_over_mean": self._placement.max_over_mean,
            "placement_worst_layer_max_over_mean":
                self._placement.worst_layer_max_over_mean,
        }

    # -- KV-resident attention (kv_offload=True) -----------------------------

    def _kv_channels(self, layer: int) -> Tuple[int, ...]:
        """Channels one layer's KV pages cycle over — its home stack,
        minus fail-stopped channels (so page owners keep coinciding
        with the healthy subset the attention GEMVs decompose on)."""
        home = self.stack_map[layer] if self.stack_map is not None \
            else None
        chans = self._stack_channels(home)
        inj = self.rt.faults
        if inj is not None and inj.failed:
            alive = tuple(c for c in chans if c not in inj.failed)
            if alive:
                return alive
        return chans

    def _kv_draw(self, tag: int, rid: Hashable, layer: int, head: int,
                 t0: int, shape: Tuple[int, int]) -> torch.Tensor:
        """Seeded FP16 payload for one request's K/V/q draw, keyed by
        the token offset it lands at — deterministic per request and
        position regardless of admission or step order.  Drawn with the
        reference's generator, returned on the runtime's device."""
        rng = np.random.default_rng(
            (self.seed, tag, _rid_key(rid), layer, head, t0))
        return torch.from_numpy(
            (rng.standard_normal(shape) * 0.05).astype(F16)).to(
            self.rt.device)

    def _on_device(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` if it lives on the runtime's device; raises otherwise
        (no check ever falls back to another device)."""
        if t.device != self.rt.device:
            raise RuntimeError(f"numeric offload tensor on {t.device}, the "
                               f"runtime on {self.rt.device}")
        return t

    def _check_attention(self, K: DeviceTensor, VT: DeviceTensor,
                         q: torch.Tensor, y) -> float:
        """Cross-check one head's attention-on-PIM output against the
        FP32 reference ``V^T @ softmax(K @ q)`` over the request's full
        context (evicted-and-restored pages included — the mirrors are
        exact), on the runtime's device."""
        probs = torch.softmax(
            _fp32_matmul(self._on_device(K.values), q), dim=0)
        ref = _fp32_matmul(self._on_device(VT.values), probs)
        err = float((self._on_device(y).float() - ref).abs().max())
        assert err < self.atol, \
            ("attention", err, "attention-on-PIM diverged from the FP32 "
             "reference beyond FP16 accumulation tolerance")
        return err

    def kv_prefill(self, rid: Hashable, tokens: int,
                   after: Optional[Sequence[OpHandle]] = None):
        """Admit request ``rid`` with ``tokens`` prompt tokens: the host
        prefill produced their KV, so every layer's pages ship in once
        (h2d, ``# KVAPPEND``-marked) and decode steps grow from there.
        Returns the last append's timeline handle on async runtimes."""
        if self.kv is None:
            raise ValueError("kv_prefill requires kv_offload=True")
        if tokens <= 0:
            raise ValueError(f"prefill needs >= 1 token, got {tokens}")
        hd, heads = self.cfg.head_dim_, self.kv.n_kv_heads
        self.kv.request(rid)
        t0 = self.kv.tokens(rid)
        handle = after
        for ell in range(self.cfg.n_layers):
            k_vals = v_vals = None
            if self.numeric:
                k_vals = [self._kv_draw(11, rid, ell, j, t0, (tokens, hd))
                          for j in range(heads)]
                v_vals = [self._kv_draw(13, rid, ell, j, t0, (hd, tokens))
                          for j in range(heads)]
            handle = self.kv.append_tokens(rid, ell, tokens,
                                           k_vals, v_vals, after=handle)
        return handle

    def kv_release(self, rid: Hashable) -> int:
        """Drop a retired (or knocked-out) request's KV; returns the
        resident bytes freed.  No-op without ``kv_offload``."""
        return self.kv.release(rid) if self.kv is not None else 0

    def _attention_serialized(self, rid: Hashable
                              ) -> Tuple[float, int, float]:
        """One request's full attention step, barrier-per-op: per layer,
        append the new token's K/V in place, then per kv head run the
        score GEMV (kept resident), the in-place softmax epilogue, and
        the context GEMV on the layer's home channels.  Returns
        ``(cycles, flops, max_err)``."""
        cfg, kv = self.cfg, self.kv
        hd, heads, group = cfg.head_dim_, kv.n_kv_heads, self._kv_group
        kv.begin_decode(rid)        # restores evicted pages first
        t0 = kv.tokens(rid)
        cycles, flops, max_err = 0.0, 0, 0.0
        for ell in range(cfg.n_layers):
            chans = self._kv_channels(ell)
            k_vals = v_vals = None
            if self.numeric:
                k_vals = [self._kv_draw(11, rid, ell, j, t0, (1, hd))
                          for j in range(heads)]
                v_vals = [self._kv_draw(13, rid, ell, j, t0, (hd, 1))
                          for j in range(heads)]
            kv.append_tokens(rid, ell, 1, k_vals, v_vals)
            for j in range(heads):
                K, VT = kv.tensors(rid, ell, j)
                q = self._kv_draw(17, rid, ell, j, t0, (hd, group)) \
                    if self.numeric else np.zeros((hd, group), F16)
                scores, rep = self.rt.gemm(
                    K, q, placement="paged", keep_output=True,
                    execute=self.numeric, channels=chans)
                cycles += rep.makespan_cycles
                flops += rep.total_flops
                _, rep = self.rt.softmax(scores, placement="paged",
                                         execute=self.numeric,
                                         channels=chans)
                cycles += rep.makespan_cycles
                flops += rep.total_flops
                y, rep = self.rt.gemm(
                    VT, scores, placement="paged",
                    execute=self.numeric, channels=chans)
                cycles += rep.makespan_cycles
                flops += rep.total_flops
                if self.numeric:
                    max_err = max(max_err,
                                  self._check_attention(K, VT, q, y))
                scores.evict()
        return cycles, flops, max_err

    def _attention_async(self, rid: Hashable, ell: int, t0: int,
                         after: Optional[Sequence[OpHandle]]
                         ) -> Tuple[List[OpHandle], float, int, float]:
        """One request's attention DAG for layer ``ell``: the K/V append
        waits on the layer's q/k/v projections (``after``), each head
        chains score -> softmax -> context through residency deps, and
        the returned context handles gate the layer's ``attn.wo``.
        Returns ``(handles, cycles, flops, max_err)`` (cycles = summed
        op makespans; the timeline overlaps them across heads)."""
        cfg, kv = self.cfg, self.kv
        hd, heads, group = cfg.head_dim_, kv.n_kv_heads, self._kv_group
        chans = self._kv_channels(ell)
        k_vals = v_vals = None
        if self.numeric:
            k_vals = [self._kv_draw(11, rid, ell, j, t0, (1, hd))
                      for j in range(heads)]
            v_vals = [self._kv_draw(13, rid, ell, j, t0, (hd, 1))
                      for j in range(heads)]
        kv.append_tokens(rid, ell, 1, k_vals, v_vals, after=after)
        out: List[OpHandle] = []
        cycles, flops, max_err = 0.0, 0, 0.0
        for j in range(heads):
            K, VT = kv.tensors(rid, ell, j)
            q = self._kv_draw(17, rid, ell, j, t0, (hd, group)) \
                if self.numeric else np.zeros((hd, group), F16)
            f_score = self.rt.gemm(
                K, q, placement="paged", keep_output=True,
                execute=self.numeric, channels=chans, after=after)
            scores = f_score.result
            f_sm = self.rt.softmax(scores, placement="paged",
                                   execute=self.numeric, channels=chans)
            f_ctx = self.rt.gemm(
                VT, scores, placement="paged",
                execute=self.numeric, channels=chans)
            for f in (f_score, f_sm, f_ctx):
                cycles += f.report.makespan_cycles
                flops += f.report.total_flops
            if self.numeric:
                max_err = max(max_err,
                              self._check_attention(K, VT, q,
                                                    f_ctx.result))
            scores.evict()
            f_score.result = f_sm.result = f_ctx.result = None
            out.append(f_ctx)
        return out, cycles, flops, max_err

    def _build_async_plan(self, rng, layer_stacks: Optional[List[int]]
                          ) -> None:
        """Construct the per-layer stage DAG and place every weight on
        its op's channel group.

        Weight draw order is per layer (stage construction order), not
        per family — values still derive only from ``seed``.  Groups
        wider than the home stack's channel count split into serial
        waves so every op keeps >= 1 channel.
        """
        # group each family's instances by decoder layer
        per_layer: List[List[Tuple[int, DecodeMatmul]]] = \
            [[] for _ in range(self.cfg.n_layers)]
        lm_head: Optional[DecodeMatmul] = None
        fam_handles: Dict[str, List[Tuple[Optional[int], DeviceTensor]]] \
            = {m.name: [] for m in self.matmuls}
        for m in self.matmuls:
            if m.name == "lm_head":
                lm_head = m
                continue
            for ell in self._family_layers(m):
                per_layer[ell].append((_STAGE_OF[m.name], m))
        for ell, ops in enumerate(per_layer):
            home = layer_stacks[ell] if layer_stacks is not None else None
            chans = self._stack_channels(home)
            by_stage: Dict[int, List[DecodeMatmul]] = {}
            for lvl, m in ops:
                by_stage.setdefault(lvl, []).append(m)
            for lvl in sorted(by_stage):
                group = by_stage[lvl]
                # serial waves when a level is wider than the stack
                for w0 in range(0, len(group), len(chans)):
                    wave = group[w0:w0 + len(chans)]
                    split = _group_split(
                        tuple((m.out_dim, m.in_dim) for m in wave),
                        len(chans), self.placement, self._split_batch)
                    stage, c0 = [], 0
                    for m, nch in zip(wave, split):
                        sub = chans[c0:c0 + nch]
                        c0 += nch
                        h = self.rt.place(self._draw_weight(rng, m),
                                          placement=self.placement,
                                          channels=sub)
                        fam_handles[m.name].append((home, h))
                        stage.append(_AsyncOp(m.name, m.out_dim, m.in_dim,
                                              h, sub))
                    self._stages.append(stage)
        assert lm_head is not None
        home = layer_stacks[-1] if layer_stacks is not None else None
        chans = self._stack_channels(home)
        h = self.rt.place(self._draw_weight(rng, lm_head),
                          placement=self.placement, channels=chans)
        fam_handles[lm_head.name].append((home, h))
        self._stages.append([_AsyncOp(lm_head.name, lm_head.out_dim,
                                      lm_head.in_dim, h, chans)])
        self.weights = [(m, fam_handles[m.name]) for m in self.matmuls]

    def _family_layers(self, m: DecodeMatmul) -> List[int]:
        """Decoder-layer index of each instance of one matmul family —
        the key the ame_pim layers map is consulted with, so instance
        counts that collapse layer x expert still land each weight on
        its layer's home stack.  lm_head follows the last layer (that is
        where its input activation lives)."""
        cfg = self.cfg
        if m.name == "lm_head":
            return [cfg.n_layers - 1]
        if m.name.startswith("moe."):
            fd = cfg.moe.first_dense_layers
            if m.name == "moe.router":
                return [fd + i for i in range(m.count)]
            active = cfg.moe.top_k + cfg.moe.n_shared
            return [fd + i // active for i in range(m.count)]
        # attn.* spans all layers; mlp.* spans all dense layers (= the
        # leading first_dense_layers block under MoE) — both from 0
        return list(range(m.count))

    @property
    def weight_bytes(self) -> int:
        """FP16 bytes of all decode weights (the host-side HBM read/step)."""
        return sum(m.weight_bytes for m in self.matmuls)

    def _activation(self, in_dim: int, batch: int):
        """The (in_dim, batch) activation block for this shape.

        Analytic mode re-uses one host zeros buffer per shape (shapes are
        all the gemm reads); numeric mode draws seeded values from a
        child generator keyed by ``(seed, in_dim, batch)`` — deterministic
        regardless of draw order, weight count, or step index, so
        repeated offload runs in one process are reproducible and the
        FP32 reference per ``(weight, batch)`` can be cached — and keeps
        them on the runtime's device.  Matmuls sharing ``in_dim`` within a
        step share the block, like the decode hidden state feeding every
        projection.
        """
        key = (in_dim, batch)
        x = self._act_cache.get(key)
        if x is None:
            if self.numeric:
                rng = np.random.default_rng((self.seed, 7, in_dim, batch))
                x = torch.from_numpy(
                    (rng.standard_normal(key) * 0.05).astype(F16)).to(
                    self.rt.device)
            else:
                x = np.zeros(key, F16)
            self._act_cache[key] = x
        return x

    def _reference(self, h: DeviceTensor, x: torch.Tensor,
                   batch: int) -> torch.Tensor:
        """Cached FP32 reference of ``h.values @ x`` on the runtime's
        device: the FP32 matmul of the FP16 operands, like
        ``decode_step``'s compute-dtype path.

        Activations are deterministic per ``(in_dim, batch)`` and
        weights never change after placement, so one reference per
        ``(weight, batch)`` key serves every step — the per-step
        recompute used to burn the numeric steps' wall clock for no
        information.  The key is content-addressed (weight bytes), so
        offload instances over the same seeded weights — e.g. the
        engine bench's tiled-vs-batched pair — share references too.
        """
        ck = self._ref_keys.get(h.uid)
        if ck is None:
            # shape is part of the content: offload modes chop the same
            # seeded stream into different shapes, so byte-equal buffers
            # of different geometry must not share references
            # (the weight's bytes cross to the host once per handle)
            ck = self._ref_keys[h.uid] = hashlib.sha1(
                repr(h.shape).encode()
                + h.values.cpu().numpy().tobytes()).digest()
        key = (ck, batch, str(self.rt.device))
        ref = _REF_CACHE.get(key)
        if ref is None:
            ref = _REF_CACHE[key] = _fp32_matmul(
                self._on_device(h.values), self._on_device(x))
        return ref

    def _check_numeric(self, name: str, h: DeviceTensor, x: torch.Tensor,
                       y, batch: int) -> Tuple[float, float]:
        """Cross-check one executed matmul against the FP32 reference;
        returns ``(err, logits_err)`` for the step maxima."""
        ref = self._reference(h, x, batch)
        err = float((self._on_device(y).float() - ref).abs().max())
        assert err < self.atol, \
            (name, err, "PIM numeric decode diverged from the FP32 path "
             "beyond FP16 accumulation tolerance")
        logits_err = 0.0
        if name == "lm_head":
            logits_err = err
            self.last_logits = y
        return err, logits_err

    # -- fault failover (repro_torch.faults) ---------------------------------------

    @property
    def surviving_fraction(self) -> float:
        """Fraction of the runtime's channels still healthy (1.0 without
        an attached fault plan) — the server's admission-control input."""
        inj = self.rt.faults
        if inj is None:
            return 1.0
        total = len(self.rt.stack)
        return (total - len(inj.failed)) / total

    def _maybe_failover(self) -> None:
        """Step-boundary failover: if a whole home stack has fail-stopped
        since the last step, migrate its weights to a survivor.

        Failover is step-granular by design — a step already dispatched
        completes on the pre-fault decomposition; the *next* step sees
        the remap (the retry unit real serving systems use).  Partial
        stack failures need no action here: the scheduler's healthy-
        subset remap already decomposes over the surviving channels.
        """
        inj = self.rt.faults
        if inj is None or self.stacks == 1:
            return
        inj.poll()
        if not inj.failed:
            return
        cps = self.rt.stack.channels_per_stack
        dead = {s for s in range(self.stacks)
                if all(s * cps + c in inj.failed for c in range(cps))}
        homes = set(self.stack_map or ())
        for s in sorted(dead & homes):
            self._failover_stack(s, inj)

    def _failover_stack(self, dead: int, inj) -> None:
        """Migrate every weight homed on ``dead`` to the surviving stack
        carrying the least homed weight bytes, charging the migration on
        the host link as ``reupload`` traffic (the host re-carries the
        weights from its mirror — weights are immutable after placement,
        so the host copy is exact)."""
        cps = self.rt.stack.channels_per_stack
        alive = [s for s in range(self.stacks)
                 if any(s * cps + c not in inj.failed for c in range(cps))]
        if not alive:
            raise NoHealthyChannelsError(
                "every stack has failed; nowhere to fail weights over to")
        homed = {}
        for m, handles in self.weights:
            for home, _h in handles:
                if home is not None:
                    homed[home] = homed.get(home, 0) \
                        + m.out_dim * m.in_dim * BYTES_PER_ELEM
        survivor = min(alive, key=lambda s: (homed.get(s, 0), s))
        migrated = 0
        replaced: Dict[int, DeviceTensor] = {}
        if self.async_mode:
            healthy = tuple(c for c in self._stack_channels(survivor)
                            if c not in inj.failed)
            new_stages = []
            for stage in self._stages:
                if stage[0].channels[0] // cps != dead:
                    new_stages.append(stage)
                    continue
                if len(stage) <= len(healthy):
                    split = _group_split(
                        tuple((op.out_dim, op.in_dim) for op in stage),
                        len(healthy), self.placement, self._split_batch)
                    subs, c0 = [], 0
                    for nch in split:
                        subs.append(healthy[c0:c0 + nch])
                        c0 += nch
                else:
                    # fewer healthy channels than ops: share the full
                    # subset — the timeline serializes contenders
                    subs = [healthy] * len(stage)
                new_stage = []
                for op, sub in zip(stage, subs):
                    op.handle.evict()
                    payload = op.handle.values if self.numeric \
                        else (op.out_dim, op.in_dim)
                    nh = self.rt.place(payload, placement=self.placement,
                                       channels=sub)
                    replaced[op.handle.uid] = nh
                    migrated += op.out_dim * op.in_dim * BYTES_PER_ELEM
                    new_stage.append(_AsyncOp(op.name, op.out_dim,
                                              op.in_dim, nh, sub))
                new_stages.append(new_stage)
            self._stages = new_stages
        new_weights = []
        for m, handles in self.weights:
            hs = []
            for home, h in handles:
                if home == dead:
                    if h.uid in replaced:
                        h = replaced[h.uid]
                    else:                     # serialized: migrate now
                        h.evict()
                        payload = h.values if self.numeric \
                            else (m.out_dim, m.in_dim)
                        h = self.rt.place(payload,
                                          placement=self.placement,
                                          stack=survivor)
                        migrated += m.out_dim * m.in_dim * BYTES_PER_ELEM
                    home = survivor
                hs.append((home, h))
            new_weights.append((m, hs))
        self.weights = new_weights
        if self.stack_map is not None:
            self.stack_map = [survivor if s == dead else s
                              for s in self.stack_map]
        self.rt.stack.link.charge("reupload", migrated)
        inj.count("stack_failovers", 1)
        inj.count("failover_migrated_bytes", migrated)
        inj.instants.append(
            ("failover", inj.now, -1,
             f"stack {dead} weights -> stack {survivor} "
             f"({migrated} bytes)"))

    def step(self, batch: int,
             request_ids: Optional[Sequence[Hashable]] = None
             ) -> StepRecord:
        """Account (and in numeric mode, execute) one decode step over
        ``batch`` live slots.

        With ``kv_offload=True``, ``request_ids`` names the live
        requests whose KV grows this step (default ``range(batch)`` for
        direct driving) and the step additionally runs each request's
        attention sub-step on PIM (:meth:`_attention_serialized` /
        :meth:`_attention_async`).

        In async mode the step is submitted as the op DAG (stages chain,
        ops within a stage overlap on their channel groups) and
        ``pim_cycles`` is the step's timeline makespan; serialized mode
        sums per-op makespans as before.

        With a fault plan attached, a home stack that fully fail-stopped
        since the last step first fails its weights over to a survivor
        (:meth:`_maybe_failover`); the step then runs on the remapped
        homes.  A stack that dies *mid-step* aborts the attempt with
        :class:`~repro_torch.faults.injector.NoHealthyChannelsError` — the
        step fails over and replays from its start (ops submitted
        before the abort stay on the ledgers as wasted work).
        :meth:`pipeline` does not fail over (accounting-only wave
        studies fix their topology up front).
        """
        self._maybe_failover()
        self._maybe_migrate()
        try:
            return self._step_once(batch, request_ids)
        except NoHealthyChannelsError:
            failovers = (self.rt.faults.counters.get("stack_failovers", 0)
                         if self.rt.faults is not None else 0)
            self._maybe_failover()
            now = (self.rt.faults.counters.get("stack_failovers", 0)
                   if self.rt.faults is not None else 0)
            if now == failovers:
                # nothing migrated (partial stack death, or no survivor
                # to migrate to) — the fault is not recoverable here
                raise
            return self._step_once(batch, request_ids)

    def _step_once(self, batch: int,
                   request_ids: Optional[Sequence[Hashable]] = None
                   ) -> StepRecord:
        """One attempt at a decode step (see :meth:`step`)."""
        before = {d.channel_id: d.snapshot() for d in self.rt.stack}
        pim_cycles = 0.0
        flops = 0
        act_bytes = 0
        max_err = logits_err = 0.0
        rids: List[Hashable] = []
        if self.kv is not None:
            rids = list(request_ids) if request_ids is not None \
                else list(range(batch))
        attn_cycles, attn_err = 0.0, 0.0
        if self.async_mode:
            tl = self.rt.timeline
            t0 = tl.now
            kv_t0: Dict[Hashable, int] = {}
            for rid in rids:
                self.kv.begin_decode(rid)   # restore submits on timeline
                kv_t0[rid] = self.kv.tokens(rid)
            layer_idx = 0
            prev = self._step_tail      # chain steps: sampling feeds back
            for stage in self._stages:
                if rids and stage[0].name == "attn.wo":
                    # the layer's attention DAG gates its wo projection
                    ctx: List[OpHandle] = []
                    for rid in rids:
                        hs, cyc, fl, err = self._attention_async(
                            rid, layer_idx, kv_t0[rid], prev)
                        ctx.extend(hs)
                        attn_cycles += cyc
                        flops += fl
                        attn_err = max(attn_err, err)
                    prev = ctx or prev
                    layer_idx += 1
                handles = []
                for op in stage:
                    x = self._activation(op.in_dim, batch)
                    fut = self.rt.gemm(op.handle, x,
                                       placement=self.placement,
                                       execute=self.numeric,
                                       channels=op.channels, after=prev)
                    flops += fut.report.total_flops
                    if self.numeric:
                        err, lerr = self._check_numeric(
                            op.name, op.handle, x, fut.result, batch)
                        max_err = max(max_err, err)
                        logits_err = max(logits_err, lerr)
                    # consumed: only spans/retire matter downstream —
                    # don't let the op log pin every step's outputs
                    # (lm_head logits included) for the loop's lifetime
                    fut.result = None
                    handles.append(fut)
                prev = handles
            self._step_tail = prev
            pim_cycles = tl.now - t0
            act_bytes = sum(m.in_dim * batch * BYTES_PER_ELEM * m.count
                            for m in self.matmuls)
        else:
            for m, handles in self.weights:
                if not handles:
                    # routed mode: expert families dispatch through the
                    # placement bank (_routed_moe_step), not here
                    continue
                x = self._activation(m.in_dim, batch)
                for home, h in handles:
                    y, rep = self.rt.gemm(h, x, placement=self.placement,
                                          execute=self.numeric, stack=home)
                    pim_cycles += rep.makespan_cycles   # ops serialize
                    flops += rep.total_flops
                    if self.numeric:
                        err, lerr = self._check_numeric(
                            m.name, h, x, y, batch)
                        max_err = max(max_err, err)
                        logits_err = max(logits_err, lerr)
                act_bytes += m.in_dim * batch * BYTES_PER_ELEM * m.count
            if self.routing is not None:
                # routed expert sub-step: per layer, stacks run their
                # expert groups in parallel (max over stacks), layers
                # serialize like ops
                cyc, fl, ab = self._routed_moe_step(batch)
                pim_cycles += cyc
                flops += fl
                act_bytes += ab
            for rid in rids:
                cyc, fl, err = self._attention_serialized(rid)
                attn_cycles += cyc
                pim_cycles += cyc       # attention serializes like ops
                flops += fl
                attn_err = max(attn_err, err)
        max_err = max(max_err, attn_err)
        # the host roofline for the same math re-reads every live
        # request's K and V from HBM each step (no residency there)
        kv_tokens = sum(self.kv.tokens(r) for r in rids) \
            if self.kv is not None else 0
        kv_host_bytes = (kv_tokens * self.cfg.head_dim_ * BYTES_PER_ELEM
                         * 2 * self.kv.n_kv_heads * self.cfg.n_layers) \
            if self.kv is not None else 0
        h2d = sum(d.xfer.h2d_bytes - before[d.channel_id].h2d_bytes
                  for d in self.rt.stack)
        d2h = sum(d.xfer.d2h_bytes - before[d.channel_id].d2h_bytes
                  for d in self.rt.stack)
        reuse = sum(d.reuse_bytes - before[d.channel_id].reuse_bytes
                    for d in self.rt.stack)
        host_bytes = self.weight_bytes + act_bytes + kv_host_bytes
        host_compute_s = flops / self.peak_flops
        host_memory_s = host_bytes / self.hbm_bw
        rec = StepRecord(
            step=len(self.steps) + 1, batch=batch,
            pim_cycles=pim_cycles, pim_s=pim_cycles / PIM_FREQ_HZ,
            h2d_bytes=h2d, d2h_bytes=d2h, reuse_bytes=reuse, flops=flops,
            host_s=max(host_compute_s, host_memory_s),
            host_bound=("compute" if host_compute_s > host_memory_s
                        else "memory"),
            numeric=self.numeric, numeric_max_err=max_err,
            logits_max_err=logits_err, overlapped=self.async_mode,
            kv_tokens=kv_tokens, kv_host_bytes=kv_host_bytes,
            attn_cycles=attn_cycles, attn_max_err=attn_err)
        self.steps.append(rec)
        if self.metrics is not None:
            m = self.metrics
            m.counter("offload.steps", unit="steps",
                      help="decode steps mirrored onto PIM").inc()
            m.counter("offload.flops", unit="flop",
                      help="decode FLOPs offloaded").inc(rec.flops)
            m.counter("offload.act_h2d_bytes", unit="bytes",
                      help="per-step activation h2d traffic").inc(rec.h2d_bytes)
            m.histogram("offload.step_pim_cycles", unit="cycles",
                        help="per-step PIM makespan (async: timeline "
                             "makespan; serialized: sum of ops)").record(
                rec.pim_cycles)
            if self.kv is not None:
                m.histogram("offload.attn_step_cycles", unit="cycles",
                            help="per-step PIM cycles in attention ops "
                                 "(append + score + softmax + context)"
                            ).record(rec.attn_cycles)
        return rec

    def _visit_groups(self) -> List[List[List[_AsyncOp]]]:
        """Group the step's stages into *visits*: maximal runs of
        consecutive stages whose ops live on the same home stack (one
        request's layer block, the pipeline's scheduling quantum)."""
        visits: List[List[List[_AsyncOp]]] = []
        cps = self.rt.stack.channels_per_stack if self.stacks > 1 \
            else len(self.rt.stack)
        last_stack = None
        for stage in self._stages:
            stk = stage[0].channels[0] // cps
            if stk != last_stack:
                visits.append([])
                last_stack = stk
            visits[-1].append(stage)
        return visits

    def pipeline(self, requests: int, steps: int,
                 batch: int = 1) -> Dict:
        """Wave-pipeline ``requests`` independent decode requests for
        ``steps`` decode steps each (async mode, accounting-only).

        Every request is its own dependency chain — its stages chain
        through ``after=`` edges (a step's first projections wait on the
        previous step's lm_head: host-side sampling feeds the next
        token) — while *different* requests share nothing but the
        resident weights, so with layer blocks homed on different stacks
        (``stacks=N``) request r+1's layer-0 block runs while request r
        is in layer 1: the cross-stack layer pipeline.  Submission is
        earliest-ready-first across requests, which lets the monotonic
        channel clocks realize the wave schedule.

        Returns the pipeline report: timeline makespan, per-stack busy
        cycles, and the op count.
        """
        if not self.async_mode:
            raise ValueError("pipeline() requires async_mode=True")
        if self.numeric:
            raise ValueError(
                "pipeline() is accounting-only; numeric mode cross-"
                "checks per-step via step()")
        tl = self.rt.timeline
        t0 = tl.now
        n0 = len(tl.ops)
        # submission is *visit*-atomic: all of a request's consecutive
        # stages on one home stack enter the clocks contiguously, so a
        # stack serves one request's layer block at a time (FIFO by
        # arrival) instead of round-robin-interleaving every queued
        # request's stages — stage-granular submission on monotonic
        # clocks locks the ring into a lockstep convoy that leaves the
        # bottleneck stack idle every period
        visits = self._visit_groups()
        total = len(visits) * steps
        tails: List[Optional[List[OpHandle]]] = [None] * requests
        ready = [0.0] * requests
        done = [0] * requests
        while True:
            live = [r for r in range(requests) if done[r] < total]
            if not live:
                break
            r = min(live, key=lambda r: (ready[r], r))
            for stage in visits[done[r] % len(visits)]:
                handles = []
                for op in stage:
                    x = self._activation(op.in_dim, batch)
                    handles.append(self.rt.gemm(
                        op.handle, x, placement=self.placement,
                        execute=False, channels=op.channels,
                        after=tails[r]))
                tails[r] = handles
            ready[r] = max(h.retire for h in tails[r])
            done[r] += 1
        makespan = tl.now - t0
        per_stack_busy: Dict[int, float] = {}
        cps = self.rt.stack.channels_per_stack if self.stacks > 1 \
            else len(self.rt.stack)
        for h in tl.ops[n0:]:
            for ch, (_, busy) in h.spans.items():
                per_stack_busy[ch // cps] = \
                    per_stack_busy.get(ch // cps, 0.0) + busy
        return {
            "requests": requests,
            "steps": steps,
            "batch": batch,
            "stacks": self.stacks,
            "makespan_cycles": makespan,
            "makespan_s": makespan / PIM_FREQ_HZ,
            "ops": len(tl.ops) - n0,
            "per_stack_busy_cycles": [per_stack_busy.get(s, 0.0)
                                      for s in range(self.stacks)],
        }

    # -- reporting -----------------------------------------------------------

    def roofline(self) -> Dict:
        """Summary over accumulated steps: steady-state transfer breakdown
        and the PIM-vs-host comparison.

        "Steady state" is the latest *full-batch* step — the serve loop's
        drain tail decodes with shrinking live batches, which would
        under-report the steady activation traffic.
        """
        assert self.steps, "run at least one step first"
        peak = max(s.batch for s in self.steps)
        steady = [s for s in self.steps if s.batch == peak][-1]
        out = {
            "arch": self.cfg.name,
            # the per-op decomposition width (channels per stack) — every
            # op is stack-restricted, so this, not stacks*channels, is
            # the width the per-channel ledgers reflect
            "channels": (len(self.rt.stack) if self.stacks == 1
                         else self.rt.stack.channels_per_stack),
            "stacks": self.stacks,
            "upload_bytes_per_stack": self.upload_bytes_per_stack,
            "host_link_bytes": (self.rt.stack.link_totals()[0]
                                if self.stacks > 1 else 0),
            "placement": self.placement,
            "matmuls_per_step": sum(m.count for m in self.matmuls),
            "weight_bytes": self.weight_bytes,
            "upload_bytes": self.upload_bytes,
            "steady_h2d_bytes": steady.h2d_bytes,
            "steady_d2h_bytes": steady.d2h_bytes,
            "steady_reuse_bytes": steady.reuse_bytes,
            "steady_pim_s": steady.pim_s,
            "steady_host_s": steady.host_s,
            "steady_host_bound": steady.host_bound,
            "steady_pim_vs_host": steady.pim_vs_host,
            "steady_kv_tokens": steady.kv_tokens,
            "steady_attn_cycles": steady.attn_cycles,
            "kv": self.kv.summary() if self.kv is not None else None,
            "steps": [s.to_json() for s in self.steps],
        }
        if self.routing is not None:
            out["moe"] = self.moe_summary()
        return out

    def dump(self, path: str) -> Dict:
        """Write the roofline trajectory as JSON (the BENCH artifact)."""
        rec = self.roofline()
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
            f.write("\n")
        return rec
