"""Per-device FLOPs, memory traffic and collective link bytes of one run of
a step — the counterpart of ``repro.launch.hloanalysis``.

The reference parses the partitioned HLO that XLA compiles for a step.
PyTorch has no HLO: an eager DTensor step is never compiled into one
program.  So this module runs the step once (on a fake process group and
fake tensors in ``launch/dryrun``, so nothing is allocated) under a
dispatch mode that sees every op each rank executes on its **local**
tensors — DTensor ops are let through to DTensor first, exactly as
``CommDebugMode`` does, so the mode sees what they desugar into: the local
compute and the collectives of each redistribution.  It fills the
reference's ``HLOReport`` fields:

* ``flops`` / ``dot_flops``: per device.  ``dot_flops`` sums
  ``FlopCounterMode``'s formulas (``torch.utils.flop_counter.
  flop_registry``: mm, bmm, addmm, baddbmm, convolutions, attention) over
  the local ops; ``flops`` adds one per output element of every pointwise
  and reduction op, as the reference counts elementwise and reduce
  instructions.  A DTensor op on shards is counted on the shard each rank
  computes, so replicated work counts once per rank that does it.
* ``hbm_bytes``: operand and result bytes of every local op that moves
  data (views, factories of empty tensors and collectives excluded).
  Eager PyTorch fuses nothing, so every intermediate round-trips through
  device memory: an upper bound where the reference counts fusion
  boundaries.
* ``collectives`` / ``collective_link_bytes``: the collectives
  ``CommDebugMode`` counts, each charged by the reference's ring model
  (:func:`ring_link_bytes`, ported from ``hloanalysis._collective_link_
  bytes``) on its local payload and group size.  Collectives run in the
  tensor's own dtype here, so ``collective_link_bytes_bf16`` equals
  ``collective_link_bytes``: the reference's correction undoes an XLA-CPU
  promotion of bf16 reductions that PyTorch does not make.
* ``unknown_trip_loops``: always 0.  The reference counts while loops
  whose trip count XLA did not record; a traced run executes every
  iteration of every Python loop, so no count is unknown.

``peak_bytes`` (no reference field) is the largest sum of live local
tensors the step allocates, on top of its resident inputs: each new
storage counts from the op that made it until its tensor is freed.
DTensor's sharding propagation builds tensors of the global shape to infer
output shapes; those are bookkeeping, not device memory, and are not
counted (a run on the card would build them on the meta device).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Dict, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import _sharding_prop
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: functional collective ops (``torch.ops._c10d_functional``) -> kind
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp",
               "prod", "var", "std", "norm", "cumsum", "any", "all",
               "argmax", "argmin", "_softmax", "_log_softmax",
               "linalg_vector_norm", "sort", "topk"}
#: ops that allocate without writing, or only move metadata
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "detach", "alias",
               "lift_fresh", "_local_scalar_dense", "wait_tensor",
               "new_empty", "new_empty_strided", "set_", "resize_"}


def ring_link_bytes(kind: str, out_bytes: float, in_bytes: float,
                    group: int) -> float:
    """Per-rank link bytes of one collective under the ring model of
    ``repro.launch.hloanalysis._collective_link_bytes``."""
    if group <= 1:
        return 0.0
    frac = (group - 1) / group
    if kind == "all-reduce":
        return 2 * out_bytes * frac
    if kind == "all-gather":
        return out_bytes * frac
    if kind == "reduce-scatter":
        return max(in_bytes, out_bytes) * frac
    if kind == "all-to-all":
        return out_bytes * frac
    return float(out_bytes)          # collective-permute


@dataclasses.dataclass
class TraceReport:
    """The reference's ``HLOReport`` fields, per device, plus the traced
    peak and the per-op rows :mod:`launch.attribute` ranks."""
    flops: float = 0.0
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_link_bytes: float = 0.0
    collective_link_bytes_bf16: float = 0.0
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=lambda: {k: {"count": 0, "link_bytes": 0.0}
                                 for k in COLLECTIVES})
    unknown_trip_loops: int = 0
    n_instructions: int = 0
    peak_bytes: float = 0.0
    #: (op, shapes) -> [count, bytes each]; collectives under "coll:<kind>"
    rows: Dict[Tuple[str, str], List[float]] = dataclasses.field(
        default_factory=dict)

    def to_dict(self):
        d = dataclasses.asdict(self)
        d.pop("rows")
        return d


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    name = func._overloadpacket.__name__
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    return dist.distributed_c10d._resolve_process_group(args[-1]).size()


_prop = threading.local()


@contextlib.contextmanager
def _marking_propagation():
    """Mark the ops DTensor runs to infer output shapes, so the tracer
    skips them."""
    cls = _sharding_prop.ShardingPropagator
    orig = cls._propagate_tensor_meta_non_cached

    def wrapped(self, *a, **k):
        _prop.depth = getattr(_prop, "depth", 0) + 1
        try:
            return orig(self, *a, **k)
        finally:
            _prop.depth -= 1
    cls._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        cls._propagate_tensor_meta_non_cached = orig


class StepTracer(CommDebugMode):
    """``CommDebugMode`` that also counts FLOPs, traffic and live bytes of
    the local ops (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.report = TraceReport()
        self._live = 0
        self._storages: Dict[int, int] = {}

    def _row(self, key: Tuple[str, str], nbytes: float):
        row = self.report.rows.setdefault(key, [0, nbytes])
        row[0] += 1

    def _free(self, key: int):
        self._live -= self._storages.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t == DTensor for t in types):
            return NotImplemented         # let DTensor desugar it first
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if getattr(_prop, "depth", 0):
            return out
        rep = self.report
        rep.n_instructions += 1
        name = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        kind = _COLLECTIVE_OPS.get(name) \
            if func.namespace == "_c10d_functional" else None
        if kind is not None:
            ob = sum(_nbytes(t) for t in outs)
            ib = sum(_nbytes(t) for t in ins)
            link = ring_link_bytes(kind, ob, ib, _group_size(func, args))
            rep.collectives[kind]["count"] += 1
            rep.collectives[kind]["link_bytes"] += link
            rep.collective_link_bytes += link
            rep.collective_link_bytes_bf16 += link
            self._row((f"coll:{kind}", str([tuple(t.shape) for t in ins])),
                      link)
            return out
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            df = float(f(*args, **(kwargs or {}), out_val=out))
            rep.dot_flops += df
            rep.flops += df
        elif torch.Tag.pointwise in func.tags or name in _REDUCTIONS:
            rep.flops += sum(t.numel() for t in outs[:1])
        if func.is_view or name in _NO_TRAFFIC:
            return out
        io = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        rep.hbm_bytes += io
        self._row((name, str([tuple(t.shape) for t in ins])), io)
        # live bytes: a storage no input shares is a new allocation
        in_st = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in in_st or key in self._storages:
                continue
            self._storages[key] = st.nbytes()
            self._live += st.nbytes()
            weakref.finalize(t, self._free, key)
        rep.peak_bytes = max(rep.peak_bytes, self._live)
        return out


def local_bytes(tree) -> int:
    """Bytes of this rank's local shards of a tree of (D)Tensors."""
    total = 0
    for x in _tensors(tree):
        total += _nbytes(x.to_local() if isinstance(x, DTensor) else x)
    return total


def trace(fn, *args) -> Tuple[Any, TraceReport]:
    """Run ``fn(*args)`` once under :class:`StepTracer`; returns its
    output and the report (``peak_bytes`` includes the local bytes of the
    arguments)."""
    tracer = StepTracer()
    with _marking_propagation(), tracer:
        out = fn(*args)
    rep = tracer.report
    rep.peak_bytes += local_bytes(args)
    return out, rep
