"""Logical-axis sharding context (port of ``repro.sharding.context``).

Model code annotates tensors with *logical* axes ('batch', 'model',
'expert', None); the active mesh (set by the launcher) decides what they
resolve to:

  'batch'  -> ('pod', 'data') on the multi-pod mesh, ('data',) single-pod
  'model'  -> 'model'   (TP/EP axis)
  'fsdp'   -> 'data'    (parameter/optimizer-state sharding axis)

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``; the sharded tensors are DTensors, and a constraint is
a ``DTensor.redistribute`` to the resolved placements (the counterpart of
``with_sharding_constraint``).  With no mesh set (one device, the CPU
tests), or on a plain tensor, every constraint is a no-op, so the same
model code runs anywhere.

Anything with ``.shape`` (a mapping of axis name to size) and
``.axis_names`` stands for a mesh where only sizes are read (the rules
and ``launch/memmodel``), as in the reference.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

_state = threading.local()


class P(tuple):
    """An immutable PartitionSpec: per tensor dim ``None``, a mesh axis
    name, or a tuple of names (sharded over their product, the first
    major).  A tuple, so it compares ``==`` to the reference's spec taken
    as a tuple; a one-name tuple is stored as the name, as JAX stores
    it."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            (a[0] if len(a) == 1 else a or None) if isinstance(a, tuple)
            else a for a in axes))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` or a duck-typed mesh."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def current_mesh() -> Optional[DeviceMesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[DeviceMesh]):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def resolve_axis(logical, mesh):
    """Map a logical axis name to mesh axis name(s)."""
    names = axis_names(mesh)
    if logical is None:
        return None
    if logical == "batch":
        return ("pod", "data") if "pod" in names else "data"
    if logical == "batch_heads":
        # a flattened (batch*heads) dim: batch-major -> DP axes, heads ->
        # 'model'; the merged dim shards over all of them
        base = ("pod", "data") if "pod" in names else ("data",)
        return base + ("model",) if "model" in names else base
    if logical == "fsdp":
        return "data"
    if logical in names:
        return logical
    return None


def spec(*logical) -> P:
    """Resolve logical axes against the current mesh into a spec."""
    mesh = current_mesh()
    if mesh is None:
        return P()
    return P(*(resolve_axis(a, mesh) for a in logical))


def placements(pspec, mesh) -> List:
    """The DTensor placements of ``pspec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` it shards, else ``Replicate()``.
    A dim on ``('pod', 'data')`` is ``Shard(d)`` on both mesh dims, in mesh
    order, which splits it pod-major as the reference's spec does."""
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(pspec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax!r} is not in mesh order "
                             f"{names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def constrain(x, *logical):
    """Redistribute a DTensor to its logical axes; a no-op without a mesh
    or on a plain tensor.

    Axes whose size does not divide the dim are dropped (replicated) —
    e.g. 8 KV heads on a 16-way model axis.
    """
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    sizes = axis_sizes(mesh)
    resolved = []
    for dim, a in enumerate(logical):
        r = resolve_axis(a, mesh)
        if r is not None:
            ax_size = 1
            for n in (r if isinstance(r, tuple) else (r,)):
                ax_size *= sizes[n]
            if x.shape[dim] % ax_size != 0:
                r = None
        resolved.append(r)
    return placed(x, mesh, placements(P(*resolved), mesh))


def placed(t: torch.Tensor, mesh: DeviceMesh, pl: Optional[List] = None
           ) -> DTensor:
    """``t`` as a DTensor on ``mesh`` (a plain tensor taken as replicated),
    redistributed to the placements ``pl`` where given and different."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if pl is None or list(t.placements) == pl:
        return t
    return t.redistribute(mesh, pl)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> List:
        return placements(self.spec, self.mesh)


def named_sharding(*logical) -> Optional[NamedSharding]:
    mesh = current_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, spec(*logical))



def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` of DTensors on each rank's local shards.

    DTensor runs an einsum as one batched product over the flattened
    batch letters, and a batch sharded on two mesh dims (batch on 'data',
    heads on 'model') becomes a strided shard whose product DTensor cannot
    propagate.  Here each mesh dim keeps one sharded letter and the
    operands are brought to it: a batch letter (in every operand and the
    output) stays sharded everywhere; a contracted letter sharded in every
    operand gives a ``Partial`` sum; a free letter of one operand shards
    the output, the other operands gathered.  Plain operands take
    ``torch.einsum``."""
    if not any(isinstance(x, DTensor) for x in operands):
        return torch.einsum(eq, *operands)
    ins, out = eq.replace(" ", "").split("->")
    terms = ins.split(",")
    mesh = next(x for x in operands if isinstance(x, DTensor)).device_mesh
    xs = [placed(x, mesh) for x in operands]
    batch = set(out).intersection(*map(set, terms))
    contracted = set.intersection(*map(set, terms)) - set(out)
    in_pl = [[] for _ in xs]
    out_pl, grad_pl = [], [[] for _ in xs]
    for i in range(mesh.ndim):
        letters = [t[p.dim] if p.is_shard() else None
                   for t, p in zip(terms, (x.placements[i] for x in xs))]
        pick = next((L for L in letters if L in batch), None) \
            or next((L for L in letters if L in contracted
                     and all(m == L for m in letters)), None) \
            or next((L for L in letters if L is not None
                     and L not in contracted), None)
        pick = pick or "_"                   # no letter: all replicated
        for j, t in enumerate(terms):
            p = Shard(t.index(pick)) if pick in t else Replicate()
            in_pl[j].append(p)
            grad_pl[j].append(Partial() if pick in out and pick not in t
                              else p)
        out_pl.append(Shard(out.index(pick)) if pick in out
                      else Partial() if pick in contracted else Replicate())
    xs = [placed(x, mesh, pl) for x, pl in zip(xs, in_pl)]
    fn = local_map(lambda *a: torch.einsum(eq, *a), out_placements=out_pl,
                   in_placements=tuple(in_pl),
                   in_grad_placements=tuple(grad_pl), device_mesh=mesh)
    return fn(*xs)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` of a (..., K) and b (K, N); DTensors multiply on
    their local shards, as :func:`einsum` does."""
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.matmul(a, b)
    lead = "abcdefgh"[:a.dim() - 1]
    return einsum(f"{lead}k,kn->{lead}n", a, b)
