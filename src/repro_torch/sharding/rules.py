"""PartitionSpec rules and the PIM-placement rules (port of
``repro.sharding.rules``).

The tensor-parallel dataflows:

* ``allreduce`` (Megatron): up-projections column-sharded on 'model',
  down-projections row-sharded => partial sums all-reduced.
* ``allgather`` (the paper's reduction-free outer-product dataflow): every
  weight sharded on its *output* dim; inputs are all-gathered just-in-time
  and partial sums never cross the 'model' axis.
* ``ame_pim`` — the device-runtime flavor: mesh-level specs are the
  ``allgather`` output-dim sharding, plus a *stack* assignment for the
  PIM cluster: model-parallel layouts map layers (and experts) onto
  :class:`~repro_torch.runtime.cluster.PIMCluster` stacks as contiguous
  blocks — :func:`ame_pim_layer_stacks` / :func:`ame_pim_stack_map`,
  consumed by :class:`repro_torch.serve.offload.DecodeOffload` — and
  :func:`ame_pim_expert_placement` places a routed MoE expert bank by
  expected token mass.

FSDP ('data'-axis parameter + optimizer-state sharding) stacks on top for
the large archs (policy.fsdp).  The spec rules take any tree of tensors
(meta tensors included) and any mesh with ``.shape`` and ``.axis_names``
or a ``DeviceMesh``; their specs and paths are the reference's, and
:func:`to_placements` turns a spec tree into DTensor placements.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ArchConfig, OUTPUT_SHARDED_TP_MODES
from repro_torch.sharding.context import P, axis_names, axis_sizes, placements


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _fits(shape, spec, mesh) -> P:
    """Drop axes that don't divide the dim (e.g. 8 KV heads on model=16)."""
    out = []
    for i, ax in enumerate(spec):
        if ax is not None and (i >= len(shape)
                               or shape[i] % _axis_size(mesh, ax) != 0):
            ax = None
        out.append(ax)
    return P(*out)


def _tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths joined by '/' as the
    reference's ``_path_str`` joins dict keys."""
    return {k: _tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
            if isinstance(v, dict)
            else fn(f"{prefix}/{k}" if prefix else k, v)
            for k, v in tree.items()}


def _base_rule(pstr: str, cfg: ArchConfig) -> Optional[Tuple]:
    """Logical spec for the *unstacked* parameter (innermost dims)."""
    fsdp = "data" if cfg.policy.fsdp else None
    ag = cfg.policy.tp_mode in OUTPUT_SHARDED_TP_MODES
    ep = cfg.moe is not None and cfg.moe.sharding == "ep"

    if "embed/table" in pstr:
        return ("model", fsdp)
    if "head/w" in pstr or "mtp_proj/w" in pstr:
        return (fsdp, "model")
    if "experts/wi" in pstr or "experts/wg" in pstr:
        return ("model", fsdp, None) if ep else (None, fsdp, "model")
    if "experts/wo" in pstr:
        if ep:
            return ("model", None, fsdp)
        return (None, fsdp, "model") if ag else (None, "model", fsdp)
    if "router/w" in pstr:
        return (None, None)
    if "lora_a" in pstr:
        return (fsdp, None)          # (2d, r) under a stacked groups dim
    if "lora_b" in pstr:
        return (None, None)
    if "conv_w" in pstr:
        return (None, "model")
    # attention / mla / mlp / mamba two-dim weights
    if any(s in pstr for s in ("wq/w", "wk/w", "wv/w", "wi/w", "wg/w",
                               "wuq/w", "wuk/w", "wuv/w", "wdkv/w",
                               "wdq/w", "in_proj/w")):
        return (fsdp, "model")
    if "wkr/w" in pstr:
        return (fsdp, None)
    if any(s in pstr for s in ("wo/w", "out_proj/w")):
        return (fsdp, "model") if ag else ("model", fsdp)
    return None                       # replicate (norms, scalars, biases)


def _spec_for(pstr: str, ndim: int, cfg: ArchConfig) -> Tuple:
    base = _base_rule(pstr, cfg)
    if base is None or ndim < len(base):
        return (None,) * ndim
    return (None,) * (ndim - len(base)) + tuple(base)


def param_pspecs(cfg: ArchConfig, params_shapes, mesh):
    """Spec tree matching the params tree."""
    return _tree_map_with_path(
        lambda path, leaf: _fits(leaf.shape,
                                 _spec_for(path, leaf.dim(), cfg), mesh),
        params_shapes)


def opt_pspecs(cfg: ArchConfig, opt_shapes, mesh):
    """Specs for the optimizer state (mirrors params with m/v wrappers)."""

    def one(pstr, leaf):
        if pstr.endswith("step"):
            return P()
        # strip the m/v prefix and the codec suffix
        suffix = pstr.rsplit("/", 1)[-1]
        core = pstr.split("/", 1)[1] if "/" in pstr else pstr
        nd = leaf.dim()
        if suffix == "s":      # int8 scale: param spec minus last axis
            spec = _spec_for(core.rsplit("/", 1)[0], nd, cfg)
            spec = spec[:-1] + (None,)
        elif suffix == "r":    # factored row stat: param ndim = nd+1
            spec = _spec_for(core.rsplit("/", 1)[0], nd + 1, cfg)[:-1]
        elif suffix == "c":    # factored col stat
            full = _spec_for(core.rsplit("/", 1)[0], nd + 1, cfg)
            spec = full[:-2] + full[-1:]
        elif suffix == "q":
            spec = _spec_for(core.rsplit("/", 1)[0], nd, cfg)
        else:
            spec = _spec_for(core, nd, cfg)
        return _fits(leaf.shape, spec, mesh)

    return _tree_map_with_path(one, opt_shapes)


def _batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def batch_pspecs(cfg: ArchConfig, batch_shapes, mesh):
    """Inputs: dim0 = batch, sharded over ('pod','data') when divisible."""
    baxes = _batch_axes(mesh)
    return _tree_map_with_path(
        lambda path, leaf: _fits(leaf.shape,
                                 (baxes,) + (None,) * (leaf.dim() - 1),
                                 mesh),
        batch_shapes)


def cache_pspecs(cfg: ArchConfig, cache_shapes, mesh):
    """Decode caches: batch over DP axes; heads (or head_dim / latent /
    state channels) over 'model'."""
    baxes = _batch_axes(mesh)

    def one(pstr, leaf):
        nd = leaf.dim()
        if pstr.endswith("pos"):
            return _fits(leaf.shape, (None, baxes, None)[:nd], mesh)
        if "/k" in pstr or "/v" in pstr or pstr.endswith("k") \
                or pstr.endswith("v"):
            # (L, B, T, H, hd): heads if divisible else head_dim
            spec = [None] * nd
            spec[1] = baxes
            h_ax = nd - 2
            if leaf.shape[h_ax] % _axis_size(mesh, "model") == 0:
                spec[h_ax] = "model"
            else:
                spec[nd - 1] = "model"
            return _fits(leaf.shape, tuple(spec), mesh)
        if "ckv" in pstr:
            return _fits(leaf.shape, (None, baxes, None, "model"), mesh)
        if "kr" in pstr:
            return _fits(leaf.shape, (None, baxes, None, None), mesh)
        if "conv" in pstr:
            return _fits(leaf.shape, (None, baxes, None, "model"), mesh)
        if "ssm" in pstr:
            return _fits(leaf.shape, (None, baxes, "model", None, None),
                         mesh)
        spec = (None, baxes) + (None,) * (nd - 2)
        return _fits(leaf.shape, spec[:nd], mesh)

    return _tree_map_with_path(one, cache_shapes)


def to_placements(tree, mesh):
    """A spec tree as DTensor placements on ``mesh`` (the reference's
    ``to_named``): per mesh dim ``Shard(d)`` or ``Replicate()``."""
    if isinstance(tree, P):
        return placements(tree, mesh)
    return {k: to_placements(v, mesh) for k, v in tree.items()}


def _local_chunk(x, pl, mesh):
    """This rank's chunk of ``x`` under placements ``pl``, a view cut where
    ``x`` lies: mesh dims in order (so a dim on ``("pod", "data")`` is pod
    major), each ``Shard(d)`` split as ``torch.chunk`` splits, as DTensor
    does."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            d = p.dim % x.dim()
            n, k = x.shape[d], mesh.size(i)
            size = -(-n // k)
            start = min(coord[i] * size, n)
            x = x.narrow(d, start, min(size, n - start))
    return x


def place(x, pl, mesh):
    """``x`` as a DTensor with placements ``pl``: every rank holds the whole
    tensor (on the host or on its card) and keeps its own chunk, cut where
    ``x`` lies and then copied to the mesh's device, so no rank moves more
    than its shards and nothing is communicated."""
    dev = (x.device if x.is_meta or x.device.type == mesh.device_type
           else torch.device(mesh.device_type))
    chunk = _local_chunk(x, pl, mesh).to(dev, copy=True)
    return DTensor.from_local(chunk, mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def distribute(tree, specs, mesh):
    """A tree of tensors placed on ``mesh`` by a spec tree, each leaf by
    :func:`place` (the reference's ``jax.device_put(tree, to_named(specs,
    mesh))``)."""
    if isinstance(specs, P):
        return place(tree, placements(specs, mesh), mesh)
    return {k: distribute(tree[k], v, mesh) for k, v in specs.items()}


# ---------------------------------------------------------------------------
# ame_pim: mapping model-parallel layouts onto PIM cluster stacks
# ---------------------------------------------------------------------------


def ame_pim_layer_stacks(n: int, stacks: int) -> List[int]:
    """Stack id for each of ``n`` layers (or experts): contiguous
    near-equal blocks, earlier stacks taking the remainder.

    Contiguity is deliberate — adjacent decode layers hand their hidden
    state to each other, so keeping neighbors on one stack minimizes the
    host-link crossings the cluster ledger charges; near-equal blocks
    keep per-stack weight capacity balanced.
    """
    if stacks < 1:
        raise ValueError(f"need at least one stack, got {stacks}")
    if n <= 0:
        return []
    q, r = divmod(n, stacks)
    out: List[int] = []
    for s in range(stacks):
        out.extend([s] * (q + (1 if s < r else 0)))
    return out


@dataclasses.dataclass(frozen=True)
class ExpertPlacement:
    """A routed-traffic-aware expert -> stack assignment.

    ``homes[moe_layer][expert]`` is that expert's home stacks, primary
    first — more than one entry means the expert is *replicated* (its
    routed GEMVs pick a copy per step by least-loaded home).
    ``layer_loads[moe_layer][stack]`` is the expected token mass the
    profile predicts for each stack, with a replicated expert's mass
    split evenly over its copies — the planning-time balance estimate
    the observed ``moe.tokens_stack*`` gauges are checked against.
    """

    stacks: int
    policy: str
    replicate: int
    homes: Tuple[Tuple[Tuple[int, ...], ...], ...]
    layer_loads: Tuple[Tuple[float, ...], ...]

    @staticmethod
    def _max_over_mean(loads) -> float:
        total = sum(loads)
        if total <= 0:
            return 1.0
        return max(loads) / (total / len(loads))

    @property
    def max_over_mean(self) -> float:
        """Aggregate (all layers) expected max/mean stack token load."""
        agg = [sum(layer[s] for layer in self.layer_loads)
               for s in range(self.stacks)]
        return self._max_over_mean(agg)

    @property
    def worst_layer_max_over_mean(self) -> float:
        """Worst single layer's expected max/mean stack token load —
        the figure that bounds the per-layer expert-parallel makespan."""
        if not self.layer_loads:
            return 1.0
        return max(self._max_over_mean(layer) for layer in self.layer_loads)


def ame_pim_expert_placement(profile, stacks: int, *, replicate: int = 0,
                             policy: str = "greedy") -> ExpertPlacement:
    """Place one :class:`~repro_torch.serve.traffic.RoutingProfile`'s expert
    bank onto ``stacks`` stacks, layer by layer.

    ``policy="greedy"`` is the skew-driven token balancer: per MoE
    layer, experts are assigned heaviest-first to the currently
    least-loaded stack (longest-processing-time bin packing), and the
    top ``replicate`` experts by mass get extra copies on stacks not
    already hosting them — copy counts scale with mass
    (``ceil(2 * share * stacks)``, clamped to [2, stacks]), so a
    Zipf-hot expert lands on enough stacks that its routed traffic can
    level the load; each copy is placed as an independent
    ``mass/copies`` unit.  ``policy="roundrobin"`` reproduces the
    traffic-blind legacy map (``expert % stacks``, replicas on the
    following stacks) as the comparison baseline.
    """
    if stacks < 1:
        raise ValueError(f"need at least one stack, got {stacks}")
    if policy not in ("greedy", "roundrobin"):
        raise ValueError(f"unknown placement policy {policy!r}")
    replicate = max(0, min(int(replicate), profile.n_experts))
    homes: List[Tuple[Tuple[int, ...], ...]] = []
    layer_loads: List[Tuple[float, ...]] = []
    for layer in range(profile.n_layers):
        row = profile.counts[layer]
        # an empty layer routes uniformly — place it that way too
        masses = [float(c) for c in row] if sum(row) > 0 \
            else [1.0] * profile.n_experts
        by_mass = sorted(range(profile.n_experts),
                         key=lambda e: (-masses[e], e))
        total_mass = sum(masses)
        replicated = set(by_mass[:replicate]) if stacks > 1 else set()
        copies = {
            e: (max(2, min(stacks,
                           math.ceil(2 * masses[e] / total_mass * stacks)))
                if e in replicated else 1)
            for e in range(profile.n_experts)}
        load = [0.0] * stacks
        layer_homes: List[List[int]] = [[] for _ in range(profile.n_experts)]
        if policy == "roundrobin":
            for e in range(profile.n_experts):
                layer_homes[e] = [(e + j) % stacks
                                  for j in range(copies[e])]
                for s in layer_homes[e]:
                    load[s] += masses[e] / copies[e]
        else:
            # every copy is an independent unit of mass/copies; place
            # units heaviest-first onto the least-loaded stack that does
            # not already host a copy of the same expert
            units = sorted(
                ((masses[e] / copies[e], e, j)
                 for e in range(profile.n_experts)
                 for j in range(copies[e])),
                key=lambda u: (-u[0], u[1], u[2]))
            for mass, e, _ in units:
                avail = [s for s in range(stacks)
                         if s not in layer_homes[e]] or list(range(stacks))
                s = min(avail, key=lambda i: (load[i], i))
                layer_homes[e].append(s)
                load[s] += mass
        homes.append(tuple(tuple(h) for h in layer_homes))
        layer_loads.append(tuple(load))
    return ExpertPlacement(stacks=stacks, policy=policy, replicate=replicate,
                           homes=tuple(homes),
                           layer_loads=tuple(layer_loads))


def ame_pim_stack_map(cfg: ArchConfig, stacks: int, *, profile=None,
                      replicate: int = 0) -> Dict[str, Any]:
    """The ``ame_pim`` layout of one arch on a ``stacks``-stack cluster.

    ``layers`` maps each decoder layer to its home stack (contiguous
    blocks) — what ``DecodeOffload(stacks=N)`` consumes, every weight
    instance homed with its layer.  ``experts`` (MoE only) maps the
    *full* expert bank over stacks for mesh-level placement: round-robin
    by default (capacity-balanced), or — when a
    :class:`~repro_torch.serve.traffic.RoutingProfile` is supplied — the
    greedy token balancer's aggregate-mass assignment, with the full
    per-layer :class:`ExpertPlacement` (incl. ``replicate`` hot-expert
    copies) under ``expert_placement``.
    """
    out: Dict[str, Any] = {"layers": ame_pim_layer_stacks(cfg.n_layers,
                                                          stacks)}
    if cfg.moe is not None:
        if profile is None:
            out["experts"] = [e % stacks
                              for e in range(cfg.moe.num_experts)]
        else:
            pl = ame_pim_expert_placement(profile, stacks,
                                          replicate=replicate)
            # flat capacity view: aggregate-mass greedy, primaries only
            mass = profile.expert_mass()
            order = sorted(range(profile.n_experts),
                           key=lambda e: (-mass[e], e))
            load = [0.0] * stacks
            flat = [0] * profile.n_experts
            for e in order:
                s = min(range(stacks), key=lambda i: (load[i], i))
                flat[e] = s
                load[s] += float(mass[e])
            out["experts"] = flat
            out["expert_placement"] = pl
    return out
