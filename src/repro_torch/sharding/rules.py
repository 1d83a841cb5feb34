"""The PIM-placement rules of the ``ame_pim`` tensor-parallel mode.

Port of the placement half of ``repro.sharding.rules``: model-parallel
layouts map layers (and experts) onto
:class:`~repro_torch.runtime.cluster.PIMCluster` stacks as contiguous
blocks — :func:`ame_pim_layer_stacks` / :func:`ame_pim_stack_map`,
consumed by :class:`repro_torch.serve.offload.DecodeOffload` — and
:func:`ame_pim_expert_placement` places a routed MoE expert bank by
expected token mass.  Pure host code; the placements are ``==`` to the
reference's.  The mesh ``PartitionSpec`` half of the reference module
is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

from repro_torch.configs.base import ArchConfig


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
