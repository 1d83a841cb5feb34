"""Mixture-of-Experts with grouped one-hot dispatch (Switch/T5X style).

Port of ``repro.models.moe``.  Tokens split into groups of at most
``GROUP_SIZE``; each group dispatches into a per-group, per-expert
capacity buffer through one-hot products:

   combine  (G, S, E, C)    gate value of token s in slot c of expert e
   buffers  (E, G, C, d)    every expert runs on its whole buffer

A token beyond an expert's capacity is dropped from that expert (its
output is then the shared expert's, or zero).  The reference computes the
router, the dispatch/combine and the expert products in plain jnp outside
any Pallas kernel, so here they are plain ``torch.matmul`` / einsums
(``sharding.context.einsum``: ``torch.einsum``, on local shards under a
mesh); only the shared expert's MLP goes through ``dense()``
and so through the backend's GEMM.  The reference's sharding constraints
are made at the same places (experts on 'model' under EP, the expert
width under TP); they are no-ops without a mesh.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    TORCH, Backend, dense_init, mlp, mlp_init, normal, out_constrain,
)
from repro_torch.sharding.context import constrain, einsum, matmul

GROUP_SIZE = 256


def moe_init(gen, cfg: ArchConfig, dtype, device, layers: int = 0):
    """``router`` (d, E), the expert bank ``experts/{wi,wg}`` (E, d, f) and
    ``experts/wo`` (E, f, d), and the ``shared`` experts' MLP when
    ``n_shared``; a leading L axis when ``layers``."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
    lead = (layers,) if layers else ()
    p = {"router": dense_init(gen, d, e, dtype, device, layers=layers),
         "experts": {
             "wi": normal(lead + (e, d, f), gen, device, dtype, d ** -0.5),
             "wg": normal(lead + (e, d, f), gen, device, dtype, d ** -0.5),
             "wo": normal(lead + (e, f, d), gen, device, dtype, f ** -0.5)}}
    if m.n_shared:
        p["shared"] = mlp_init(gen, d, f * m.n_shared, cfg.act, dtype,
                               device, layers)
    return p


def _group(s: int, target: int = GROUP_SIZE) -> int:
    g = max(1, s // target)
    while s % g:
        g -= 1
    return g


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest values along the last axis and their indices,
    the lower index first among equal values (``jax.lax.top_k``'s order,
    which ``torch.topk`` does not promise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, cfg: ArchConfig, cap: int, cdt
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits (G, S, E) in f32 -> ``(combine, aux)``: the gate of
    each kept (token, expert) pair in its capacity slot, (G, S, E, cap) in
    ``cdt``, and the Switch-style load-balance loss (before drops).

    A token's position in an expert's buffer counts the group's tokens
    routed there before it, earlier top-k choices first: choice ``i`` of
    every token is placed after all accepted choices ``< i``."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    g, sg = logits.shape[:2]
    dev = logits.device
    probs = torch.softmax(logits, -1)                       # (G,S,E)
    gate_vals, idx = top_k(probs, k)                        # (G,S,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    frac = F.one_hot(idx, e).float().mean((0, 1, 2))
    aux = m.aux_loss_weight * e * torch.sum(frac * probs.mean((0, 1)))

    combine = torch.zeros((g, sg, e, cap), dtype=cdt, device=dev)
    base = torch.zeros((g, 1, e), device=dev)
    slots = torch.arange(cap, device=dev)
    for i in range(k):
        oh = F.one_hot(idx[..., i], e).float()              # (G,S,E)
        pos = torch.cumsum(oh, 1) - oh + base
        ok = (pos < cap).float() * oh
        # one-hot of the slot; a position past the capacity has none
        slot = (pos.long()[..., None] == slots).to(cdt)     # (G,S,E,C)
        combine = combine + gate_vals[..., i, None, None].to(cdt) \
            * (ok[..., None].to(cdt) * slot)
        base = base + ok.sum(1, keepdim=True)   # accepted so far per expert
    return combine, aux


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig,
              backend: Backend = TORCH) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,d) -> (y, aux_loss)."""
    m = cfg.moe
    b, t, d = x.shape
    s = b * t
    g = _group(s)
    sg = s // g
    cap = max(int(m.capacity_factor * sg * m.top_k / m.num_experts), 1)
    ep = m.sharding == "ep"

    xg = x.reshape(g, sg, d)
    xg = constrain(xg, "batch", None, None)
    logits = matmul(xg, p["router"]["w"].to(x.dtype)).float()
    # combine/dispatch ride in the compute dtype, as in the reference
    combine, aux = route(logits, cfg, cap, x.dtype)
    combine = constrain(combine, "batch", None, "model" if ep else None,
                        None)
    dispatch = (combine > 0).to(x.dtype)

    # dispatch: (G,S,E,C) x (G,S,d) -> (E,G,C,d) — the EP all-to-all
    buf = einsum("gsec,gsd->egcd", dispatch, xg)
    buf = constrain(buf, "model" if ep else None, "batch", None, None)
    w = p["experts"]
    h = einsum("egcd,edf->egcf", buf, w["wi"].to(x.dtype))
    hg = einsum("egcd,edf->egcf", buf, w["wg"].to(x.dtype))
    h = F.silu(hg) * h
    h = constrain(h, "model" if ep else None, "batch", None,
                  None if ep else "model")
    out = einsum("egcf,efd->egcd", h, w["wo"].to(x.dtype))
    out = constrain(out, "model" if ep else None, "batch", None, None)
    y = einsum("gsec,egcd->gsd", combine, out).reshape(b, t, d)
    if m.n_shared:
        y = y + mlp(p["shared"], x, cfg.act, backend, policy=cfg.policy)
    return out_constrain(y, cfg.policy), aux
