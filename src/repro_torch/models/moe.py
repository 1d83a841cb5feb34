"""Mixture-of-Experts: grouped one-hot dispatch (Switch/T5X style) and
DeepSeek-V3's routing over a share of the experts.

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

``MoEConfig(scoring="sigmoid")`` takes DeepSeek-V3's published routing
instead (:func:`moe_sigmoid`, a path of the port's own, without a
mesh): group-limited sigmoid scores with a correction bias, no drops,
and an expert bank that may hold a share of the experts (``held``, as
one chip of expert parallelism does), whose products all go through
``dense()``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    TORCH, Backend, dense_init, mlp, mlp_init, normal, out_constrain,
)
from repro_torch.obs import spans
from repro_torch.sharding.context import constrain, einsum, matmul

GROUP_SIZE = 256


def moe_init(gen, cfg: ArchConfig, dtype, device, layers: int = 0):
    """``router`` (d, E), the expert bank ``experts/{wi,wg}`` (E, d, f) and
    ``experts/wo`` (E, f, d), and the ``shared`` experts' MLP when
    ``n_shared``; a leading L axis when ``layers``.  Under the sigmoid
    routing the router has a correction ``bias`` (E,) (zero here; a
    checkpoint's is trained) and the bank holds the ``held`` experts
    alone."""
    m = cfg.moe
    if m.held and m.scoring != "sigmoid":
        raise ValueError("a share of the experts (held) needs the sigmoid "
                         "routing, which drops no token")
    d, e, f = cfg.d_model, m.held or m.num_experts, m.d_ff_expert
    lead = (layers,) if layers else ()
    p = {"router": dense_init(gen, d, m.num_experts, dtype, device,
                              layers=layers),
         "experts": {
             "wi": normal(lead + (e, d, f), gen, device, dtype, d ** -0.5),
             "wg": normal(lead + (e, d, f), gen, device, dtype, d ** -0.5),
             "wo": normal(lead + (e, f, d), gen, device, dtype, f ** -0.5)}}
    if m.scoring == "sigmoid":
        p["router"]["bias"] = torch.zeros(lead + (m.num_experts,),
                                          dtype=dtype, device=device)
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


def route_sigmoid(logits: torch.Tensor, bias: torch.Tensor,
                  cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's ``noaux_tc`` routing of router logits (N, E) in f32
    -> ``(weights, idx)``, each (N, top_k): s = sigmoid(logits) and c = s +
    bias; a group's score is the sum of its two largest c, the
    ``topk_group`` best of ``n_group`` groups stay and c = -inf elsewhere;
    idx is the top-k of c (the lower index first among equal values, as
    :func:`top_k`), weights the s there normalised to sum to 1, times
    ``routed_scale``."""
    m = cfg.moe
    s = torch.sigmoid(logits)
    c = s + bias.float()
    n, e = c.shape
    grp = c.reshape(n, m.n_group, e // m.n_group)
    _, keep = top_k(top_k(grp, 2)[0].sum(-1), m.topk_group)
    out = torch.ones((n, m.n_group), dtype=torch.bool, device=c.device)
    out.scatter_(1, keep, False)
    c = grp.masked_fill(out[..., None], float("-inf")).reshape(n, e)
    _, idx = top_k(c, m.top_k)
    w = s.gather(1, idx)
    return w / w.sum(-1, keepdim=True) * m.routed_scale, idx


def _expert(bank, e: int, x: torch.Tensor, cfg: ArchConfig,
            backend: Backend) -> torch.Tensor:
    """Expert ``e`` of the bank on rows x (N, d): three ``dense()``
    products, so K1 on the kernel backend."""
    return mlp({k: {"w": bank[k][e]} for k in ("wi", "wg", "wo")}, x,
               cfg.act, backend, policy=cfg.policy)


def _count(rec, local: torch.Tensor, n_held: int) -> None:
    """The counters of a ``model.experts`` span, kept as device tensors
    (read when the records are): ``routed``, the (row, choice) pairs
    that landed on a held expert, and ``held_reached``, the held experts
    with at least one; in a decode step only the rows the server marks
    live (``rec.live``) count."""
    pairs = F.one_hot(local, n_held + 1)[..., :n_held].sum(1)   # (N, held)
    if rec.live is not None:
        pairs = pairs * rec.live[:, None]
    rec.note(routed=pairs.sum(), held_reached=(pairs.sum(0) > 0).sum())


def moe_sigmoid(p, x: torch.Tensor, cfg: ArchConfig,
                backend: Backend = TORCH) -> torch.Tensor:
    """DeepSeek-V3's MoE on x (B,T,d): the shared expert on every token
    plus, for each token's choices among the experts held here, the
    expert's output times its weight (:func:`route_sigmoid`; router in
    f32 from the compute-dtype hidden state).  Choices of experts held
    elsewhere add nothing; no token is dropped.

    Two exact forms.  A decode step (T == 1) runs each held expert over
    every row, its output times the row's gate, 0 where the row did not
    choose it: nothing depends on the routing's values on the host, so
    the step takes no sync, and it reads each expert's weights once, as
    it would for any row.  A prefill gathers each held expert's rows
    (one sync a layer, for the counts) and adds each product back into
    its rows.  Under a span recorder the held experts' products are a
    ``model.experts`` span with its counters."""
    m = cfg.moe
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    w, idx = route_sigmoid(x2.float() @ p["router"]["w"].float(),
                           p["router"]["bias"], cfg)
    n_held = m.held or m.num_experts
    local = idx - m.held_from           # place in this bank, n_held: not here
    local = torch.where((local >= 0) & (local < n_held), local, n_held)
    bank = p["experts"]
    y = torch.zeros((b * t, d), dtype=torch.float32, device=x.device)
    rec = spans.ACTIVE
    if rec is not None:
        sid = rec.open("model.experts")
        _count(rec, local, n_held)
    if t == 1:
        gate = torch.zeros((b, n_held + 1), dtype=torch.float32,
                           device=x.device).scatter_add_(1, local, w)
        for e in range(n_held):
            y.addcmul_(gate[:, e:e + 1], _expert(bank, e, x2, cfg, backend))
    else:
        flat = local.reshape(-1)
        counts = torch.bincount(flat, minlength=n_held + 1).tolist()
        order = torch.argsort(flat, stable=True)
        rows, wts = order // m.top_k, w.reshape(-1)[order]
        at = 0
        for e, n in enumerate(counts[:n_held]):
            if n:
                r = rows[at:at + n]
                y.index_add_(0, r, _expert(bank, e, x2[r], cfg, backend)
                             * wts[at:at + n, None])
            at += n
    if rec is not None:
        rec.close(sid)
    if m.n_shared:
        y += mlp(p["shared"], x2, cfg.act, backend, policy=cfg.policy)
    return y.to(x.dtype).reshape(b, t, d)


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig,
              backend: Backend = TORCH) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,d) -> (y, aux_loss); the sigmoid routing has no auxiliary
    loss (0.0) and runs :func:`moe_sigmoid`."""
    m = cfg.moe
    if m.scoring == "sigmoid":
        return moe_sigmoid(p, x, cfg, backend), 0.0
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
