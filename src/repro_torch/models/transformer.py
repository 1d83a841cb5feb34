"""Blocks and stacks: the decoder transformer (dense, MoE, MLA), the SSM
stack and the Zamba2 hybrid.

Port of ``repro.models.transformer`` for the text decoder families.
Parameters and caches keep the reference's layer-stacked layout (a
leading L axis under ``dense_stack`` / ``moe_stack`` / ``ssm_stack`` /
``groups``); a Python loop over layers replaces ``lax.scan``, and each
layer sees views of the stacked tensors, so cache and state writes land
in place.  Every stack returns ``(h, caches, aux)`` as the reference's
does: ``aux`` sums the MoE layers' load-balance losses, a 0-d f32
tensor, and is the float 0.0 for a stack without MoE layers (no kernel
launch spent on a zero).

Under ``cfg.policy.remat``, a training forward
(no caches, gradients enabled) recomputes each block in backward with
``torch.utils.checkpoint``, where the reference wraps its scan bodies in
``jax.checkpoint``: per block in the decoder and SSM stacks, per group
and per tail layer in the hybrid.  The reference's ``remat_policy``
(``"dots"``, ``"save_collectives"``) chooses what XLA saves; the port
recomputes the whole block under every policy, so memory differs and
results do not.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    TORCH, Backend, apply_norm, dense_init, mlp, mlp_init, norm_init, normal,
)
from repro_torch.obs import spans
from repro_torch.sharding.context import constrain


def constrain_sp(h):
    """The sequence-parallel residual stream: seq sharded over 'model'."""
    return constrain(h, "batch", "model", None)


def layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def unstack(tree, n: int) -> List:
    """The ``n`` layers of a layer-stacked tree, as views.  One ``unbind``
    per leaf: in backward the layers' gradients are stacked once, where
    indexing each layer would scatter each into a zeroed copy of the whole
    stack."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        per = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(tree.unbind(0))


def _remat(fn, cfg: ArchConfig, caches):
    """``fn`` recomputed in backward under ``cfg.policy.remat`` in a
    training forward (no caches, gradients enabled)."""
    if not (cfg.policy.remat and caches is None and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# attention + (mlp | moe) block
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ArchConfig, dtype, device, layers: int = 0,
               use_moe: bool = False):
    p = {"ln1": norm_init(cfg.d_model, dtype, device, cfg.norm, layers),
         "ln2": norm_init(cfg.d_model, dtype, device, cfg.norm, layers)}
    if cfg.mla is not None:
        p["attn"] = attn_mod.mla_init(gen, cfg, dtype, device, layers)
    else:
        p["attn"] = attn_mod.attn_init(gen, cfg, dtype, device, layers)
    if use_moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, device, layers)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            device, layers)
    return p


def block_apply(p, h, cfg: ArchConfig, *, positions, cache=None,
                backend: Backend = TORCH, causal=True):
    """Returns ``(h, cache, aux)``; ``aux`` is the MoE load-balance loss
    (0.0 for an MLP block).  Under a span recorder each half, its norm
    and residual included, is a span: ``model.attention``, then
    ``model.mlp`` (the MLP or the MoE)."""
    rec = spans.ACTIVE
    if rec is not None:
        sid = rec.open("model.attention")
    x = apply_norm(p["ln1"], h, cfg.norm_eps)
    if cfg.mla is not None:
        a, new_cache = attn_mod.mla_apply(p["attn"], x, cfg,
                                          positions=positions, cache=cache,
                                          backend=backend)
    else:
        a, new_cache = attn_mod.attention_apply(
            p["attn"], x, cfg, positions=positions, cache=cache,
            backend=backend, causal=causal)
    h = h + a
    if rec is not None:
        rec.close(sid)
        sid = rec.open("model.mlp")
    x = apply_norm(p["ln2"], h, cfg.norm_eps)
    if "moe" in p:
        y, aux = moe_mod.moe_apply(p["moe"], x, cfg, backend)
    else:
        y, aux = mlp(p["mlp"], x, cfg.act, backend, policy=cfg.policy), 0.0
    h = h + y
    if rec is not None:
        rec.close(sid)
    if cfg.policy.sp and h.shape[1] > 1:
        # sequence-parallel residual stream (Megatron-SP posture)
        h = constrain_sp(h)
    return h, new_cache, aux


# ---------------------------------------------------------------------------
# uniform stack (dense / moe with leading dense layers)
# ---------------------------------------------------------------------------


def _stack_sizes(cfg: ArchConfig):
    """``(dense_stack, moe_stack)`` layer counts: the first
    ``first_dense_layers`` layers of an MoE model are dense."""
    fd = min(cfg.moe.first_dense_layers if cfg.moe else cfg.n_layers,
             cfg.n_layers)
    return fd, cfg.n_layers - fd


def decoder_init(gen, cfg: ArchConfig, dtype, device) -> Dict:
    fd, nm = _stack_sizes(cfg)
    p = {}
    if fd:
        p["dense_stack"] = block_init(gen, cfg, dtype, device, layers=fd)
    if nm:
        p["moe_stack"] = block_init(gen, cfg, dtype, device, layers=nm,
                                    use_moe=True)
    return p


def decoder_make_caches(cfg: ArchConfig, batch: int, length: int, dtype,
                        device) -> Dict:
    """One KV cache per layer (an MLA model's latent ``{ckv, kr}``), in
    the stacks of :func:`decoder_init`."""
    mk = attn_mod.mla_make_cache if cfg.mla is not None \
        else attn_mod.make_cache
    return {name: mk(cfg, batch, length, dtype, device, layers=n)
            for name, n in zip(("dense_stack", "moe_stack"),
                               _stack_sizes(cfg)) if n}


def decoder_apply(p, h, cfg: ArchConfig, *, positions,
                  caches: Optional[Dict] = None, backend: Backend = TORCH,
                  causal=True):
    """Returns ``(h, caches, aux)``; ``caches`` is updated in place and
    ``aux`` sums every MoE layer's load-balance loss."""

    def block(lp, c, h):
        h, _, a = block_apply(lp, h, cfg, positions=positions, cache=c,
                              backend=backend, causal=causal)
        return h, a
    run = _remat(block, cfg, caches)
    aux = 0.0
    for name in ("dense_stack", "moe_stack"):
        if name not in p:
            continue
        n = p[name]["ln1"]["scale"].shape[0]
        cs = unstack(caches[name] if caches is not None else None, n)
        for lp, c in zip(unstack(p[name], n), cs):
            h, a = run(lp, c, h)
            aux = aux + a
    return h, caches, aux


# ---------------------------------------------------------------------------
# SSM stack (mamba2)
# ---------------------------------------------------------------------------


def ssm_stack_init(gen, cfg: ArchConfig, dtype, device) -> Dict:
    n = cfg.n_layers
    return {"ssm_stack": {
        "ln": norm_init(cfg.d_model, dtype, device, cfg.norm, n),
        "mamba": ssm_mod.mamba_init(gen, cfg, dtype, device, layers=n)}}


def ssm_make_states(cfg: ArchConfig, batch: int, length: int, dtype,
                    device) -> Dict:
    """``length`` is unused: the recurrent state does not grow."""
    return {"ssm_stack": ssm_mod.mamba_make_state(cfg, batch, dtype, device,
                                                  layers=cfg.n_layers)}


def ssm_stack_apply(p, h, cfg: ArchConfig, *, positions=None,
                    caches: Optional[Dict] = None, backend: Backend = TORCH,
                    causal=True):
    """Returns ``(h, caches, 0.0)``; the states in ``caches`` are
    overwritten in place with each layer's new state."""
    run = _remat(lambda lp, st, h: _mamba_layer(lp, st, h, cfg, backend),
                 cfg, caches)
    n = cfg.n_layers
    states = caches["ssm_stack"] if caches is not None else None
    for lp, st in zip(unstack(p["ssm_stack"], n), unstack(states, n)):
        h = run(lp, st, h)
    return h, caches, 0.0


def _mamba_stack_init(gen, cfg: ArchConfig, dtype, device, n: int) -> Dict:
    return {"ln": norm_init(cfg.d_model, dtype, device, cfg.norm, n),
            "mamba": ssm_mod.mamba_init(gen, cfg, dtype, device, layers=n)}


def _mamba_layer(lp, st, h, cfg: ArchConfig, backend):
    """One mamba layer ``lp`` on ``h`` (pre-norm, residual); its state
    ``st`` (or none) is overwritten in place."""
    x = apply_norm(lp["ln"], h, cfg.norm_eps)
    y, ns = ssm_mod.mamba_apply(lp["mamba"], x, cfg, state=st,
                                backend=backend)
    if st is not None:
        st["conv"].copy_(ns["conv"])
        st["ssm"].copy_(ns["ssm"])
    return h + y


# ---------------------------------------------------------------------------
# Zamba2 hybrid: mamba backbone + shared attention blocks every k layers
# ---------------------------------------------------------------------------


def hybrid_init(gen, cfg: ArchConfig, dtype, device) -> Dict:
    """``groups`` (n_layers // shared_every groups of mamba layers, one
    stack), ``shared`` (n_shared_blocks blocks, each with its (2d, d)
    input projection), the per-application LoRA pair ``lora_a`` /
    ``lora_b`` (zero at init, as in the reference) and, when shared_every
    does not divide n_layers, the ``tail`` mamba layers."""
    hy, d = cfg.hybrid, cfg.d_model
    groups, tail = divmod(cfg.n_layers, hy.shared_every)
    ns = hy.n_shared_blocks
    p = {
        "groups": _mamba_stack_init(gen, cfg, dtype, device,
                                    groups * hy.shared_every),
        "shared": {"in_proj": dense_init(gen, 2 * d, d, dtype, device,
                                         layers=ns),
                   "block": block_init(gen, cfg, dtype, device, layers=ns)},
        "lora_a": normal((groups, 2 * d, hy.lora_rank), gen, device, dtype,
                         (2 * d) ** -0.5),
        "lora_b": torch.zeros((groups, hy.lora_rank, d), dtype=dtype,
                              device=device),
    }
    if tail:
        p["tail"] = _mamba_stack_init(gen, cfg, dtype, device, tail)
    return p


def hybrid_make_caches(cfg: ArchConfig, batch: int, length: int, dtype,
                       device) -> Dict:
    """Recurrent states of every mamba layer and one KV cache per group
    (each application of a shared block keeps its own)."""
    every = cfg.hybrid.shared_every
    groups, tail = divmod(cfg.n_layers, every)
    c = {"groups": ssm_mod.mamba_make_state(cfg, batch, dtype, device,
                                            layers=groups * every),
         "shared_kv": attn_mod.make_cache(cfg, batch, length, dtype, device,
                                          layers=groups)}
    if tail:
        c["tail"] = ssm_mod.mamba_make_state(cfg, batch, dtype, device,
                                             layers=tail)
    return c


def lora_merged_in_proj(p, g: int, cfg: ArchConfig, dtype) -> torch.Tensor:
    """Group ``g``'s shared input projection ``w + lora_a[g] @ lora_b[g]``
    (2d, d) in ``dtype``, every operand cast first, as in the reference:
    a (2d, d) product and sum built anew for every application."""
    w = p["shared"]["in_proj"]["w"][g % cfg.hybrid.n_shared_blocks]
    return w.to(dtype) + p["lora_a"][g].to(dtype) @ p["lora_b"][g].to(dtype)


def hybrid_apply(p, h, cfg: ArchConfig, *, positions,
                 caches: Optional[Dict] = None, backend: Backend = TORCH,
                 causal=True):
    """Group ``g`` runs mamba layers ``g*every .. g*every+every-1``, then
    shared block ``g % n_shared_blocks`` once on ``[h, e0] @ (w + A_g B_g)``
    (e0 the original embeddings; a plain product, as in the reference,
    whose merged projection is not ``dense()``), with the residual on the
    block's delta.  The tail runs last.  Returns ``(h, caches, 0.0)``;
    caches are updated in place."""
    hy = cfg.hybrid
    every = hy.shared_every
    groups, tail = divmod(cfg.n_layers, every)
    mambas = unstack(p["groups"], groups * every)
    states = unstack(caches["groups"] if caches is not None else None,
                     groups * every)
    blocks = unstack(p["shared"]["block"], hy.n_shared_blocks)
    kvs = unstack(caches["shared_kv"] if caches is not None else None,
                  groups)

    def group(g, h, e0):
        for i in range(g * every, (g + 1) * every):
            h = _mamba_layer(mambas[i], states[i], h, cfg, backend)
        cat = torch.cat([h, e0.expand(h.shape)], -1)
        xin = cat @ lora_merged_in_proj(p, g, cfg, cat.dtype)
        y, _, _ = block_apply(blocks[g % hy.n_shared_blocks], xin, cfg,
                              positions=positions, cache=kvs[g],
                              backend=backend, causal=True)
        return h + (y - xin)               # residual on the block's delta
    run = _remat(group, cfg, caches)
    e0 = h
    for g in range(groups):
        h = run(g, h, e0)
    if "tail" in p:
        run = _remat(lambda lp, st, h: _mamba_layer(lp, st, h, cfg, backend),
                     cfg, caches)
        for lp, st in zip(unstack(p["tail"], tail),
                          unstack(caches["tail"] if caches is not None
                                  else None, tail)):
            h = run(lp, st, h)
    return h, caches, 0.0
