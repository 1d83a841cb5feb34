"""Blocks and stacks: the dense decoder transformer and the SSM stack.

Port of ``repro.models.transformer`` for the dense and SSM families.
Parameters and caches keep the reference's layer-stacked layout (a
leading L axis under ``dense_stack`` / ``ssm_stack``); a Python loop over
layers replaces ``lax.scan``, and each layer sees views of the stacked
tensors, so cache and state writes land in place.  MoE, MLA and hybrid
stacks wait for their slices.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    TORCH, Backend, apply_norm, mlp, mlp_init, norm_init,
)

_PENDING = ("the {what} stack is not ported yet (ROADMAP.md, queue 1, "
            "item 7: the other model families)")


def check_family(cfg: ArchConfig) -> None:
    """Raise for the families this slice does not run."""
    what = ("moe" if cfg.moe is not None else "mla" if cfg.mla is not None
            else cfg.family if cfg.family == "hybrid" else None)
    if what is not None:
        raise NotImplementedError(_PENDING.format(what=what))


def layer(tree, i: int):
    """Layer ``i`` of a layer-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# attention + mlp block
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ArchConfig, dtype, device, layers: int = 0):
    return {"ln1": norm_init(cfg.d_model, dtype, device, cfg.norm, layers),
            "ln2": norm_init(cfg.d_model, dtype, device, cfg.norm, layers),
            "attn": attn_mod.attn_init(gen, cfg, dtype, device, layers),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                            device, layers)}


def block_apply(p, h, cfg: ArchConfig, *, positions, cache=None,
                backend: Backend = TORCH, causal=True):
    x = apply_norm(p["ln1"], h, cfg.norm_eps)
    a, new_cache = attn_mod.attention_apply(
        p["attn"], x, cfg, positions=positions, cache=cache,
        backend=backend, causal=causal)
    h = h + a
    x = apply_norm(p["ln2"], h, cfg.norm_eps)
    h = h + mlp(p["mlp"], x, cfg.act, backend)
    return h, new_cache


# ---------------------------------------------------------------------------
# dense decoder stack
# ---------------------------------------------------------------------------


def decoder_init(gen, cfg: ArchConfig, dtype, device) -> Dict:
    check_family(cfg)
    return {"dense_stack": block_init(gen, cfg, dtype, device,
                                      layers=cfg.n_layers)}


def decoder_make_caches(cfg: ArchConfig, batch: int, length: int, dtype,
                        device) -> Dict:
    check_family(cfg)
    return {"dense_stack": attn_mod.make_cache(cfg, batch, length, dtype,
                                               device, layers=cfg.n_layers)}


def decoder_apply(p, h, cfg: ArchConfig, *, positions,
                  caches: Optional[Dict] = None, backend: Backend = TORCH,
                  causal=True):
    """Returns ``(h, caches)``; ``caches`` is updated in place."""
    stack = p["dense_stack"]
    for i in range(cfg.n_layers):
        c = layer(caches["dense_stack"], i) if caches is not None else None
        h, _ = block_apply(layer(stack, i), h, cfg, positions=positions,
                           cache=c, backend=backend, causal=causal)
    return h, caches


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
    """Returns ``(h, caches)``; the states in ``caches`` are overwritten
    in place with each layer's new state."""
    stack = p["ssm_stack"]
    for i in range(cfg.n_layers):
        lp = layer(stack, i)
        st = layer(caches["ssm_stack"], i) if caches is not None else None
        x = apply_norm(lp["ln"], h, cfg.norm_eps)
        y, ns = ssm_mod.mamba_apply(lp["mamba"], x, cfg, state=st,
                                    backend=backend)
        h = h + y
        if st is not None:
            st["conv"].copy_(ns["conv"])
            st["ssm"].copy_(ns["ssm"])
    return h, caches
