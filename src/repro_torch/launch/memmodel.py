"""Analytic per-device memory model, dtype-true (port of
``repro.launch.memmodel``).

What one device holds: parameters + gradients + optimizer moments
(int8/factored aware) + the saved residual stack + decode caches, all
divided by their actual shard counts.  ``hbm_bytes`` is the capacity the
total is compared with; it defaults to the card's
(:data:`repro_torch.launch.hw.HBM_BYTES`).  The ``fits_16g`` key keeps the
reference's name, so the two packages' dicts compare ``==`` when the
reference's 16 GiB is passed in; it reads "fits in ``hbm_bytes``".
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch import hw
from repro_torch.launch.params import param_shapes
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sharding import rules


def _shards(spec, mesh_axes: Dict[str, int]) -> int:
    n = 1
    for ax in spec:
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= mesh_axes.get(a, 1)
    return n


class _FakeMesh:
    """Sizes only, for ``rules._axis_size`` / ``_fits``."""

    def __init__(self, axes: Dict[str, int]):
        self.shape = axes
        self.axis_names = tuple(axes)


def estimate(cfg: ArchConfig, shape: ShapeSpec,
             mesh_axes: Dict[str, int] | None = None,
             hbm_bytes: float = hw.HBM_BYTES) -> Dict[str, float]:
    mesh_axes = mesh_axes or {"data": 16, "model": 16}
    mesh = _FakeMesh(mesh_axes)
    shapes = param_shapes(cfg)
    pspecs = dict(tree_leaves(rules.param_pspecs(cfg, shapes, mesh)))

    pb = 0.0
    for path, leaf in tree_leaves(shapes):
        pb += math.prod(leaf.shape) * leaf.element_size() / _shards(
            pspecs[path], mesh_axes)

    pol = cfg.policy
    out = {"params": pb}
    if shape.kind == "train":
        out["grads"] = pb  # accumulated in param dtype
        md = {"float32": 4, "bfloat16": 2, "int8": 1}[pol.moment_dtype]
        pdt = 2 if pol.param_dtype == "bfloat16" else 4
        out["m"] = pb / pdt * md
        out["v"] = (pb / pdt * 4 / 128 if pol.factored_v  # rank-1 stats
                    else pb / pdt * md)
        tokens_dev = (shape.global_batch * shape.seq_len
                      / (mesh_axes.get("data", 1) * mesh_axes.get("pod", 1))
                      / pol.microbatches)
        act = cfg.n_layers * tokens_dev * cfg.d_model * 2
        if pol.sp:
            act /= mesh_axes.get("model", 1)
        out["residuals"] = act
        # live intra-block tensors: MoE archs bound by the expert width
        # (+ the dispatch buffer), dense archs by the FFN hidden
        if cfg.moe:
            eff = max(cfg.moe.d_ff_expert, cfg.d_model)
            out["workingset"] = 2 * tokens_dev * eff * 4
            # dispatch buffer (E,G,C,d) shards experts on 'model' (EP) or
            # d_ff on 'model' (TP) — either way /model on top of /data
            out["moe_buffers"] = (tokens_dev * cfg.moe.top_k * cfg.d_model
                                  * 2 * cfg.moe.capacity_factor
                                  / mesh_axes.get("model", 1))
        else:
            out["workingset"] = 2 * tokens_dev * max(cfg.d_ff,
                                                     cfg.d_model * 4) * 4
    elif shape.kind == "prefill":
        tokens_dev = (shape.global_batch * shape.seq_len
                      / max(mesh_axes.get("data", 1), 1))
        out["workingset"] = 4 * tokens_dev * cfg.d_model * 2
        out["caches"] = _cache_bytes(cfg, shape, mesh_axes)
    else:
        out["caches"] = _cache_bytes(cfg, shape, mesh_axes)
        out["workingset"] = 64e6
    out["total"] = sum(out.values())
    out["fits_16g"] = out["total"] < hbm_bytes
    return out


def _cache_bytes(cfg: ArchConfig, shape: ShapeSpec,
                 mesh_axes: Dict[str, int]) -> float:
    b = shape.global_batch
    t = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window \
        else shape.seq_len
    dp = mesh_axes.get("data", 1) * mesh_axes.get("pod", 1)
    bshard = dp if b % dp == 0 else 1
    ms = mesh_axes.get("model", 1)
    if cfg.family == "ssm":
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        nh = d_inner // s.head_dim
        per = nh * s.d_state * s.head_dim * 4 + (s.d_conv - 1) * (
            d_inner + 2 * s.n_groups * s.d_state) * 2
        return cfg.n_layers * b * per / bshard / min(ms, nh)
    if cfg.mla is not None:
        per = (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim) * 2
        return cfg.n_layers * b * t * per / bshard / min(ms, 16)
    kv = 2 * cfg.n_kv_heads * cfg.head_dim_ * 2
    layers = cfg.n_layers
    total = layers * b * t * kv / bshard / ms
    if cfg.hybrid is not None:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        nh = d_inner // s.head_dim
        groups = cfg.n_layers // cfg.hybrid.shared_every
        ssm_b = cfg.n_layers * b * (nh * s.d_state * s.head_dim * 4) / bshard \
            / min(ms, nh)
        attn_b = groups * b * t * kv / bshard / min(ms, cfg.n_kv_heads)
        total = ssm_b + attn_b
    return total
