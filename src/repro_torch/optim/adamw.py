"""AdamW with large-scale memory policies (port of ``repro.optim.adamw``).

Moment storage is policy-driven (``configs.base.Policy``):
  * moment_dtype: float32 | bfloat16 | int8   (int8 = blockwise-quantized
    8-bit Adam: per-row absmax scales, the second moment kept in the sqrt
    domain)
  * factored_v: Adafactor-style rank-1 second moment for >=2D tensors.

Also: global-norm clipping, decoupled weight decay with a mask, linear
warmup + cosine decay schedule.

The reference's arithmetic is kept to the bit where it is elementwise:
the schedule and the bias corrections are f32 tensors (``c.b1 ** step``
in f32, as ``jnp`` computes it), Python constants enter as f32, rounding
is half-to-even as ``jnp.round``'s, and no ``scalar / tensor`` is taken
as a reciprocal.  Reductions (the global norm, the factored means) sum
in another order than XLA's.

The state lives in tensors that :func:`apply` updates in place, and so do
the parameters: at full width a second copy of either would not fit
beside the first.  Layer-stacked leaves above ``CHUNK_BYTES`` are updated
in dim-0 slices, so the f32 temporaries stay one layer's size.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    factored_v: bool = False


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as a 0-d f32 tensor beside ``like``."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``end_lr_frac * peak_lr`` at ``total_steps``; f32 throughout."""
    step = step.float()
    warm = c.peak_lr * step / max(c.warmup_steps, 1)
    prog = torch.clamp((step - c.warmup_steps)
                       / max(c.total_steps - c.warmup_steps, 1), 0.0, 1.0)
    cos = c.peak_lr * (c.end_lr_frac + (1 - c.end_lr_frac)
                       * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < c.warmup_steps, warm, cos)


# -- int8 blockwise moment codec ----------------------------------------------


def _q8_encode(x: torch.Tensor, sqrt_domain: bool = False) -> Dict:
    """Per-row (last-dim) absmax int8 quantization; non-negative tensors
    (the second moment) are stored in the sqrt domain."""
    if sqrt_domain:
        x = torch.sqrt(torch.clamp(x, min=0.0))
    absmax = torch.amax(torch.abs(x), -1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale.float()}


def _q8_decode(enc: Dict, sqrt_domain: bool = False) -> torch.Tensor:
    x = enc["q"].float() * enc["s"]
    return torch.square(x) if sqrt_domain else x


def _encode_moment(x: torch.Tensor, dtype: str, sqrt_domain: bool = False):
    if dtype == "int8":
        return _q8_encode(x, sqrt_domain)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.float()


def _decode_moment(enc, dtype: str, sqrt_domain: bool = False):
    if dtype == "int8":
        return _q8_decode(enc, sqrt_domain)
    return enc.float()


# -- factored second moment ----------------------------------------------------


def _v_init(p: torch.Tensor, c: AdamWConfig):
    if c.factored_v and p.dim() >= 2:
        return {"r": torch.zeros(p.shape[:-1], device=p.device),
                "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                 device=p.device)}
    return _encode_moment(torch.zeros(p.shape, device=p.device),
                          c.moment_dtype)


def _v_update(v, g2: torch.Tensor, c: AdamWConfig):
    """Returns (new_v_store, v_hat_full)."""
    if c.factored_v and g2.dim() >= 2:
        r = c.b2 * v["r"] + (1 - c.b2) * g2.mean(-1)
        col = c.b2 * v["c"] + (1 - c.b2) * g2.mean(-2)
        denom = torch.clamp(r.mean(-1, keepdim=True), min=1e-30)
        vhat = (r / denom)[..., None] * col[..., None, :]
        return {"r": r, "c": col}, vhat
    vv = c.b2 * _decode_moment(v, c.moment_dtype, sqrt_domain=True) \
        + (1 - c.b2) * g2
    return _encode_moment(vv, c.moment_dtype, sqrt_domain=True), vv


# -- trees ---------------------------------------------------------------------


def tree_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of a nested dict in sorted-key order (the order of
    ``jax.tree_util``), paths joined by '/'."""
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from tree_leaves(tree[k], path)
        else:
            yield path, tree[k]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *leaves)`` over nested dicts of one structure, keeping
    it; leaves are visited in :func:`tree_leaves`' order."""
    return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
            if isinstance(tree[k], dict)
            else fn(tree[k], *(r[k] for r in rest)) for k in sorted(tree)}


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


# -- public API ----------------------------------------------------------------


def init(params, c: AdamWConfig) -> Dict[str, Any]:
    """Zero moments beside each parameter, and ``step`` 0 (int32)."""
    m = tree_map(lambda p: _encode_moment(
        torch.zeros(p.shape, device=p.device), c.moment_dtype), params)
    v = tree_map(lambda p: _v_init(p, c), params)
    dev = next(tree_leaves(params))[1].device
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


CHUNK_BYTES = 256 * 2 ** 20    # slice dim0 of leaves above this (f32 temps)


def _is_big(x: torch.Tensor) -> bool:
    return x.dim() >= 3 and x.numel() * 4 > CHUNK_BYTES


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaf by leaf in
    tree order; a big leaf is summed a dim-0 slice at a time, so its f32
    square never exists whole."""
    def sumsq(x):
        if _is_big(x):
            return torch.sum(torch.stack(
                [torch.sum(torch.square(s.float())) for s in x.unbind(0)]))
        return torch.sum(torch.square(x.float()))
    return torch.sqrt(sum(sumsq(x) for _, x in tree_leaves(tree)))


def _decay_mask(path: str) -> bool:
    """No weight decay on norms, biases, scalars."""
    return not any(s in path for s in ("scale", "bias", "a_log", "d_skip",
                                       "dt_bias", "ln", "norm", "mask_emb"))


def _assign(dst, src) -> None:
    """Copy a moment (a tensor or a ``{q, s}`` / ``{r, c}`` dict) into its
    store in place."""
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(src[k])
    else:
        dst.copy_(src)


def _slice(x, i: int):
    return {k: v[i] for k, v in x.items()} if isinstance(x, dict) else x[i]


@torch.no_grad()
def apply(params, grads, state, c: AdamWConfig):
    """One AdamW step.  ``params`` and the moments of ``state`` are
    updated in place; returns ``(params, new_state, metrics)`` with
    ``metrics = {"lr", "grad_norm"}`` as 0-d f32 tensors."""
    step = state["step"] + 1
    lr = schedule(c, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(torch.div(_f32(c.clip_norm, gnorm),
                                 torch.clamp(gnorm, min=1e-12)), max=1.0)
    stepf = step.float()
    b1c = 1 - torch.pow(_f32(c.b1, stepf), stepf)
    b2c = 1 - torch.pow(_f32(c.b2, stepf), stepf)

    def body(p, g, m, v, decay):
        g32 = g.float() * clip
        mm = c.b1 * _decode_moment(m, c.moment_dtype) + (1 - c.b1) * g32
        v_new, vhat = _v_update(v, torch.square(g32), c)
        u = (mm / b1c) / (torch.sqrt(vhat / b2c) + c.eps)
        if decay:
            u = u + c.weight_decay * p.float()
        p.copy_((p.float() - lr * u).to(p.dtype))
        _assign(m, _encode_moment(mm, c.moment_dtype))
        _assign(v, v_new)

    for path, p in tree_leaves(params):
        g, m, v = _at(grads, path), _at(state["m"], path), \
            _at(state["v"], path)
        decay = bool(c.weight_decay) and _decay_mask(path)
        if _is_big(p):   # one dim-0 slice at a time: small f32 temporaries
            for i in range(p.shape[0]):
                body(p[i], g[i], _slice(m, i), _slice(v, i), decay)
        else:
            body(p, g, m, v, decay)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics


def from_policy(policy, total_steps: int = 10_000,
                peak_lr: float = 3e-4) -> AdamWConfig:
    return AdamWConfig(peak_lr=peak_lr, total_steps=total_steps,
                       moment_dtype=policy.moment_dtype,
                       factored_v=policy.factored_v)
