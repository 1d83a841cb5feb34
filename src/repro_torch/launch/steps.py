"""Sharded step builders: train / prefill / decode (port of
``repro.launch.steps``).

Each builder returns ``(fn, arg_shapes, arg_specs)`` as the reference's
does: the shapes are meta tensors (the reference's ``ShapeDtypeStruct``
trees) and the specs are :class:`~repro_torch.sharding.context.P` trees.
``fn`` takes and returns DTensors placed by those specs
(:func:`repro_torch.sharding.rules.distribute` places a plain tree) and
runs eagerly under the mesh, where the reference jits with
``in_shardings``/``out_shardings``: DTensor propagates the shardings op
by op, the models' ``constrain`` calls redistribute, and the dense
products run on local shards (``models.layers.sharded_matmul``).  Plain
tensors created inside the model (positions, masks) count as replicated.

``donate`` means in place: with it the train step updates the parameter
and optimizer DTensors it is given (AdamW is in place) and the decode step
writes the caches it is given; without it they are copied first.  As in
the reference, no step reads ``policy.grad_compression``
(``optim.compression.psum_compressed`` is a function of its own).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ArchConfig, ShapeSpec, input_specs
from repro_torch.models import model as lm
from repro_torch.models.layers import TORCH, Backend, as_backend
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.sharding.context import P, axis_names, axis_sizes, use_mesh


def abstract_params(cfg: ArchConfig):
    """The parameter tree as meta tensors (no allocation)."""
    return lm.init(cfg, None, device="meta")


def abstract_opt(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig):
    return adamw.init(abstract_params(cfg), opt_cfg)


def _clone(tree):
    return adamw.tree_map(lambda x: x.detach().clone(), tree)


def _full(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _split_microbatches(batch: Dict, mb: int):
    """(B, ...) -> (mb, B // mb, ...): microbatch ``i`` is rows
    ``i*B/mb .. (i+1)*B/mb - 1``, as the reference reshapes."""
    return {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])
            for k, x in batch.items()}


def _microbatches(batch: Dict, mb: int, mesh, cfg: ArchConfig):
    """The ``mb`` microbatches of a placed batch, each placed by the batch
    rules at its own size.  A batch sharded on dim 0 holds each
    microbatch's rows on a subset of the data ranks, so it is gathered
    once and every rank cuts its chunks from that copy (the reference's
    ``lax.scan`` over the reshaped batch needs the same: its 0th dim must
    be replicated)."""
    full = _split_microbatches({k: _full(v) for k, v in batch.items()}, mb)
    for i in range(mb):
        mbatch = {k: v[i] for k, v in full.items()}
        yield rules.distribute(mbatch, rules.batch_pspecs(cfg, mbatch, mesh),
                               mesh)


def make_train_step(cfg: ArchConfig, mesh, shape: ShapeSpec,
                    opt_cfg: adamw.AdamWConfig | None = None,
                    backend: Backend = TORCH, donate: bool = True):
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``policy.microbatches`` gradient accumulations (in bf16 when the
    parameters are bf16, else f32, divided by the count), then one AdamW
    step.  The loss is the mean over microbatches, each metric the mean of
    its values, plus AdamW's ``lr``/``grad_norm`` and ``loss_out``;
    metrics come back as plain replicated 0-d tensors."""
    from repro_torch.train.loop import grad_tree
    backend = as_backend(backend)
    opt_cfg = opt_cfg or adamw.from_policy(cfg.policy)
    mb = cfg.policy.microbatches
    accum_dtype = (torch.bfloat16 if cfg.policy.param_dtype == "bfloat16"
                   else torch.float32)

    pshapes = abstract_params(cfg)
    oshapes = adamw.init(pshapes, opt_cfg)
    bshapes = input_specs(cfg, shape)
    pspec = rules.param_pspecs(cfg, pshapes, mesh)
    ospec = rules.opt_pspecs(cfg, oshapes, mesh)
    bspec = rules.batch_pspecs(cfg, bshapes, mesh)
    ppl = rules.to_placements(pspec, mesh)

    def value_and_grad(params, batch):
        loss, mets = lm.loss_fn(params, batch, cfg, backend)
        grads = grad_tree(loss, params)
        # the data-parallel reduction: every gradient takes its
        # parameter's placements (the reference's out_shardings)
        grads = adamw.tree_map(
            lambda g, pl: g.redistribute(mesh, pl)
            if isinstance(g, DTensor) else g, grads, ppl)
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, grads

    def train_step(params, opt_state, batch):
        if not donate:
            params, opt_state = _clone(params), _clone(opt_state)
        params = adamw.tree_map(lambda p: p.requires_grad_(True), params)
        with use_mesh(mesh), implicit_replication():
            if mb == 1:
                loss, metrics, grads = value_and_grad(params, batch)
            else:
                grads = adamw.tree_map(
                    lambda p: torch.zeros_like(p, dtype=accum_dtype),
                    params)
                ls, mets = [], []
                # one accumulator tree, as the reference's scan carry:
                # each microbatch's tree is added in place and dropped
                # before the next backward
                for mbatch in _microbatches(batch, mb, mesh, cfg):
                    l, m, g = value_and_grad(params, mbatch)
                    with torch.no_grad():
                        adamw.tree_map(lambda a, gg: a.add_(gg.to(a.dtype)),
                                       grads, g)
                    del g
                    ls.append(l)
                    mets.append(m)
                with torch.no_grad():
                    adamw.tree_map(lambda g: g.div_(mb), grads)
                loss = torch.stack(ls).mean()
                metrics = {k: torch.stack([m[k] for m in mets]).mean()
                           for k in mets[0]}
            params = adamw.tree_map(lambda p: p.requires_grad_(False),
                                    params)
            params, opt_state, om = adamw.apply(params, grads, opt_state,
                                                opt_cfg)
            metrics = {k: _full(v) for k, v in
                       dict(metrics, **om, loss_out=loss).items()}
        return params, opt_state, metrics

    return train_step, (pshapes, oshapes, bshapes), (pspec, ospec, bspec)


# ---------------------------------------------------------------------------
# serve: prefill + decode
# ---------------------------------------------------------------------------


def _prod(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _batch_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def _place(x, spec: P, mesh):
    """A step output to its spec (the reference's out_shardings)."""
    if not isinstance(x, DTensor):
        return x
    pl = rules.to_placements(spec, mesh)
    return x if list(x.placements) == pl else x.redistribute(mesh, pl)


def make_prefill_step(cfg: ArchConfig, mesh, shape: ShapeSpec,
                      backend: Backend = TORCH):
    """``fn(params, batch) -> (last-position logits, caches)``; the caches
    are made here, placed by the cache rules, and filled in place by the
    model."""
    cache_len = shape.seq_len
    pshapes = abstract_params(cfg)
    bshapes = input_specs(cfg, shape)
    pspec = rules.param_pspecs(cfg, pshapes, mesh)
    bspec = rules.batch_pspecs(cfg, bshapes, mesh)
    cshapes = lm.make_caches(cfg, shape.global_batch, cache_len,
                             device="meta")
    cspec = rules.cache_pspecs(cfg, cshapes, mesh)
    baxes = _batch_axes(mesh)
    lspec = P(baxes if shape.global_batch % _prod(mesh, baxes) == 0
              else None, "model")

    @torch.no_grad()
    def prefill_step(params, batch):
        dev = next(iter(batch.values())).device
        caches = rules.distribute(
            lm.make_caches(cfg, shape.global_batch, cache_len, dev), cspec,
            mesh)
        with use_mesh(mesh), implicit_replication():
            logits, caches = lm.prefill(params, batch, cfg,
                                        cache_len=cache_len, backend=backend,
                                        caches=caches)
            return _place(logits, lspec, mesh), caches

    return prefill_step, (pshapes, bshapes), (pspec, bspec, cspec)


def make_decode_step(cfg: ArchConfig, mesh, shape: ShapeSpec,
                     backend: Backend = TORCH, donate: bool = True):
    """``fn(params, tokens (B,1), positions (B,), caches) -> (logits,
    caches)``; with ``donate`` the caches are written in place."""
    cache_len = (min(shape.seq_len, cfg.sliding_window)
                 if cfg.sliding_window else shape.seq_len)
    b = shape.global_batch
    pshapes = abstract_params(cfg)
    pspec = rules.param_pspecs(cfg, pshapes, mesh)
    tshape = torch.empty((b, 1), dtype=torch.int32, device="meta")
    posshape = torch.empty((b,), dtype=torch.int32, device="meta")
    cshapes = lm.make_caches(cfg, b, cache_len, device="meta")
    cspec = rules.cache_pspecs(cfg, cshapes, mesh)
    baxes = _batch_axes(mesh)
    bax = baxes if b % _prod(mesh, baxes) == 0 else None
    tspec, posspec = P(bax, None), P(bax)
    lspec = P(bax, "model")

    @torch.no_grad()
    def decode(params, tokens, positions, caches):
        if not donate:
            caches = _clone(caches)
        with use_mesh(mesh), implicit_replication():
            logits, caches = lm.decode_step(params, tokens, positions,
                                            caches, cfg, backend=backend)
            return _place(logits, lspec, mesh), caches

    shapes = (pshapes, tshape, posshape, cshapes)
    return decode, shapes, (pspec, tspec, posspec, cspec)


def make_step_for(cfg: ArchConfig, mesh, shape: ShapeSpec,
                  backend: Backend = TORCH):
    """The step a given (arch x shape) cell runs (train vs serve)."""
    if shape.kind == "train":
        return ("train_step",) + make_train_step(cfg, mesh, shape,
                                                 backend=backend)
    if shape.kind == "prefill":
        return ("prefill_step",) + make_prefill_step(cfg, mesh, shape,
                                                     backend=backend)
    return ("decode_step",) + make_decode_step(cfg, mesh, shape,
                                               backend=backend)
