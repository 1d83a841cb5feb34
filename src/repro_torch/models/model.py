"""The public model facade: init / loss_fn / make_caches / prefill /
decode_step.

Port of ``repro.models.model`` for every family: dense, MoE (with MLA
and MTP), SSM, hybrid, the VLM (patch embeddings ahead of the text) and
the audio encoder (masked frame prediction, sinusoidal positions, no
decode step).  The parameter tree has the reference's structure and
layout (``stack/dense_stack`` and ``stack/moe_stack``,
``stack/ssm_stack`` or the hybrid's ``stack/{groups,shared,lora_a,
lora_b,tail}`` with a leading L axis, ``final_norm``, ``embed``, ``head``
when untied or for audio, ``mask_emb`` for audio, ``mtp_proj`` and
``mtp_norm`` when ``cfg.mtp``), so ``models.convert`` maps reference
parameters over one to one.

The loss computes cross-entropy in token chunks, each recomputed in
backward, so the (B, T, V) logits never persist; the padded vocab tail
is masked out of the logsumexp.  Training runs on ``backend="torch"``;
the kernel backend is forward-only (``kernels.ops.forward_only``), as the
reference's Pallas backend is.

Entry points run on ``cuda`` unless the caller passes another device
(the CPU tests pass ``device="cpu"``); asking for the card where there is
none raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    TORCH, Backend, apply_norm, as_backend, dense, dense_init, embed,
    embed_init, norm_init, normal,
)
from repro_torch.obs import spans
from repro_torch.sharding.context import constrain, einsum

#: the padded vocab tail's logit
NEG = -1e30
#: weight of the multi-token-prediction loss
MTP_WEIGHT = 0.3


def _family_fns(cfg: ArchConfig):
    """``(stack_init, make_caches, stack_apply)`` of the family."""
    if cfg.family == "ssm":
        return tf.ssm_stack_init, tf.ssm_make_states, tf.ssm_stack_apply
    if cfg.family == "hybrid":
        return tf.hybrid_init, tf.hybrid_make_caches, tf.hybrid_apply
    return tf.decoder_init, tf.decoder_make_caches, tf.decoder_apply


def init(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
         device=None) -> Dict[str, Any]:
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``).  ``device="meta"`` builds shapes only."""
    device = resolve_device(device)
    dtype = cfg.param_dtype_()
    p: Dict[str, Any] = {
        "stack": _family_fns(cfg)[0](generator, cfg, dtype, device),
        "final_norm": norm_init(cfg.d_model, dtype, device, cfg.norm),
    }
    if cfg.modality == "audio_frames":
        p["mask_emb"] = normal((cfg.d_model,), generator, device, dtype, 0.02)
        p["head"] = dense_init(generator, cfg.d_model, cfg.vocab_padded,
                               dtype, device)
    else:
        p["embed"] = embed_init(generator, cfg.vocab_padded, cfg.d_model,
                                dtype, device)
        if not cfg.tie_embeddings:
            p["head"] = dense_init(generator, cfg.d_model, cfg.vocab_padded,
                                   dtype, device)
    if cfg.mtp:     # the training loss's multi-token-prediction head
        p["mtp_proj"] = dense_init(generator, cfg.d_model, cfg.d_model,
                                   dtype, device)
        p["mtp_norm"] = norm_init(cfg.d_model, dtype, device, cfg.norm)
    return p


def compute_params(params, cfg: ArchConfig):
    """A copy of ``params`` whose dense weights and embedding table are
    already in the compute dtype (norm scales stay as they are).

    Every use casts those leaves to the compute dtype, so the copy gives
    bit-identical results and saves the per-call cast's bytes on the hot
    path; in f32 compute it shares the tensors."""
    cd = cfg.compute_dtype_()

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v.to(cd) if k in ("w", "table") else v)
                for k, v in tree.items()}
    return cast(params)


def param_count(params) -> int:
    def count(tree):
        return sum(count(v) if isinstance(v, dict) else v.numel()
                   for v in tree.values())
    return count(params)


def _sinusoidal(t: int, d: int, dtype, device=None) -> torch.Tensor:
    """(t, d) sinusoidal position table: sines then cosines, in f32 as the
    reference computes it, cast to ``dtype``."""
    pos = torch.arange(t, device=device, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d, 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1)[:, :d]
    return pe.to(dtype)


def _head_weight(p, cfg: ArchConfig, dtype) -> torch.Tensor:
    if cfg.modality != "audio_frames" and cfg.tie_embeddings:
        return p["embed"]["table"].to(dtype).T              # (d, Vp)
    return p["head"]["w"].to(dtype)


def _embed_inputs(p, batch: Dict, cfg: ArchConfig):
    """Returns ``(h0 (B,T,d), positions (B,T), text_offset)``.  Audio
    takes ``frames`` (with ``mask_emb`` where ``mask`` is set, for
    masked-prediction training); the VLM puts ``vision_embeds`` ahead of
    the text, whose positions then start at the patch count."""
    cd = cfg.compute_dtype_()
    off = 0
    if cfg.modality == "audio_frames":
        h = batch["frames"].to(cd)
        if "mask" in batch:
            h = torch.where(batch["mask"][..., None],
                            p["mask_emb"].to(cd)[None, None], h)
    else:
        h = embed(p["embed"], batch["tokens"], cd)
        if cfg.modality == "vision_text":
            v = batch["vision_embeds"].to(cd)
            h = torch.cat([v, h], 1)
            off = v.shape[1]
    b, t = h.shape[:2]
    if cfg.pos_embed == "sinusoidal":
        h = h + _sinusoidal(t, cfg.d_model, cd, h.device)[None]
    positions = torch.arange(t, device=h.device).expand(b, t)
    h = constrain(h, "batch", None, None)
    return h, positions, off


def _ce_chunk(hc, head_w, tgc, mkc, vmask):
    """Summed masked cross-entropy of one token chunk: logits in f32, the
    padded vocab at NEG."""
    logits = einsum("btd,dv->btv", hc, head_w.to(hc.dtype)).float()
    # under a mesh the vocab dim is sharded on 'model'; DTensor's gather
    # along a sharded dim fails, so the logits are replicated there first
    logits = constrain(logits, "batch", None, None)
    logits = torch.where(vmask, logits, NEG)
    lse = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1, tgc[..., None])[..., 0]
    return torch.sum((lse - ll) * mkc)


def _chunked_ce(h, head_w, targets, mask, cfg: ArchConfig,
                n_chunks: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without keeping (B,T,V) logits: ``n_chunks`` chunks
    along T when T divides (else one), each chunk's body recomputed in
    backward (the reference's ``jax.checkpoint`` of its scan body).

    h (B,T,d); targets/mask (B,T).  Returns (sum_loss, sum_mask)."""
    t = h.shape[1]
    nc = n_chunks if t % n_chunks == 0 else 1
    tc = t // nc
    vmask = torch.arange(head_w.shape[-1], device=h.device) < cfg.vocab_size
    targets = targets.long()
    loss = h.new_zeros((), dtype=torch.float32)
    denom = h.new_zeros((), dtype=torch.float32)
    for i in range(nc):
        sl = slice(i * tc, (i + 1) * tc)
        args = (h[:, sl], head_w, targets[:, sl], mask[:, sl], vmask)
        if torch.is_grad_enabled():
            loss = loss + checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            loss = loss + _ce_chunk(*args)
        denom = denom + torch.sum(mask[:, sl])
    return loss, denom


def loss_fn(params, batch: Dict, cfg: ArchConfig,
            backend: Backend = TORCH) -> Tuple[torch.Tensor, Dict]:
    """Scalar training loss and metrics (``ce``, ``aux``, ``tokens``,
    ``mtp`` when ``cfg.mtp``, ``loss``) for any family and modality.
    ``batch`` holds tensors on the parameters' device: ``tokens`` and
    ``targets`` (B,T) with an optional ``loss_mask``, plus
    ``vision_embeds`` for the VLM; audio takes ``frames``, ``mask`` and
    ``targets``."""
    backend = as_backend(backend)
    h, positions, off = _embed_inputs(params, batch, cfg)
    h, _, aux = _family_fns(cfg)[2](params["stack"], h, cfg,
                                    positions=positions, caches=None,
                                    backend=backend,
                                    causal=not cfg.encoder_only)
    h = apply_norm(params["final_norm"], h, cfg.norm_eps)
    head_w = _head_weight(params, cfg, cfg.compute_dtype_())

    targets = batch["targets"]
    if cfg.modality == "audio_frames":
        mask = batch["mask"].float()
    else:
        mask = batch.get("loss_mask")
        mask = torch.ones(targets.shape, device=h.device) if mask is None \
            else mask.float()
        h = h[:, off:] if off else h                     # text positions

    loss_sum, denom = _chunked_ce(h, head_w, targets, mask, cfg)
    loss = loss_sum / torch.clamp(denom, min=1.0)
    if not torch.is_tensor(aux):                         # no MoE layer
        aux = loss.new_zeros(())
    metrics = {"ce": loss, "aux": aux, "tokens": denom}

    if cfg.mtp:
        # multi-token prediction: predict t+2 from a projected hidden state
        h2 = apply_norm(params["mtp_norm"],
                        dense(params["mtp_proj"], h, backend), cfg.norm_eps)
        t = targets.shape[1]
        t2 = torch.roll(targets, -1, 1)
        m2 = mask * (torch.arange(t, device=h.device) < t - 1).float()[None]
        l2, d2 = _chunked_ce(h2, head_w, t2, m2, cfg)
        mtp = l2 / torch.clamp(d2, min=1.0)
        loss = loss + MTP_WEIGHT * mtp
        metrics["mtp"] = mtp

    loss = loss + aux
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _logits(p, h_last, cfg: ArchConfig) -> torch.Tensor:
    """lm_head: a plain product here as in the reference, which computes
    it outside the Pallas kernels; the padded vocab tail is masked."""
    cd = cfg.compute_dtype_()
    logits = torch.matmul(h_last, _head_weight(p, cfg, cd)).float()
    valid = torch.arange(cfg.vocab_padded, device=logits.device) \
        < cfg.vocab_size
    return torch.where(valid, logits, NEG)


def make_caches(cfg: ArchConfig, batch: int, length: int, device=None):
    """KV caches of ``length`` positions (dense), recurrent states (ssm)
    or both (hybrid: every mamba layer's state, one KV cache per shared
    block application), for ``batch`` sequences."""
    return _family_fns(cfg)[1](cfg, batch, length, cfg.compute_dtype_(),
                               resolve_device(device))


def prefill(params, batch: Dict, cfg: ArchConfig, cache_len: int,
            backend: Backend = TORCH, caches=None
            ) -> Tuple[torch.Tensor, Any]:
    """Encode the prompt, fill fresh caches, return last-position logits.
    ``batch`` holds tensors on the parameters' device: ``tokens`` (B,T)
    (and ``vision_embeds`` (B,P,d) ahead of them for the VLM), or
    ``frames`` for audio.  ``caches``, fresh from :func:`make_caches` (the
    sharded step passes them placed on its mesh), are filled in place;
    by default they are made here.  Under a span recorder
    (:mod:`repro_torch.obs.spans`) this is a ``model.prefill`` span."""
    rec = spans.ACTIVE
    if rec is not None:
        sid = rec.open("model.prefill")
    backend = as_backend(backend)
    h, positions, _ = _embed_inputs(params, batch, cfg)
    if caches is None:
        caches = make_caches(cfg, h.shape[0], cache_len, h.device)
    h, caches, _ = _family_fns(cfg)[2](params["stack"], h, cfg,
                                       positions=positions, caches=caches,
                                       backend=backend,
                                       causal=not cfg.encoder_only)
    h = apply_norm(params["final_norm"], h, cfg.norm_eps)
    logits = _logits(params, h[:, -1], cfg)
    if rec is not None:
        rec.close(sid)
    return logits, caches


def decode_step(params, tokens, positions, caches, cfg: ArchConfig,
                backend: Backend = TORCH) -> Tuple[torch.Tensor, Any]:
    """One token per sequence.  tokens (B,1), positions (B,); ``caches``
    is updated in place and returned.  Under a span recorder this is a
    ``model.decode_step`` span."""
    if cfg.pos_embed == "sinusoidal":
        raise NotImplementedError("encoder-only archs have no decode step")
    rec = spans.ACTIVE
    if rec is not None:
        sid = rec.open("model.decode_step")
    backend = as_backend(backend)
    h = embed(params["embed"], tokens, cfg.compute_dtype_())   # (B,1,d)
    h, caches, _ = _family_fns(cfg)[2](params["stack"], h, cfg,
                                       positions=positions[:, None],
                                       caches=caches, backend=backend,
                                       causal=True)
    h = apply_norm(params["final_norm"], h, cfg.norm_eps)
    logits = _logits(params, h[:, 0], cfg)
    if rec is not None:
        rec.close(sid)
    return logits, caches
