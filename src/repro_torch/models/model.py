"""The public model facade: init / make_caches / prefill / decode_step.

Port of ``repro.models.model`` for the text decoder families: dense,
MoE (with MLA and the MTP head's parameters), SSM and hybrid.  The
parameter tree has the reference's structure and layout
(``stack/dense_stack`` and ``stack/moe_stack``, ``stack/ssm_stack`` or
the hybrid's ``stack/{groups,shared,lora_a,lora_b,tail}`` with a leading
L axis, ``final_norm``, ``embed``, ``head`` when untied, ``mtp_proj`` and
``mtp_norm`` when ``cfg.mtp``), so ``models.convert`` maps reference
parameters over one to one.

Entry points run on ``cuda`` unless the caller passes another device
(the CPU tests pass ``device="cpu"``); asking for the card where there is
none raises.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    TORCH, Backend, apply_norm, as_backend, dense_init, embed, embed_init,
    norm_init,
)


def _family_fns(cfg: ArchConfig):
    """``(stack_init, make_caches, stack_apply)`` of the family."""
    if cfg.family == "ssm":
        return tf.ssm_stack_init, tf.ssm_make_states, tf.ssm_stack_apply
    if cfg.family == "hybrid":
        return tf.hybrid_init, tf.hybrid_make_caches, tf.hybrid_apply
    return tf.decoder_init, tf.decoder_make_caches, tf.decoder_apply


def _check(cfg: ArchConfig) -> None:
    if cfg.modality != "text" or cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.modality!r} models ({cfg.family} family) are not ported "
            f"yet (ROADMAP.md, queue 1, item 7: the encoder and VLM "
            f"families)")


def init(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
         device=None) -> Dict[str, Any]:
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``).  ``device="meta"`` builds shapes only."""
    _check(cfg)
    device = resolve_device(device)
    dtype = cfg.param_dtype_()
    p: Dict[str, Any] = {
        "stack": _family_fns(cfg)[0](generator, cfg, dtype, device),
        "final_norm": norm_init(cfg.d_model, dtype, device, cfg.norm),
        "embed": embed_init(generator, cfg.vocab_padded, cfg.d_model, dtype,
                            device),
    }
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


def _head_weight(p, cfg: ArchConfig, dtype) -> torch.Tensor:
    if cfg.tie_embeddings:
        return p["embed"]["table"].to(dtype).T              # (d, Vp)
    return p["head"]["w"].to(dtype)


def _logits(p, h_last, cfg: ArchConfig) -> torch.Tensor:
    """lm_head: a plain product here as in the reference, which computes
    it outside the Pallas kernels; the padded vocab tail is masked."""
    cd = cfg.compute_dtype_()
    logits = torch.matmul(h_last, _head_weight(p, cfg, cd)).float()
    valid = torch.arange(cfg.vocab_padded, device=logits.device) \
        < cfg.vocab_size
    return torch.where(valid, logits, -1e30)


def make_caches(cfg: ArchConfig, batch: int, length: int, device=None):
    """KV caches of ``length`` positions (dense), recurrent states (ssm)
    or both (hybrid: every mamba layer's state, one KV cache per shared
    block application), for ``batch`` sequences."""
    _check(cfg)
    return _family_fns(cfg)[1](cfg, batch, length, cfg.compute_dtype_(),
                               resolve_device(device))


def prefill(params, batch: Dict, cfg: ArchConfig, cache_len: int,
            backend: Backend = TORCH) -> Tuple[torch.Tensor, Any]:
    """Encode the prompt, fill fresh caches, return last-position logits.
    ``batch["tokens"]`` is (B,T) on the parameters' device."""
    _check(cfg)
    backend = as_backend(backend)
    tokens = batch["tokens"]
    b, t = tokens.shape
    dev = tokens.device
    h = embed(params["embed"], tokens, cfg.compute_dtype_())
    positions = torch.arange(t, device=dev).expand(b, t)
    caches = make_caches(cfg, b, cache_len, dev)
    h, caches, _ = _family_fns(cfg)[2](params["stack"], h, cfg,
                                       positions=positions, caches=caches,
                                       backend=backend, causal=True)
    h = apply_norm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, h[:, -1], cfg), caches


def decode_step(params, tokens, positions, caches, cfg: ArchConfig,
                backend: Backend = TORCH) -> Tuple[torch.Tensor, Any]:
    """One token per sequence.  tokens (B,1), positions (B,); ``caches``
    is updated in place and returned."""
    _check(cfg)
    backend = as_backend(backend)
    h = embed(params["embed"], tokens, cfg.compute_dtype_())   # (B,1,d)
    h, caches, _ = _family_fns(cfg)[2](params["stack"], h, cfg,
                                       positions=positions[:, None],
                                       caches=caches, backend=backend,
                                       causal=True)
    h = apply_norm(params["final_norm"], h, cfg.norm_eps)
    return _logits(params, h[:, 0], cfg), caches
