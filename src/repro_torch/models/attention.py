"""Attention: GQA/MQA, qk-norm, RoPE, sliding windows, KV caches.

Port of ``repro.models.attention`` (MLA waits for its slice).  The
reference computes this attention in plain jnp outside any Pallas kernel,
so plain PyTorch is its faithful counterpart: an outer loop over query
chunks wraps an inner online-softmax loop over KV chunks, so the largest
live score tensor is (B, q_chunk, H, chunk).

Caches are updated in place (the reference donates them to its jitted
decode step, which permits the same).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    TORCH, Backend, apply_norm, dense, dense_init, norm_init, rope,
)

NEG = -1e30


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      chunk: int = 1024, q_chunk: int = 512, q_offset=0,
                      kv_positions: Optional[torch.Tensor] = None,
                      kv_valid=None) -> torch.Tensor:
    """q (B,Tq,H,D), k/v (B,Tk,Hkv,Dv?) -> (B,Tq,H,Dv).

    ``q_offset``: absolute position of q[0] (scalar or (B,)).
    ``kv_positions``: absolute positions of cache slots (B,Tk); -1 marks an
    unwritten slot; defaults to 0..Tk-1.  ``kv_valid``: scalar/(B,) count
    of valid cache slots (defaults to all).
    """
    b, tq, h, d = q.shape
    dev = q.device
    offs = torch.as_tensor(q_offset, device=dev).expand(b)
    if tq > q_chunk:
        # each query's output depends on no other query, so the ragged last
        # block needs none of the reference's padding
        return torch.cat([
            chunked_attention(q[:, s:s + q_chunk], k, v, causal=causal,
                              window=window, chunk=chunk, q_chunk=q_chunk,
                              q_offset=offs + s, kv_positions=kv_positions,
                              kv_valid=kv_valid)
            for s in range(0, tq, q_chunk)], 1)
    tk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = d ** -0.5
    chunk = min(chunk, tk)
    if kv_positions is None:
        kv_positions = torch.arange(tk, device=dev).expand(b, tk)
    kv_valid = torch.full((b,), tk, device=dev) if kv_valid is None \
        else torch.as_tensor(kv_valid, device=dev).expand(b)
    qpos = offs[:, None] + torch.arange(tq, device=dev)[None, :]   # (B, Tq)
    qp = qpos[:, :, None, None, None]

    qg = q.reshape(b, tq, hkv, g, d).float()
    m = torch.full((b, tq, hkv, g), NEG, device=dev)
    l = torch.zeros((b, tq, hkv, g), device=dev)
    acc = torch.zeros((b, tq, hkv, g, dv), device=dev)
    for s0 in range(0, tk, chunk):
        kb = k[:, s0:s0 + chunk].float()                    # (B,c,Hkv,D)
        vb = v[:, s0:s0 + chunk].float()
        kpos = kv_positions[:, s0:s0 + chunk][:, None, None, None, :]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kb) * scale
        slot = s0 + torch.arange(kb.shape[1], device=dev)
        ok = slot[None, :] < kv_valid[:, None]               # (B, c)
        mask = ok[:, None, None, None, :] & (kpos >= 0)
        if causal:
            mask = mask & (kpos <= qp)
        if window > 0:
            mask = mask & (kpos > qp - window)
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, tq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# standard GQA attention module
# ---------------------------------------------------------------------------


def attn_init(gen, cfg: ArchConfig, dtype, device, layers: int = 0):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kw = dict(dtype=dtype, device=device, layers=layers)
    p = {
        "wq": dense_init(gen, d, h * hd, bias=cfg.attn_bias, **kw),
        "wk": dense_init(gen, d, hkv * hd, bias=cfg.attn_bias, **kw),
        "wv": dense_init(gen, d, hkv * hd, bias=cfg.attn_bias, **kw),
        "wo": dense_init(gen, h * hd, d, **kw),
    }
    if cfg.qk_norm:
        p["qnorm"] = norm_init(hd, dtype, device, layers=layers)
        p["knorm"] = norm_init(hd, dtype, device, layers=layers)
    return p


def make_cache(cfg: ArchConfig, batch: int, length: int, dtype, device,
               layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Standard KV cache (rolling when sliding_window > 0)."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    if cfg.sliding_window:
        length = min(length, cfg.sliding_window)
    shape = (batch, length, hkv, hd)
    if layers is not None:
        shape = (layers,) + shape
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute position per slot; -1 marks an unwritten slot
        "pos": torch.full(shape[:-2], -1, dtype=torch.int32, device=device),
    }


def attention_apply(p, x, cfg: ArchConfig, *, positions, cache=None,
                    backend: Backend = TORCH, causal=True,
                    chunk: int = 1024) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B,T,d).  Training/prefill: cache is None or gets filled.
    Decode: T==1, the cache is read and updated in place (rolling for
    SWA)."""
    b, t, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    window = cfg.sliding_window
    q = dense(p["wq"], x, backend).reshape(b, t, h, hd)
    k = dense(p["wk"], x, backend).reshape(b, t, hkv, hd)
    v = dense(p["wv"], x, backend).reshape(b, t, hkv, hd)
    if cfg.qk_norm:
        q = apply_norm(p["qnorm"], q, cfg.norm_eps)
        k = apply_norm(p["knorm"], k, cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                chunk=chunk, q_offset=positions[:, 0])
    elif t > 1:
        # prefill into the cache (rolling tail for SWA)
        clen = cache["k"].shape[1]
        kk, vv, pp = k, v, positions.expand(b, t)
        if t >= clen:
            kk, vv, pp = k[:, -clen:], v[:, -clen:], pp[:, -clen:]
        n = kk.shape[1]
        cache["k"][:, :n] = kk.to(cache["k"].dtype)
        cache["v"][:, :n] = vv.to(cache["v"].dtype)
        cache["pos"][:, :n] = pp.to(torch.int32)
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                chunk=chunk, q_offset=positions[:, 0])
    else:
        # decode: write the new kv into its slot, attend over the cache
        clen = cache["k"].shape[1]
        pos = positions[:, 0] if positions.dim() > 1 else positions  # (B,)
        slot = (pos % clen) if window else pos
        bi = torch.arange(b, device=x.device)
        cache["k"][bi, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bi, slot] = v[:, 0].to(cache["v"].dtype)
        cache["pos"][bi, slot] = pos.to(torch.int32)
        kv_valid = torch.clamp(pos + 1, max=clen)
        out = chunked_attention(
            q, cache["k"], cache["v"], causal=True, window=window,
            chunk=chunk, q_offset=pos, kv_positions=cache["pos"],
            kv_valid=kv_valid if window else None)
    y = dense(p["wo"], out.reshape(b, t, h * hd), backend)
    return y, cache
