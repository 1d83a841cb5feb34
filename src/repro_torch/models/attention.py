"""Attention: GQA/MQA, qk-norm, RoPE, sliding windows, MLA, KV caches.

Port of ``repro.models.attention``.  The
reference computes this attention in plain jnp outside any Pallas kernel,
so plain PyTorch is its faithful counterpart: an outer loop over query
chunks wraps an inner online-softmax loop over KV chunks, so the largest
live score tensor is (B, q_chunk, H, chunk).  One exception: a
window-free decode over CUDA tensors attends with the port's own kernel
(:mod:`repro_torch.kernels.decode_attention`), which computes the same
function in one launch over the cache as it is stored (the sharded step
on each rank's local shards, where the KV heads divide the model axis),
and so does a bf16 MLA decode over plain CUDA tensors
(:mod:`repro_torch.kernels.mla_decode`).

Caches are updated in place (the reference donates them to its jitted
decode step, which permits the same).  The reference's sharding
constraints are made at the same places (heads on 'model'; in decode,
head_dim when the KV heads do not divide the model axis); they are no-ops
without a mesh.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig, MLAConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    TORCH, Backend, apply_norm, dense, dense_init, norm_init, out_constrain,
    rope,
)
from repro_torch.sharding.context import (
    axis_sizes, constrain, current_mesh, einsum, placed,
)

NEG = -1e30


def splittable(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` ready to have ``dim`` split into (n, rest): a DTensor shard
    of ``dim`` over a mesh dim whose size does not divide ``n`` (8 KV
    heads on a 16-way 'model' axis) would split a group, which no
    placement of the split view describes, so it is gathered first; the
    reference's ``constrain`` on the split tensor drops the axis the same
    way.  A plain tensor is returned as it is."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        pl = [Replicate() if p.is_shard(dim) and n % mesh.size(i) else p
              for i, p in enumerate(x.placements)]
        x = placed(x, mesh, pl)
    return x


def split_heads(x: torch.Tensor, h: int, hd: int) -> torch.Tensor:
    """(B, T, h*hd) -> (B, T, h, hd) (see :func:`splittable`)."""
    b, t = x.shape[:2]
    return splittable(x, 2, h).reshape(b, t, h, hd)


def put_slots(buf: torch.Tensor, slot: torch.Tensor, val: torch.Tensor):
    """``buf[b, slot[b]] = val[b]`` for every sequence b, in place: buf
    (B, T, ...), slot (B,), val (B, ...).

    On a DTensor each rank writes its own rows (DTensor has no in-place
    ``index_put_`` on a sharded buffer): ``val`` and ``slot`` take
    ``buf``'s shards of the sequence dim 0 and of the feature dims.  Where
    the slot dim T is sharded (the cache rules shard MLA's ``kr`` there),
    each rank holds a range of slots and writes only the slots in its
    range, with a select, so no shape depends on the data."""
    if not isinstance(buf, DTensor):
        bi = torch.arange(buf.shape[0], device=buf.device)
        buf[bi, slot] = val.to(buf.dtype)
        return
    mesh = buf.device_mesh
    vp = [Shard(p.dim - 1) if p.is_shard() and p.dim > 1
          else p if p.is_shard(0) else Replicate() for p in buf.placements]
    sp = [p if p.is_shard(0) else Replicate() for p in buf.placements]
    bl = buf.to_local()
    vl = placed(val, mesh, vp).to_local().to(bl.dtype)
    sl = placed(slot, mesh, sp).to_local()
    bi = torch.arange(bl.shape[0], device=bl.device)
    if any(p.is_shard(1) for p in buf.placements):
        off, size = 0, buf.shape[1]      # this rank's first slot (even)
        for i, p in enumerate(buf.placements):
            if p.is_shard(1):
                size //= mesh.size(i)
                off += mesh.get_local_rank(i) * size
        sl = sl - off
        mine = (sl >= 0) & (sl < bl.shape[1])
        sl = torch.clamp(sl, 0, bl.shape[1] - 1)
        keep = mine.reshape((-1,) + (1,) * (vl.dim() - 1))
        vl = torch.where(keep, vl, bl[bi, sl])
    bl[bi, sl] = vl


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

    qg = splittable(q, 2, hkv).reshape(b, tq, hkv, g, d).float()
    m = torch.full((b, tq, hkv, g), NEG, device=dev)
    l = torch.zeros((b, tq, hkv, g), device=dev)
    acc = torch.zeros((b, tq, hkv, g, dv), device=dev)
    for s0 in range(0, tk, chunk):
        kb = k[:, s0:s0 + chunk].float()                    # (B,c,Hkv,D)
        vb = v[:, s0:s0 + chunk].float()
        kpos = kv_positions[:, s0:s0 + chunk][:, None, None, None, :]
        s = einsum("bqhgd,bkhd->bqhgk", qg, kb) * scale
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
        acc = acc * corr[..., None] + einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, tq, h, dv).to(q.dtype)


def takes_decode_kernel(*tensors) -> bool:
    """Whether a window-free decode over these tensors runs the port's
    decode kernel (:mod:`repro_torch.kernels.decode_attention`): plain
    CUDA tensors.  A CPU tensor keeps :func:`chunked_attention`.  The
    sharded step asks with its DTensors' local shards."""
    return all(t.is_cuda and not isinstance(t, DTensor) for t in tensors)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _decode_local(q, k, v, kv_positions, q_positions):
    """The decode attention kernel on DTensors' local shards.  The caches
    shard slots on 'batch' and KV heads on 'model' (the KV
    heads divide the model axis), so each rank holds whole GQA groups:
    q takes the caches' shards of dims 0 and 2, the positions their shard
    of dim 0, and the output keeps q's."""
    mesh = k.device_mesh
    heads = [p if p.is_shard(0) or p.is_shard(2) else Replicate()
             for p in k.placements]
    rows = [p if p.is_shard(0) else Replicate() for p in heads]
    fn = local_map(lambda qq, *a: ops.launch("decode_attention",
                                             qq.contiguous(), *a),
                   out_placements=heads,
                   in_placements=(heads, heads, heads, rows, rows),
                   device_mesh=mesh)
    return fn(placed(q, mesh, heads), placed(k, mesh, heads),
              placed(v, mesh, heads), placed(kv_positions, mesh, rows),
              placed(q_positions, mesh, rows))


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
    q = split_heads(dense(p["wq"], x, backend), h, hd)
    k = split_heads(dense(p["wk"], x, backend), hkv, hd)
    v = split_heads(dense(p["wv"], x, backend), hkv, hd)
    if cfg.qk_norm:
        q = apply_norm(p["qnorm"], q, cfg.norm_eps)
        k = apply_norm(p["knorm"], k, cfg.norm_eps)
    if cfg.pos_embed == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", None, "model", None)
    k = constrain(k, "batch", None, "model", None)
    v = constrain(v, "batch", None, "model", None)

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
        mesh = current_mesh()
        msize = axis_sizes(mesh).get("model", 1) if mesh else 1
        heads_shardable = hkv % max(msize, 1) == 0
        clen = cache["k"].shape[1]
        pos = positions[:, 0] if positions.dim() > 1 else positions  # (B,)
        slot = (pos % clen) if window else pos
        put_slots(cache["k"], slot, k[:, 0])
        put_slots(cache["v"], slot, v[:, 0])
        put_slots(cache["pos"], slot, pos.to(torch.int32))
        if heads_shardable:
            kk = constrain(cache["k"], "batch", None, "model", None)
            vv = constrain(cache["v"], "batch", None, "model", None)
        else:
            # KV heads don't divide the model axis: shard head_dim on both
            # q and kv so the score contraction is over the sharded dim
            q = constrain(q, "batch", None, None, "model")
            kk = constrain(cache["k"], "batch", None, None, "model")
            vv = constrain(cache["v"], "batch", None, None, "model")
        if window == 0 and heads_shardable \
                and takes_decode_kernel(*map(_local, (q, kk, vv))):
            # one launch over the bf16 cache as it is stored, live keys only
            if isinstance(kk, DTensor):
                out = _decode_local(q, kk, vv, cache["pos"], pos)
            else:
                out = ops.launch("decode_attention", q, kk, vv,
                                 cache["pos"], pos)
        else:
            out = chunked_attention(
                q, kk, vv, causal=True, window=window,
                chunk=chunk, q_offset=pos, kv_positions=cache["pos"],
                kv_valid=torch.clamp(pos + 1, max=clen) if window else None)
    out = constrain(out, "batch", None, "model", None)
    y = dense(p["wo"], out.reshape(b, t, h * hd), backend)
    return out_constrain(y, cfg.policy), cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank q/kv with compressed latent cache
# ---------------------------------------------------------------------------


def mla_init(gen, cfg: ArchConfig, dtype, device, layers: int = 0):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    kw = dict(dtype=dtype, device=device, layers=layers)
    return {
        "wdq": dense_init(gen, d, m.q_lora_rank, **kw),
        "qnorm": norm_init(m.q_lora_rank, dtype, device, layers=layers),
        "wuq": dense_init(gen, m.q_lora_rank, h * qd, **kw),
        "wdkv": dense_init(gen, d, m.kv_lora_rank, **kw),
        "kvnorm": norm_init(m.kv_lora_rank, dtype, device, layers=layers),
        "wkr": dense_init(gen, d, m.qk_rope_dim, **kw),
        "wuk": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_dim, **kw),
        "wuv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, **kw),
        "wo": dense_init(gen, h * m.v_head_dim, d, **kw),
    }


def mla_make_cache(cfg: ArchConfig, batch: int, length: int, dtype, device,
                   layers: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The latent cache: ``ckv`` (B, T, kv_lora_rank) and the shared rope
    key ``kr`` (B, T, qk_rope_dim), both k and v of every head."""
    m = cfg.mla
    lead = (layers,) if layers is not None else ()
    return {"ckv": torch.zeros(lead + (batch, length, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros(lead + (batch, length, m.qk_rope_dim),
                              dtype=dtype, device=device)}


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor m: 0.1 * mscale * ln(factor) + 1."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


@functools.lru_cache(maxsize=None)
def yarn_freq(m: MLAConfig, theta: float, device) -> Optional[torch.Tensor]:
    """The rope dims' frequencies under YaRN (DeepSeek-V3's
    ``precompute_freqs_cis``), (qk_rope_dim / 2,) f32 on ``device``: the
    dims that turn fewer than ``beta_slow`` times over the original
    context are interpolated (divided by the factor), those that turn more
    than ``beta_fast`` times kept, with a linear ramp between.  None
    without YaRN (``yarn_factor`` 1: plain RoPE)."""
    if m.yarn_factor <= 1:
        return None
    d = m.qk_rope_dim
    freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32) / d))

    def dim_of(turns):
        return d * math.log(m.yarn_original_len / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(dim_of(m.yarn_beta_fast)), 0)
    high = min(math.ceil(dim_of(m.yarn_beta_slow)), d - 1)
    ramp = torch.clamp((torch.arange(d // 2, dtype=torch.float32) - low)
                       / (high - low if high != low else 0.001), 0, 1)
    keep = 1 - ramp
    return (freq / m.yarn_factor * (1 - keep) + freq * keep).to(device)


def mla_apply(p, x, cfg: ArchConfig, *, positions, cache=None,
              backend: Backend = TORCH, chunk: int = 1024
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B,T,d).  Prefill writes the cache from slot 0; decode (T == 1)
    writes slot ``pos`` in place and attends over the whole cache.

    Absorbed form, as in the reference: ``W_uk`` folds into q and the
    query attends directly against the latent ``[ckv, kr]`` with one KV
    head (``ckv`` is also the value), then ``W_uv`` maps each head's
    output up; no per-head K or V is ever built.  ``wdq``, ``wuq``,
    ``wdkv``, ``wkr`` and ``wo`` are ``dense()`` products; ``wuk`` and
    ``wuv`` are einsums, as in the reference.  A bf16 decode over plain
    CUDA tensors attends with the port's MLA kernel
    (:mod:`repro_torch.kernels.mla_decode`), which reads ``ckv`` and ``kr``
    in place; CPU tensors, f32, DTensors and prefills keep
    :func:`chunked_attention`."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    nd, rd, vd = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim

    q = dense(p["wuq"], apply_norm(p["qnorm"], dense(p["wdq"], x, backend),
                                   cfg.norm_eps), backend)
    q = q.reshape(b, t, h, nd + rd)
    qn, qr = q[..., :nd], q[..., nd:]
    freq = yarn_freq(m, cfg.rope_theta, x.device)
    qr = rope(qr, positions, cfg.rope_theta, freq)
    ckv = apply_norm(p["kvnorm"], dense(p["wdkv"], x, backend), cfg.norm_eps)
    kr = rope(dense(p["wkr"], x, backend)[:, :, None, :], positions,
              cfg.rope_theta, freq)[:, :, 0]                  # shared head

    pos = positions[:, 0] if positions.dim() > 1 else positions  # (B,)
    decode = cache is not None and t == 1
    if decode:
        put_slots(cache["ckv"], pos, ckv[:, 0])
        put_slots(cache["kr"], pos, kr[:, 0])
        ckv_all, kr_all = cache["ckv"], cache["kr"]
    else:
        ckv_all, kr_all = ckv, kr
        if cache is not None:  # prefill fills the cache
            cache["ckv"][:, :t] = ckv.to(cache["ckv"].dtype)
            cache["kr"][:, :t] = kr.to(cache["kr"].dtype)

    wuk = p["wuk"]["w"].to(q.dtype).reshape(m.kv_lora_rank, h, nd)
    q_lat = einsum("bthn,rhn->bthr", qn, wuk)           # (B,T,H,r)
    qq = torch.cat([q_lat, qr], -1)                           # (B,T,H,r+rd)
    qq = constrain(qq, "batch", None, "model", None)
    scale_fix = ((nd + rd) ** -0.5) / ((m.kv_lora_rank + rd) ** -0.5)
    scale_fix *= yarn_mscale(m.yarn_factor, m.yarn_mscale_all_dim) ** 2
    if decode and qq.dtype == torch.bfloat16 \
            and takes_decode_kernel(qq, ckv_all, kr_all):
        # one launch over the bf16 latent cache as it is stored, live
        # positions only
        out = ops.launch("mla_decode", qq * scale_fix, ckv_all, kr_all, pos)
    else:
        kk = torch.cat([ckv_all, kr_all], -1)[:, :, None, :]  # (B,Tk,1,r+rd)
        # gather the latent KV across the seq dim once per layer
        kk = constrain(kk, "batch", None, None, None)
        ckv_all = constrain(ckv_all, "batch", None, None)
        out = chunked_attention(qq * scale_fix, kk, ckv_all[:, :, None, :],
                                causal=True, chunk=chunk, q_offset=pos)
    wuv = p["wuv"]["w"].to(q.dtype).reshape(m.kv_lora_rank, h, vd)
    out = einsum("bthr,rhv->bthv", out, wuv)
    y = dense(p["wo"], out.reshape(b, t, h * vd), backend)
    return out_constrain(y, cfg.policy), cache
