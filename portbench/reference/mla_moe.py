"""Reference of DeepSeek-V3 (arXiv:2412.19437) on one chip's share of its
experts: embedding, then per layer a pre-norm multi-head latent attention
(MLA) with YaRN RoPE and a pre-norm SwiGLU MLP (the leading dense layers)
or mixture of experts, each added to the residual, then the final RMSNorm
and the untied head.

MLA is computed in its expanded form, as the paper writes it: the query
from its low-rank path (``wdq``, RMSNorm, ``wuq``), per-head keys and
values built from the normalised latent (``wuk``, ``wuv``) beside one
rotary key shared by the heads (``wkr``), causal softmax in blocks of
query rows at scale (qk_nope + qk_rope)^-0.5 times YaRN's m^2.  The
program attends in the absorbed form (the query folded through ``wuk``
against the latent cache); the two agree in exact arithmetic, so this
reference checks that algebra rather than sharing it.

The MoE follows the published inference code: s = sigmoid(x W_r) in
float32, c = s plus the correction bias; a group's score is the sum of
its two largest c, the ``topk_group`` best of ``n_group`` groups stay;
the ``top_k`` largest c choose the experts (the lower index first where
equal) and their s, normalised and times ``routed_scale``, weigh them;
no token is dropped.  Only the experts held here (``held`` from
``held_from``) add their part, as the program does; the shared expert
runs on every token.

Departures from the published model, all in the configuration file:
the multi-token-prediction module is not served; RoPE pairs the two
halves of each rope vector, where the published code pairs neighbouring
dims (with random weights a relabelling of ``wuq`` and ``wkr`` columns);
the experts held elsewhere (EP32) add nothing here or in the program.
``prec="fp8"`` rounds every dense product (the projections, the experts
and the head) through float8, as for the dense reference; the router
stays float32, as in the program.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import plain

#: fields of the port's configuration that this reference does not model,
#: with the values they must keep
PLAIN = dict(norm="rmsnorm", pos_embed="rope", attn_bias=False,
             sliding_window=0, encoder_only=False, modality="text",
             ssm=None, hybrid=None, mtp=False, qk_norm=False,
             act="swiglu", tie_embeddings=False)


def yarn(mla: Dict, theta: float, rd: int):
    """(frequencies (rd/2,) float64, m): YaRN as in DeepSeek-V3's
    ``precompute_freqs_cis`` and its softmax scale (mscale equal to
    mscale_all_dim, as published: cos and sin keep a factor of 1)."""
    freq = theta ** (-torch.arange(0, rd, 2, dtype=torch.float64) / rd)
    factor = mla["yarn_factor"]
    if factor <= 1:
        return freq, 1.0
    orig = mla["yarn_original_len"]

    def turns_dim(turns):
        return rd * math.log(orig / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(turns_dim(mla["yarn_beta_fast"])), 0)
    high = min(math.ceil(turns_dim(mla["yarn_beta_slow"])), rd - 1)
    ramp = ((torch.arange(rd // 2, dtype=torch.float64) - low)
            / max(high - low, 0.001)).clamp(0, 1)
    freq = freq / factor * ramp + freq * (1 - ramp)
    return freq, 0.1 * mla["yarn_mscale_all_dim"] * math.log(factor) + 1.0


def rotate(x: torch.Tensor, pos: torch.Tensor, freq: torch.Tensor
           ) -> torch.Tensor:
    """x (T, H, D): the two halves rotated by pos * freq."""
    half = x.shape[-1] // 2
    ang = (pos[:, None].double() * freq.to(x.device)).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(q, k, v, scale: float, block: int = 256) -> torch.Tensor:
    """q/k (T, H, Dqk), v (T, H, Dv): causal softmax in blocks of query
    rows."""
    t = q.shape[0]
    out = q.new_empty((t, q.shape[1], v.shape[-1]))
    keys = torch.arange(t, device=q.device)
    for s in range(0, t, block):
        qb = q[s:s + block]
        sc = torch.einsum("qhd,khd->hqk", qb, k) * scale
        mask = keys[None, :] <= (s + torch.arange(qb.shape[0],
                                                  device=q.device))[:, None]
        sc = sc.masked_fill(~mask[None], float("-inf"))
        out[s:s + block] = torch.einsum("hqk,khd->qhd",
                                        torch.softmax(sc, -1), v)
    return out


def mla(p: Dict, x: torch.Tensor, cfg: Dict, pos: torch.Tensor,
        prec: str) -> torch.Tensor:
    t, h, eps = x.shape[0], cfg["n_heads"], cfg["norm_eps"]
    m = cfg["mla"]
    nd, rd, vd = m["qk_nope_dim"], m["qk_rope_dim"], m["v_head_dim"]
    freq, ms = yarn(m, cfg["rope_theta"], rd)
    cq = plain.rmsnorm(plain.linear(x, p["wdq"]["w"], prec),
                       p["qnorm"]["scale"], eps)
    q = plain.linear(cq, p["wuq"]["w"], prec).view(t, h, nd + rd)
    ckv = plain.rmsnorm(plain.linear(x, p["wdkv"]["w"], prec),
                        p["kvnorm"]["scale"], eps)
    kr = rotate(plain.linear(x, p["wkr"]["w"], prec)[:, None, :], pos, freq)
    k = torch.cat([plain.linear(ckv, p["wuk"]["w"], prec).view(t, h, nd),
                   kr.expand(t, h, rd)], -1)
    v = plain.linear(ckv, p["wuv"]["w"], prec).view(t, h, vd)
    q = torch.cat([q[..., :nd], rotate(q[..., nd:], pos, freq)], -1)
    out = attention(q, k, v, (nd + rd) ** -0.5 * ms * ms)
    return plain.linear(out.reshape(t, h * vd), p["wo"]["w"], prec)


def top(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last dim, the lower first
    among equal values."""
    return torch.sort(x, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def moe(p: Dict, x: torch.Tensor, cfg: Dict, prec: str) -> torch.Tensor:
    mo = cfg["moe"]
    if mo["scoring"] != "sigmoid":
        raise ValueError("the reference models the sigmoid routing only")
    n, e = x.shape[0], mo["num_experts"]
    s = torch.sigmoid(x @ p["router"]["w"].float())
    c = (s + p["router"]["bias"].float()).view(n, mo["n_group"], -1)
    best = c.sort(-1, descending=True).values[..., :2].sum(-1)
    out = torch.ones_like(best, dtype=torch.bool)
    out.scatter_(1, top(best, mo["topk_group"]), False)
    idx = top(c.masked_fill(out[..., None], float("-inf")).view(n, e),
              mo["top_k"])
    w = s.gather(1, idx)
    w = w / w.sum(-1, keepdim=True) * mo["routed_scale"]
    y = plain.mlp(p["shared"], x, "swiglu", prec)
    bank = p["experts"]
    for j in range(mo["held"] or e):
        row, choice = (idx == mo["held_from"] + j).nonzero(as_tuple=True)
        if row.numel():
            one = {k: {"w": bank[k][j]} for k in ("wi", "wg", "wo")}
            y = y.index_add(0, row, plain.mlp(one, x[row], "swiglu", prec)
                            * w[row, choice, None])
    return y


@torch.no_grad()
def forward(w: Dict, cfg: Dict, tokens: torch.Tensor, rows: slice,
            prec: str = "f32") -> torch.Tensor:
    """Logits (float32, real vocabulary) at positions ``rows`` of the
    causal forward over ``tokens`` (T,).  Each weight is upcast where it
    is used, one layer at a time."""
    plain.exact()
    eps = cfg["norm_eps"]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    h = w["embed"]["table"][tokens].float()
    for name in ("dense_stack", "moe_stack"):
        st = w["stack"].get(name)
        for i in range(st["ln1"]["scale"].shape[0] if st else 0):
            p = plain.layer(st, i)
            h = h + mla(p["attn"], plain.rmsnorm(h, p["ln1"]["scale"], eps),
                        cfg, pos, prec)
            x = plain.rmsnorm(h, p["ln2"]["scale"], eps)
            h = h + (moe(p["moe"], x, cfg, prec) if "moe" in p
                     else plain.mlp(p["mlp"], x, "swiglu", prec))
    h = plain.rmsnorm(h[rows], w["final_norm"]["scale"], eps)
    return plain.head(w, h, cfg, prec)
