"""Plain layers of the reference, in float32.

``prec="fp8"`` is the control: every dense product (the projections that
the port runs on K1, and the head) quantises its activation per row and
its weight per output column to float8 e4m3 with a scale at the format's
largest value, then multiplies in float32.  It is the step below the
bfloat16 that the configurations state.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def exact() -> None:
    """float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer(tree, i: int):
    """Layer ``i`` of a tree whose leaves stack layers on dim 0."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = FP8_MAX / t.abs().amax(dim, keepdim=True).clamp(min=1e-12)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def linear(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x (T, K) @ w (K, N) in float32, or through float8 for the
    control."""
    w = w.float()
    if prec == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    elif prec != "f32":
        raise ValueError(f"prec must be 'f32' or 'fp8', got {prec!r}")
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D): the two halves of each head rotated by
    pos * theta^(-2i/D), as Qwen3's ``rotate_half``."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, device=x.device,
                                   dtype=torch.float64) / half)
    ang = (pos[:, None].double() * freq).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def causal_attention(q, k, v, block: int = 512) -> torch.Tensor:
    """q (T, H, D), k/v (T, Hkv, D); query head h reads kv head
    h // (H / Hkv).  Softmax over the keys at or before each query, in
    blocks of query rows."""
    t, h, d = q.shape
    k = k.repeat_interleave(h // k.shape[1], 1)
    v = v.repeat_interleave(h // v.shape[1], 1)
    out = torch.empty_like(q)
    keys = torch.arange(t, device=q.device)
    for s in range(0, t, block):
        qb = q[s:s + block]
        sc = torch.einsum("qhd,khd->hqk", qb, k) * d ** -0.5
        mask = keys[None, :] <= (s + torch.arange(qb.shape[0],
                                                  device=q.device))[:, None]
        sc = sc.masked_fill(~mask[None], float("-inf"))
        out[s:s + block] = torch.einsum("hqk,khd->qhd",
                                        torch.softmax(sc, -1), v)
    return out


def attention(p: Dict, x: torch.Tensor, cfg: Dict, pos: torch.Tensor,
              prec: str) -> torch.Tensor:
    t = x.shape[0]
    h, hkv = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // h
    q = linear(x, p["wq"]["w"], prec).view(t, h, hd)
    k = linear(x, p["wk"]["w"], prec).view(t, hkv, hd)
    v = linear(x, p["wv"]["w"], prec).view(t, hkv, hd)
    if cfg.get("qk_norm"):
        q = rmsnorm(q, p["qnorm"]["scale"], cfg["norm_eps"])
        k = rmsnorm(k, p["knorm"]["scale"], cfg["norm_eps"])
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    return linear(causal_attention(q, k, v).reshape(t, h * hd),
                  p["wo"]["w"], prec)


def mlp(p: Dict, x: torch.Tensor, act: str, prec: str) -> torch.Tensor:
    """SwiGLU: silu(x Wg) * (x Wi) Wo; GELU: gelu_tanh(x Wi) Wo."""
    hi = linear(x, p["wi"]["w"], prec)
    if act == "swiglu":
        hi = F.silu(linear(x, p["wg"]["w"], prec)) * hi
    elif act == "gelu":
        hi = F.gelu(hi, approximate="tanh")
    else:
        raise ValueError(f"no reference for act {act!r}")
    return linear(hi, p["wo"]["w"], prec)


def block_delta(p: Dict, x: torch.Tensor, cfg: Dict, pos: torch.Tensor,
                prec: str) -> torch.Tensor:
    """What a pre-norm attention + MLP block adds to its input x."""
    eps = cfg["norm_eps"]
    a = attention(p["attn"], rmsnorm(x, p["ln1"]["scale"], eps), cfg, pos,
                  prec)
    return a + mlp(p["mlp"], rmsnorm(x + a, p["ln2"]["scale"], eps),
                   cfg["act"], prec)


def head(w: Dict, h: torch.Tensor, cfg: Dict, prec: str) -> torch.Tensor:
    """Logits over the real vocabulary (tied: the embedding table)."""
    wt = w["embed"]["table"].T if cfg["tie_embeddings"] else w["head"]["w"]
    return linear(h, wt[:, :cfg["vocab_size"]], prec)
