"""Plain PyTorch versions of the ported kernels (the correctness references).

Each function is the semantic specification its Hopper kernel is held
against on the card, and what a wrapper computes for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

#: mask value selected before ``exp`` (exp(NEG) == 0, never inf * 0)
NEG = -1e30
#: ``attention`` walks its leading dims in slices of at most this many
#: (query, key) scores
SCORES_PER_SLICE = 2 ** 26


def gemm(a: torch.Tensor, b: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B with f32 accumulation, cast once to ``out_dtype``
    (default ``a.dtype``) — the ``ame_gemm`` oracle."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def elementwise(kind: str, a: torch.Tensor, b: torch.Tensor,
                relu: bool = False) -> torch.Tensor:
    """mfadd/mfsub/mfmul semantics with an optional ReLU on writeback —
    the ``ame_elementwise`` oracle.  Done in the operands' dtype, as
    PyTorch does it: widened to f32, one operation, one rounding.  The
    ReLU is the reference's ``jnp.maximum(o, 0)``: NaN stays NaN and -0
    becomes +0 (``torch.relu`` keeps -0 on the CPU, not on the card)."""
    if kind == "add":
        o = a + b
    elif kind == "sub":
        o = a - b
    elif kind == "mul":
        o = a * b
    else:
        raise ValueError(kind)
    return o.masked_fill(o <= 0, 0) if relu else o


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """Mamba2 SSD reference: sequential recurrence over time.

      S_t = exp(log_a_t) * S_{t-1} + b_t (outer) x_t        (N, P) state
      y_t = c_t @ S_t

    Shapes: x (..., T, P), log_a (..., T), b/c (..., T, N) -> y (..., T, P)
    in ``x.dtype``; the state and every product are f32.  The state update
    is the paper's reduction-free outer-product accumulation — rank-1
    updates into a resident accumulator.
    """
    *lead, t, p = x.shape
    n = b.shape[-1]
    xf, la, bf, cf = x.float(), log_a.float(), b.float(), c.float()
    s = torch.zeros(*lead, n, p, dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        s = torch.exp(la[..., i])[..., None, None] * s \
            + bf[..., i, :, None] * xf[..., i, None, :]
        ys.append((cf[..., i, None, :] @ s)[..., 0, :])
    return torch.stack(ys, -2).to(x.dtype)


def _ssd_chunked(x, log_a, b, c, chunk: int) -> torch.Tensor:
    """Chunked SSD over any leading dims: x (..., T, P), log_a (..., T),
    b/c (..., T, N).  The (N, P) f32 state is carried once per chunk; T is
    padded to a multiple of ``min(chunk, T)`` with log_a = 0 and b = 0,
    which is exactly neutral (the pad's outputs are dropped)."""
    *lead, t, p = x.shape
    n = b.shape[-1]
    lc = min(chunk, t)
    pad = (-t) % lc
    xf = F.pad(x.float(), (0, 0, 0, pad))
    la = F.pad(log_a.float(), (0, pad))
    bf = F.pad(b.float(), (0, 0, 0, pad))
    cf = F.pad(c.float(), (0, 0, 0, pad))
    causal = torch.ones(lc, lc, dtype=torch.bool, device=x.device).tril()
    s = torch.zeros(*lead, n, p, dtype=torch.float32, device=x.device)
    ys = []
    for k0 in range(0, t + pad, lc):
        xc, lac = xf[..., k0:k0 + lc, :], la[..., k0:k0 + lc]
        bc, cc = bf[..., k0:k0 + lc, :], cf[..., k0:k0 + lc, :]
        cum = torch.cumsum(lac, -1)                            # (..., L)
        y = (cc * torch.exp(cum)[..., None]) @ s               # carried state
        diff = torch.where(causal, cum[..., :, None] - cum[..., None, :], NEG)
        g = (cc @ bc.transpose(-1, -2)) * torch.exp(diff)      # (..., L, L)
        ys.append(y + g @ xc)
        w = torch.exp(cum[..., -1:] - cum)                     # (..., L)
        s = torch.exp(cum[..., -1])[..., None, None] * s \
            + (bc * w[..., None]).transpose(-1, -2) @ xc
    return torch.cat(ys, -2)[..., :t, :].to(x.dtype)


def ssd_chunked(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD, x (BH,T,P), log_a (BH,T), b/c (BH,T,N) -> (BH,T,P) —
    the ``ssd_scan`` kernel's oracle and the port of the reference's
    ``ssd_chunked_jnp``."""
    if x.dim() != 3:
        raise ValueError(f"ssd_chunked takes x (BH,T,P), got {tuple(x.shape)}")
    return _ssd_chunked(x, log_a, b, c, chunk)


def ssd_chunked4(x: torch.Tensor, log_a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """4-D chunked SSD, x (B,H,T,P), log_a (B,H,T), b/c (B,H,T,N) — the
    port of the reference's ``ssd_chunked_jnp4``."""
    if x.dim() != 4:
        raise ValueError(f"ssd_chunked4 takes x (B,H,T,P), got "
                         f"{tuple(x.shape)}")
    return _ssd_chunked(x, log_a, b, c, chunk)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """Naive softmax attention — the ``flash_attention`` oracle.  q
    (..., Tq, D), k/v (..., Tk, D) with the same leading dims; Tq is
    aligned to the *end* of the kv sequence (decode: Tq = 1, Tk = cache
    length).  ``window > 0`` is sliding-window attention (each query sees
    the last ``window`` keys).  Masked scores are -inf and the softmax is
    f32, so a row that sees no key is NaN; the result takes q's dtype.

    The leading dims are walked in slices of at most
    :data:`SCORES_PER_SLICE` scores each, so the (Tq, Tk) score blocks of a
    long sequence are never all resident.
    """
    *lead, tq, d = q.shape
    tk = k.shape[-2]
    scale = scale if scale is not None else d ** -0.5
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    qf = q.reshape(-1, tq, d)
    kf, vf = k.reshape(-1, tk, d), v.reshape(-1, tk, v.shape[-1])
    rows = max(1, SCORES_PER_SLICE // max(1, tq * tk))
    outs = []
    for i in range(0, qf.shape[0], rows):
        s = (qf[i:i + rows].float() @ kf[i:i + rows].float().transpose(-1, -2)
             ) * scale
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append((p @ vf[i:i + rows].float()).to(q.dtype))
    out = torch.cat(outs) if outs else qf.new_empty(0, tq, v.shape[-1])
    return out.reshape(*lead, tq, v.shape[-1])
