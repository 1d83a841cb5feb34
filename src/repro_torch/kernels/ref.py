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


def gemm(a: torch.Tensor, b: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B with f32 accumulation, cast once to ``out_dtype``
    (default ``a.dtype``) — the ``ame_gemm`` oracle."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


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
