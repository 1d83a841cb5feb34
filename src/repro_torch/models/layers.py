"""Shared neural layers, functional style (port of ``repro.models.layers``).

Parameters are plain dictionaries of tensors in the reference's layout:
a dense weight is ``(d_in, d_out)``, so it reaches the GEMM kernel as
B = (K, N) and converting reference weights is a copy.  Every dense
product goes through a :class:`Backend`.  The reference's sharding
constraints are dropped: the port runs on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class Backend:
    """Routes dense compute: ``"torch"`` (the plain version; the
    reference's ``"xla"``) or ``"kernel"`` (the hand-written AME GEMM on
    a CUDA tensor, its plain version on a CPU tensor; the reference's
    ``"pallas"``).  ``"kernel"`` is forward-only on both devices, as
    ``"pallas"`` is: a call that autograd would differentiate raises
    (``ops.forward_only``)."""

    mode: str = "torch"

    def __post_init__(self):
        if self.mode not in ("torch", "kernel"):
            raise ValueError(f"backend mode {self.mode!r} is not 'torch' "
                             f"or 'kernel'")

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(..., K) @ (K, N) with f32 accumulation, cast to ``x.dtype``."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y = ops.gemm(x2, w, use_kernel=self.mode == "kernel",
                     out_dtype=x.dtype)
        return y.reshape(*lead, w.shape[-1])


TORCH = Backend("torch")


def as_backend(backend) -> Backend:
    return backend if isinstance(backend, Backend) else Backend(backend)


def normal(shape, generator: Optional[torch.Generator], device, dtype,
           scale: float) -> torch.Tensor:
    """Seeded N(0, scale^2) draws; on the meta device only shapes exist."""
    device = torch.device(device)
    gen = generator if device.type != "meta" else None
    return torch.randn(shape, generator=gen, device=device, dtype=dtype) * scale


# -- dense -------------------------------------------------------------------


def dense_init(gen, d_in: int, d_out: int, dtype, device, bias: bool = False,
               scale: Optional[float] = None, layers: int = 0):
    """``layers > 0`` stacks that many independent weights on a leading
    axis (the reference's ``vmap``-ed init)."""
    scale = scale if scale is not None else d_in ** -0.5
    lead = (layers,) if layers else ()
    p = {"w": normal(lead + (d_in, d_out), gen, device, dtype, scale)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), dtype=dtype, device=device)
    return p


def dense(p, x: torch.Tensor, backend: Backend = TORCH) -> torch.Tensor:
    y = backend.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# -- norms -------------------------------------------------------------------


def norm_init(d: int, dtype, device, kind: str = "rmsnorm", layers: int = 0):
    lead = (layers,) if layers else ()
    p = {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:            # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# -- rotary ------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., T, H, D) rotated by position.  positions (..., T)."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    ang = positions[..., None].float() * freq                 # (..., T, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# -- mlp ---------------------------------------------------------------------


def mlp_init(gen, d: int, d_ff: int, act: str, dtype, device, layers: int = 0):
    p = {"wi": dense_init(gen, d, d_ff, dtype, device, layers=layers)}
    if act in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, d, d_ff, dtype, device, layers=layers)
    p["wo"] = dense_init(gen, d_ff, d, dtype, device, layers=layers)
    return p


def mlp(p, x: torch.Tensor, act: str, backend: Backend = TORCH) -> torch.Tensor:
    """Gated/plain MLP."""
    h = dense(p["wi"], x, backend)
    if act == "swiglu":
        h = F.silu(dense(p["wg"], x, backend)) * h
    elif act == "geglu":
        h = F.gelu(dense(p["wg"], x, backend), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return dense(p["wo"], h, backend)


# -- embedding ----------------------------------------------------------------


def embed_init(gen, vocab: int, d: int, dtype, device):
    return {"table": normal((vocab, d), gen, device, dtype, d ** -0.5)}


def embed(p, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    return p["table"].to(compute_dtype)[tokens]
