"""Shared neural layers, functional style (port of ``repro.models.layers``).

Parameters are plain dictionaries of tensors in the reference's layout:
a dense weight is ``(d_in, d_out)``, so it reaches the GEMM kernel as
B = (K, N) and converting reference weights is a copy.  Every dense
product goes through a :class:`Backend`.

The reference's sharding constraints are here too
(:func:`out_constrain`, the MLP's hidden): under a mesh
(``sharding.context.use_mesh``) they redistribute DTensors; with none, or
on plain tensors, they are no-ops.  A dense product of DTensors runs on
each rank's local shards (:func:`sharded_matmul`), so the kernel backend
launches K1 on them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import OUTPUT_SHARDED_TP_MODES, Policy
from repro_torch.kernels import ops
from repro_torch.sharding.context import constrain


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
        """(..., K) @ (K, N) with f32 accumulation, cast to ``x.dtype``;
        DTensor operands multiply on their local shards
        (:func:`sharded_matmul`)."""
        if isinstance(x, DTensor) or isinstance(w, DTensor):
            return sharded_matmul(x, w, self.mode == "kernel")
        return _local_matmul(x, w, self.mode == "kernel")


def _local_matmul(x: torch.Tensor, w: torch.Tensor,
                  use_kernel: bool) -> torch.Tensor:
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = ops.gemm(x2, w.contiguous(), use_kernel=use_kernel,
                 out_dtype=x.dtype)
    return y.reshape(*lead, w.shape[-1])


def sharded_matmul(x: torch.Tensor, w: torch.Tensor,
                   use_kernel: bool) -> torch.Tensor:
    """x (..., K) @ w (K, N) of DTensors, on each rank's local shards
    (``local_map``), so ``use_kernel`` launches K1 on them.

    The dataflow follows the weight's placement on each mesh dim, after
    any shard of it on a data axis (FSDP) is gathered:

    * w sharded on its output dim N (the paper's reduction-free
      "allgather"): x is gathered on that dim, and y comes out sharded on
      its last dim; no partial sum crosses the axis.
    * w sharded on its input dim K (Megatron's "allreduce"): x is sharded
      on K to match, and y is ``Partial``; the following ``constrain``
      reduces it.
    * w replicated: x keeps a shard of a leading (batch or sequence) dim,
      which y keeps; a shard of K is gathered.

    A plain tensor among the operands counts as replicated."""
    mesh = (w if isinstance(w, DTensor) else x).device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, rep, run_check=False)
    kdim = x.dim() - 1
    names = mesh.mesh_dim_names or ()
    xp, wp, yp, xg, wg = [], [], [], [], []
    for i in range(mesh.ndim):
        a, b = x.placements[i], w.placements[i]
        if b.is_partial() or (b.is_shard() and names[i] in ("data", "pod")):
            b = Replicate()                  # FSDP: gather the weight
        if a.is_partial():
            a = Replicate()
        if b.is_shard(0):                    # K sharded: partial sums
            a, y = Shard(kdim), Partial()
        elif b.is_shard(1):                  # N sharded: gather x's shard
            a, y = Replicate(), Shard(kdim)
        else:
            if a.is_shard(kdim):
                a = Replicate()
            y = a
        xp.append(a)
        wp.append(b)
        yp.append(y)
        # the gradients' layouts: a replicated operand's gradient is a
        # partial sum where the other operand is sharded on this dim
        xg.append(Partial() if a == Replicate() and b.is_shard(1) else a)
        wg.append(Partial() if b == Replicate() and a.is_shard()
                  and not a.is_shard(kdim) else b)
    if list(x.placements) != xp:
        x = x.redistribute(mesh, xp)
    if list(w.placements) != wp:
        w = w.redistribute(mesh, wp)
    fn = local_map(lambda xl, wl: _local_matmul(xl, wl, use_kernel),
                   out_placements=yp, in_placements=(xp, wp),
                   in_grad_placements=(xg, wg), device_mesh=mesh)
    return fn(x, w)


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


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         freq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., T, H, D) rotated by position.  positions (..., T).
    ``freq`` (D/2,) f32 replaces ``theta``'s frequencies (YaRN's)."""
    d = x.shape[-1]
    half = d // 2
    if freq is None:
        exps = -torch.arange(0, half, dtype=torch.float32,
                             device=x.device) / half
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


def out_constrain(y: torch.Tensor, policy: Policy) -> torch.Tensor:
    """Block-output sharding per TP dataflow:

    * allgather (the paper's reduction-free dataflow) and ame_pim (the
      PIM-cluster flavor sharing its mesh posture): stay feature-sharded
      on 'model' — no partial-sum reduction exists on the model axis.
    * allreduce + SP: constrain straight to the seq-sharded residual
      layout, a reduce-scatter instead of an all-reduce and a slice.
    * allreduce: replicate => the Megatron all-reduce.
    """
    if policy.tp_mode in OUTPUT_SHARDED_TP_MODES:
        return constrain(y, "batch", None, "model")
    if policy.sp and policy.sp_rs and y.dim() == 3 and y.shape[1] > 1:
        return constrain(y, "batch", "model", None)
    return constrain(y, "batch", None, None)


def mlp(p, x: torch.Tensor, act: str, backend: Backend = TORCH,
        tp_mode: str = "allreduce", policy: Optional[Policy] = None
        ) -> torch.Tensor:
    """Gated/plain MLP.  Sharding posture depends on the TP dataflow —
    see :func:`out_constrain`."""
    policy = policy or Policy(tp_mode=tp_mode)
    h = dense(p["wi"], x, backend)
    if act == "swiglu":
        h = F.silu(dense(p["wg"], x, backend)) * h
    elif act == "geglu":
        h = F.gelu(dense(p["wg"], x, backend), approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = constrain(h, "batch", None, "model")
    return out_constrain(dense(p["wo"], h, backend), policy)


# -- embedding ----------------------------------------------------------------


def embed_init(gen, vocab: int, d: int, dtype, device):
    return {"table": normal((vocab, d), gen, device, dtype, d ** -0.5)}


def embed(p, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    table = p["table"].to(compute_dtype)
    if isinstance(table, DTensor):
        return sharded_embed(table, tokens)
    return table[tokens]


def sharded_embed(table: torch.Tensor, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """``table[tokens]`` of a DTensor table on each rank's local rows
    (``local_map``; DTensor's own gather has no backward on a sharded
    table in every torch release the port meets).

    A vocab shard (dim 0) looks up the tokens in its row range and gives
    zero rows elsewhere, so the output is a ``Partial`` sum with one
    nonzero term per token, exact (Megatron's vocab-parallel embedding);
    the following ``constrain`` reduces it.  A shard of the model dim
    (FSDP) is gathered; the tokens keep their batch shards."""
    mesh = table.device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, rep, run_check=False)
    tp, kp, yp, gp = [], [], [], []
    for i in range(mesh.ndim):
        a, b = table.placements[i], tokens.placements[i]
        if a.is_shard(0):
            tp.append(a), kp.append(Replicate()), yp.append(Partial())
            gp.append(a)
        else:
            b = b if b.is_shard(0) else Replicate()
            tp.append(Replicate()), kp.append(b), yp.append(b)
            gp.append(Partial() if b.is_shard() else Replicate())
    if list(table.placements) != tp:
        table = table.redistribute(mesh, tp)
    if list(tokens.placements) != kp:
        tokens = tokens.redistribute(mesh, kp)
    off, rows = 0, table.shape[0]        # this rank's first row (even)
    for i, pl in enumerate(tp):
        if pl.is_shard(0):
            rows //= mesh.size(i)
            off += mesh.get_local_rank(i) * rows

    def lookup(tl, tok):
        if rows == tl.shape[0] == table.shape[0]:
            return tl[tok]
        idx = tok - off
        mine = (idx >= 0) & (idx < rows)
        out = tl[torch.clamp(idx, 0, rows - 1)]
        return torch.where(mine[..., None], out, torch.zeros_like(out))
    return local_map(lookup, out_placements=yp, in_placements=(tp, kp),
                     in_grad_placements=(gp, kp), device_mesh=mesh)(
        table, tokens)
