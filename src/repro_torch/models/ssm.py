"""Mamba2 (SSD) block — the state-space arch whose recurrent state update is
the paper's outer-product accumulation (rank-1 updates into a resident
accumulator).

Port of ``repro.models.ssm``.  Prefill runs the chunked SSD scan (K4
``ssd_scan`` under the kernel backend on the card, its plain version
otherwise); decode advances the recurrence one step with O(1) state:
  conv_state (B, d_conv-1, conv_dim), ssm_state (B, H, N, P).
The reference's sharding constraints are made at the same places (heads
on 'model' through the scan); they are no-ops without a mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (
    TORCH, Backend, apply_norm, dense, dense_init, norm_init, normal,
    out_constrain,
)
from repro_torch.sharding.context import constrain, einsum


def dims(cfg: ArchConfig):
    """``(d_inner, nheads, conv_dim, d_proj)`` of the mamba block;
    ``d_proj`` is in_proj's width (z, x, B, C, dt)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, nheads, conv_dim, d_inner + conv_dim + nheads


def mamba_init(gen, cfg: ArchConfig, dtype, device, layers: int = 0):
    """``layers > 0`` stacks that many independent blocks on a leading
    axis.  ``a_log``, ``d_skip`` and ``dt_bias`` are f32 whatever
    ``dtype`` is, as in the reference."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim, d_proj = dims(cfg)
    lead = (layers,) if layers else ()
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, d, d_proj, dtype, device, layers=layers),
        "conv_w": normal(lead + (s.d_conv, conv_dim), gen, device, dtype,
                         s.d_conv ** -0.5),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "a_log": torch.zeros(lead + (nheads,), dtype=f32, device=device),
        "d_skip": torch.ones(lead + (nheads,), dtype=f32, device=device),
        "dt_bias": torch.zeros(lead + (nheads,), dtype=f32, device=device),
        "norm": norm_init(d_inner, dtype, device, layers=layers),
        "out_proj": dense_init(gen, d_inner, d, dtype, device, layers=layers),
    }


def mamba_make_state(cfg: ArchConfig, batch: int, dtype, device,
                     layers: Optional[int] = None) -> Dict:
    s = cfg.ssm
    _, nheads, conv_dim, _ = dims(cfg)
    cs = (batch, s.d_conv - 1, conv_dim)
    ss = (batch, nheads, s.d_state, s.head_dim)
    if layers is not None:
        cs, ss = (layers,) + cs, (layers,) + ss
    return {"conv": torch.zeros(cs, dtype=dtype, device=device),
            "ssm": torch.zeros(ss, dtype=torch.float32, device=device)}


def mamba_apply(p, u: torch.Tensor, cfg: ArchConfig, *,
                state: Optional[Dict] = None, backend: Backend = TORCH
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """u (B,T,d).  state=None: full-sequence scan.  state given: prefill
    (T > 1, chunked scan plus the closed-form final state) or one
    recurrent decode step (T == 1).  Returns ``(out, new_state)``; the
    given state is not written."""
    s = cfg.ssm
    b, t, _ = u.shape
    d_inner, nheads, conv_dim, _ = dims(cfg)
    g, n, hp = s.n_groups, s.d_state, s.head_dim
    gn = g * n
    proj = dense(p["in_proj"], u, backend)
    z, xc, bc, cc, dt = torch.split(proj, [d_inner, d_inner, gn, gn, nheads],
                                    -1)
    xbc = torch.cat([xc, bc, cc], -1)                      # conv'd together

    new_state = None
    if state is None:
        pad = torch.zeros((b, s.d_conv - 1, conv_dim), dtype=xbc.dtype,
                          device=xbc.device)
        seq = torch.cat([pad, xbc], 1)
    else:
        seq = torch.cat([state["conv"].to(xbc.dtype), xbc], 1)
        new_conv = seq[:, -(s.d_conv - 1):]
    # causal depthwise conv, width d_conv
    conv = sum(seq[:, i:i + t] * p["conv_w"][i].to(xbc.dtype)
               for i in range(s.d_conv))
    conv = F.silu(conv + p["conv_b"].to(xbc.dtype))
    xs, bs, cs_ = torch.split(conv, [d_inner, gn, gn], -1)

    dt = F.softplus(dt.float() + p["dt_bias"])              # (B,T,H)
    log_a = -torch.exp(p["a_log"])[None, None, :] * dt      # (B,T,H) <= 0
    xh = xs.reshape(b, t, nheads, hp)
    xh = constrain(xh, "batch", None, "model", None)
    bg = bs.reshape(b, t, g, n)
    cg = cs_.reshape(b, t, g, n)
    rep = nheads // g

    if state is None or t > 1:
        # chunked SSD over the whole sequence, heads batched; x*dt is f32
        # (bf16 x f32 promotes), b and c stay in the compute dtype.  The
        # scan reads (B,H,T,.) views of the (B,T,H,.) tensors; with one
        # group every head reads the same b and c (a head-stride-0 view)
        xdt = xh * dt[..., None]
        la = log_a.transpose(1, 2).contiguous()            # (B,H,T)
        if g == 1:
            bh_rep = bg.expand(b, t, nheads, n)
            ch_rep = cg.expand(b, t, nheads, n)
        else:
            bh_rep = bg.repeat_interleave(rep, 2)
            ch_rep = cg.repeat_interleave(rep, 2)
        # 4-D (B,H,T,.) keeps heads a shardable 'model' axis
        x4 = constrain(xdt.transpose(1, 2), "batch", "model", None, None)
        la4 = constrain(la, "batch", "model", None)
        b4 = constrain(bh_rep.transpose(1, 2), "batch", "model", None, None)
        c4 = constrain(ch_rep.transpose(1, 2), "batch", "model", None, None)
        y = ops.ssd4(x4, la4, b4, c4, use_kernel=backend.mode == "kernel",
                     chunk=s.chunk)
        y = constrain(y, "batch", "model", None, None)
        y = y.transpose(1, 2)                              # (B,T,H,P)
        if state is not None:
            # prefill: closed-form final state (log_a <= 0 so the weights
            # exp(cum_T - cum_t) never overflow):
            #   S = a_total * S_in + sum_t exp(cum_T - cum_t) b_t (x*dt)_t
            cum = torch.cumsum(la, -1)                     # (B,H,T)
            wts = torch.exp(cum[..., -1:] - cum).transpose(1, 2)
            s_new = einsum("bthn,bthp->bhnp",
                                 bh_rep.float() * wts[..., None],
                                 xdt.float())
            s_new = s_new + torch.exp(cum[..., -1])[..., None, None] \
                * state["ssm"]
            new_state = {"conv": new_conv.to(state["conv"].dtype),
                         "ssm": s_new}
    else:
        # one-step recurrence: S = a*S + dt*x (outer) B ; y = C @ S
        a1 = torch.exp(log_a[:, 0])                         # (B,H)
        bx = einsum("bhn,bhp->bhnp",
                          bg[:, 0].repeat_interleave(rep, 1).float(),
                          (xh[:, 0] * dt[:, 0, :, None]).float())
        ssm_new = a1[..., None, None] * state["ssm"] + bx
        ch = cg[:, 0].repeat_interleave(rep, 1).float()     # (B,H,N)
        y = einsum("bhn,bhnp->bhp", ch, ssm_new)[:, None]
        new_state = {"conv": new_conv.to(state["conv"].dtype),
                     "ssm": ssm_new}

    y = y.to(u.dtype) + p["d_skip"].to(u.dtype)[None, None, :, None] * xh
    y = y.reshape(b, t, d_inner)
    y = apply_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return out_constrain(dense(p["out_proj"], y, backend), cfg.policy), \
        new_state
