"""Virtual time and the host cost model of the serving loop.

Port of the parts of ``repro.serve.traffic`` (``SimClock``,
``WallClock``, ``HostCostModel``) and ``repro.serve.offload``
(``DecodeMatmul``, ``decode_matmuls``) that :class:`repro_torch.serve.
loop.Server` reads.  Arrival traces, routing profiles, SLOs and
autoscaling wait for the offload slice.

The cost model prices against the port's H100 descriptor
(:mod:`repro_torch.launch.hw`) unless the caller passes other
``peak_flops``/``hbm_bw`` (the parity tests pass the reference's).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import hw

#: bytes per weight/activation element in the cost model (FP16/BF16)
BYTES_PER_ELEM = 2


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------


class SimClock:
    """Virtual simulated-seconds clock; the determinism substrate.

    Only ever moves forward: :meth:`advance` by a non-negative delta,
    :meth:`advance_to` to an absolute time (a no-op if already past).
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        self._now = max(self._now, float(t))
        return self._now


class WallClock:
    """``time.time()`` behind the :class:`SimClock` interface — the
    ``Server(wall=True)`` escape hatch.  Advancing is a no-op: wall time
    moves on its own."""

    @property
    def now(self) -> float:
        return time.time()

    def advance(self, dt: float) -> float:
        return time.time()

    def advance_to(self, t: float) -> float:
        return time.time()


# ---------------------------------------------------------------------------
# The decode step's matmul set
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DecodeMatmul:
    """One weight matmul of the decode step: y(out) = W(out, in) @ h(in).

    ``count`` is the per-step multiplicity (layers; active experts)."""

    name: str
    out_dim: int
    in_dim: int
    count: int = 1

    @property
    def weight_bytes(self) -> int:
        return self.out_dim * self.in_dim * BYTES_PER_ELEM * self.count


def decode_matmuls(cfg: ArchConfig) -> List[DecodeMatmul]:
    """The per-step weight matmuls of one decode token for ``cfg``
    (dense / vlm text stack / moe decoders)."""
    if cfg.family not in ("dense", "vlm", "moe") or cfg.encoder_only:
        raise ValueError(
            f"decode matmuls model dense/moe decoder stacks, not "
            f"{cfg.family!r}")
    d, hd = cfg.d_model, cfg.head_dim_
    L = cfg.n_layers
    mm = [
        DecodeMatmul("attn.wq", cfg.n_heads * hd, d, L),
        DecodeMatmul("attn.wk", cfg.n_kv_heads * hd, d, L),
        DecodeMatmul("attn.wv", cfg.n_kv_heads * hd, d, L),
        DecodeMatmul("attn.wo", d, cfg.n_heads * hd, L),
    ]
    gated = cfg.act in ("swiglu", "geglu")
    if cfg.moe is None:
        mm += [DecodeMatmul("mlp.wi", cfg.d_ff, d, L)]
        if gated:
            mm += [DecodeMatmul("mlp.wg", cfg.d_ff, d, L)]
        mm += [DecodeMatmul("mlp.wo", d, cfg.d_ff, L)]
    else:
        moe = cfg.moe
        n_moe = L - moe.first_dense_layers
        if moe.first_dense_layers:
            mm += [DecodeMatmul("mlp.wi", cfg.d_ff, d,
                                moe.first_dense_layers)]
            if gated:
                mm += [DecodeMatmul("mlp.wg", cfg.d_ff, d,
                                    moe.first_dense_layers)]
            mm += [DecodeMatmul("mlp.wo", d, cfg.d_ff,
                                moe.first_dense_layers)]
        # per token: router + top_k routed experts + shared experts
        active = moe.top_k + moe.n_shared
        mm += [DecodeMatmul("moe.router", moe.num_experts, d, n_moe)]
        mm += [DecodeMatmul("moe.expert.wi", moe.d_ff_expert, d,
                            n_moe * active)]
        if gated:
            mm += [DecodeMatmul("moe.expert.wg", moe.d_ff_expert, d,
                                n_moe * active)]
        mm += [DecodeMatmul("moe.expert.wo", d, moe.d_ff_expert,
                            n_moe * active)]
    mm += [DecodeMatmul("lm_head", cfg.vocab_padded, d, 1)]
    return mm


# ---------------------------------------------------------------------------
# Host-side cost model (prefill roofline + KV handoff bytes)
# ---------------------------------------------------------------------------


class HostCostModel:
    """Analytic roofline prices of the serving device.

    ``prefill_s(T)`` is ``max(T * flops_per_token / peak, weight_bytes /
    bw)`` — compute-bound for long prompts, weight-read-bound for short
    ones.  ``decode_step_s`` prices one decode iteration (the Server's
    virtual clock).  ``kv_ship_bytes(T)`` is the K+V a ``T``-token
    prefill produces.  Families outside :func:`decode_matmuls` fall back
    to a generic dense-transformer estimate.
    """

    def __init__(self, cfg: ArchConfig, *,
                 peak_flops: float = None, hbm_bw: float = None):
        self.cfg = cfg
        self.peak_flops = float(peak_flops if peak_flops is not None
                                else hw.PEAK_FLOPS)
        self.hbm_bw = float(hbm_bw if hbm_bw is not None else hw.HBM_BW)
        try:
            mats = decode_matmuls(cfg)
            self.weight_bytes = sum(m.weight_bytes for m in mats)
            self.flops_per_token = 2 * sum(
                m.out_dim * m.in_dim * m.count for m in mats)
            self.act_bytes_per_token = sum(
                m.in_dim * m.count for m in mats) * BYTES_PER_ELEM
        except ValueError:      # family outside the decode matmul set
            d = getattr(cfg, "d_model", 1024)
            L = getattr(cfg, "n_layers", 16)
            vocab = getattr(cfg, "vocab_padded",
                            getattr(cfg, "vocab_size", 32000))
            params = L * 12 * d * d + vocab * d
            self.weight_bytes = params * BYTES_PER_ELEM
            self.flops_per_token = 2 * params
            self.act_bytes_per_token = L * 7 * d * BYTES_PER_ELEM
        heads = max(1, getattr(cfg, "n_kv_heads", 1) or 1)
        hd = getattr(cfg, "head_dim_", getattr(cfg, "head_dim", 64)) or 64
        L = getattr(cfg, "n_layers", 16)
        #: K + V bytes one token adds across every layer
        self.kv_bytes_per_token = L * heads * hd * 2 * BYTES_PER_ELEM

    def prefill_s(self, tokens: int) -> float:
        """Roofline seconds to prefill ``tokens`` prompt tokens (always
        > 0 — the weight read is a hard floor)."""
        tokens = max(1, int(tokens))
        return max(tokens * self.flops_per_token / self.peak_flops,
                   self.weight_bytes / self.hbm_bw)

    def decode_step_s(self, batch: int) -> float:
        """Roofline seconds for one decode iteration over ``batch`` live
        slots (weight-read bound at serving batch)."""
        batch = max(1, int(batch))
        return max(batch * self.flops_per_token / self.peak_flops,
                   (self.weight_bytes
                    + batch * self.act_bytes_per_token) / self.hbm_bw)

    def kv_ship_bytes(self, tokens: int) -> int:
        """K/V bytes a ``tokens``-token prefill produces."""
        return int(tokens) * self.kv_bytes_per_token
