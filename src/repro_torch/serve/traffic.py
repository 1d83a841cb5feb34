"""Production-traffic layer: clocks, arrival traces, cost models, SLOs.

Port of ``repro.serve.traffic``, with the decode step's matmul set
(``DecodeMatmul``, ``decode_matmuls``) that the reference keeps in
``repro.serve.offload``; :mod:`repro_torch.serve.offload` re-exports it.

* **Virtual time** — :class:`SimClock` (the determinism substrate) and
  :class:`WallClock` (the ``wall=True`` escape hatch).
* **Arrival processes** — :func:`poisson_trace` and :func:`bursty_trace`
  (Gamma inter-arrivals with a chosen coefficient of variation), seeded
  with the reference's domain-separated ``numpy`` generators so the
  traces are ``==`` to its; :class:`Trace` saves and loads them as JSON.
* **MoE routing histograms** — :class:`RoutingProfile`,
  :func:`uniform_routing`, :func:`zipf_routing`; they drive
  :func:`repro_torch.sharding.rules.ame_pim_expert_placement` and the
  routed decode dispatch of :class:`repro_torch.serve.offload.
  DecodeOffload`.
* **Host cost model** — :class:`HostCostModel` prices prefill and the
  host decode step against the port's H100 descriptor
  (:mod:`repro_torch.launch.hw`) unless the caller passes other
  ``peak_flops``/``hbm_bw`` (the parity tests pass the reference's).
* **SLOs and autoscaling** — :class:`SLO` and the slot policies
  :class:`StaticSlots`, :class:`QueueProportionalSlots`,
  :class:`SLOFeedbackSlots`.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

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
    """``time.perf_counter()`` behind the :class:`SimClock` interface —
    the ``Server(wall=True)`` escape hatch, on the clock of the serve
    path's spans (:mod:`repro_torch.obs.spans`).  Advancing is a no-op:
    wall time moves on its own."""

    @property
    def now(self) -> float:
        return time.perf_counter()

    def advance(self, dt: float) -> float:
        return time.perf_counter()

    def advance_to(self, t: float) -> float:
        return time.perf_counter()


# ---------------------------------------------------------------------------
# Arrival traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival of the workload: *when*, and how much work."""

    uid: int
    at_s: float                 # arrival time, trace-relative seconds
    prompt_len: int
    max_new: int


@dataclasses.dataclass
class Trace:
    """A replayable arrival trace: sorted requests + generator metadata.

    ``save``/``load`` round-trip through a small JSON format so a sweep
    can commit its exact workload; equality is field equality, so a
    loaded trace ``==`` the generated one.
    """

    requests: List[TraceRequest]
    meta: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.requests = sorted(self.requests, key=lambda r: (r.at_s, r.uid))

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self) -> Iterator[TraceRequest]:
        return iter(self.requests)

    @property
    def duration_s(self) -> float:
        """Arrival span (first to last request)."""
        if not self.requests:
            return 0.0
        return self.requests[-1].at_s - self.requests[0].at_s

    @property
    def arrival_rate_rps(self) -> float:
        """Empirical mean arrival rate over the trace's span."""
        if len(self.requests) < 2 or self.duration_s <= 0:
            return 0.0
        return (len(self.requests) - 1) / self.duration_s

    def save(self, path: str) -> None:
        rec = {"meta": self.meta,
               "requests": [dataclasses.asdict(r) for r in self.requests]}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            rec = json.load(f)
        return cls(requests=[TraceRequest(**r) for r in rec["requests"]],
                   meta=rec.get("meta", {}))


def _lengths(rng, n: int, spec: Union[int, Tuple[int, int]]) -> List[int]:
    """Materialize a per-request length column: a fixed int, or an
    inclusive ``(lo, hi)`` range drawn uniformly."""
    if isinstance(spec, int):
        return [spec] * n
    lo, hi = spec
    return [int(v) for v in rng.integers(lo, hi + 1, size=n)]


def _build(gaps, n: int, seed: int, kind: str, rate_rps: float,
           prompt_len, max_new, rng, extra: Optional[Dict] = None) -> Trace:
    prompts = _lengths(rng, n, prompt_len)
    news = _lengths(rng, n, max_new)
    t, reqs = 0.0, []
    for i in range(n):
        t += float(gaps[i])
        reqs.append(TraceRequest(uid=i, at_s=t, prompt_len=prompts[i],
                                 max_new=news[i]))
    meta = {"kind": kind, "seed": seed, "rate_rps": rate_rps, "n": n,
            "prompt_len": list(prompt_len)
            if not isinstance(prompt_len, int) else prompt_len,
            "max_new": list(max_new)
            if not isinstance(max_new, int) else max_new}
    meta.update(extra or {})
    return Trace(requests=reqs, meta=meta)


def poisson_trace(rate_rps: float, n: int, *, seed: int = 0,
                  prompt_len: Union[int, Tuple[int, int]] = 512,
                  max_new: Union[int, Tuple[int, int]] = 32) -> Trace:
    """``n`` arrivals of a Poisson process at ``rate_rps`` requests/s
    (exponential inter-arrival gaps), seeded and replayable."""
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    rng = np.random.default_rng((7919, seed))      # domain-separated seed
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    return _build(gaps, n, seed, "poisson", rate_rps, prompt_len, max_new,
                  rng)


def bursty_trace(rate_rps: float, n: int, *, cv: float = 3.0, seed: int = 0,
                 prompt_len: Union[int, Tuple[int, int]] = 512,
                 max_new: Union[int, Tuple[int, int]] = 32) -> Trace:
    """``n`` arrivals with Gamma inter-arrivals at mean rate ``rate_rps``
    and coefficient of variation ``cv`` (> 1 = burstier than Poisson —
    production LLM traffic measures cv 3-4)."""
    if rate_rps <= 0 or cv <= 0:
        raise ValueError(f"rate_rps and cv must be > 0 "
                         f"(got {rate_rps}, {cv})")
    rng = np.random.default_rng((104729, seed))    # domain-separated seed
    shape = 1.0 / (cv * cv)                    # Gamma: cv^2 = 1/shape
    scale = 1.0 / (rate_rps * shape)           # keeps the mean at 1/rate
    gaps = rng.gamma(shape, scale, size=n)
    return _build(gaps, n, seed, "bursty", rate_rps, prompt_len, max_new,
                  rng, extra={"cv": cv})



# ---------------------------------------------------------------------------
# MoE routing histograms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RoutingProfile:
    """Per-layer MoE expert-selection histogram: ``counts[layer][expert]``
    routed-token assignments (each decoded token contributes ``top_k``
    selections per MoE layer).

    This is the currency of routed-traffic-aware placement: generators
    below synthesize seeded skew (:func:`zipf_routing`,
    :func:`uniform_routing`), :class:`repro_torch.serve.offload.DecodeOffload`
    *records* its observed selections into one (trace replay), and
    :func:`repro_torch.sharding.rules.ame_pim_expert_placement` consumes one
    to balance expected token mass over stacks.  ``save``/``load``
    round-trip through JSON with field equality, same as :class:`Trace`.
    """

    n_layers: int               # MoE layers only (dense layers excluded)
    n_experts: int
    counts: List[List[int]]
    meta: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if len(self.counts) != self.n_layers or any(
                len(row) != self.n_experts for row in self.counts):
            raise ValueError(
                f"counts must be {self.n_layers} x {self.n_experts}")

    @classmethod
    def empty(cls, n_layers: int, n_experts: int,
              meta: Optional[Dict] = None) -> "RoutingProfile":
        return cls(n_layers, n_experts,
                   [[0] * n_experts for _ in range(n_layers)],
                   meta=dict(meta or {}))

    # -- recording (trace replay) -------------------------------------------

    def record(self, layer: int, expert: int, tokens: int = 1) -> None:
        self.counts[layer][expert] += int(tokens)

    def record_counts(self, layer: int, sel: Dict[int, int]) -> None:
        row = self.counts[layer]
        for expert, tokens in sel.items():
            row[expert] += int(tokens)

    # -- views ---------------------------------------------------------------

    @property
    def total_tokens(self) -> int:
        return sum(sum(row) for row in self.counts)

    def layer_total(self, layer: int) -> int:
        return sum(self.counts[layer])

    def probs(self, layer: int) -> List[float]:
        """Selection probabilities for one layer (uniform when the layer
        has recorded nothing — an empty histogram routes like one)."""
        total = self.layer_total(layer)
        if total <= 0:
            return [1.0 / self.n_experts] * self.n_experts
        return [c / total for c in self.counts[layer]]

    def expert_mass(self) -> List[int]:
        """Per-expert token mass summed over layers."""
        return [sum(row[e] for row in self.counts)
                for e in range(self.n_experts)]

    def drift(self, other: "RoutingProfile") -> float:
        """Max over layers of the total-variation distance between the
        two normalized histograms (0 = identical mix, 1 = disjoint).
        Layers empty on either side are skipped — no evidence yet."""
        if (self.n_layers, self.n_experts) != (other.n_layers,
                                               other.n_experts):
            raise ValueError("profiles have different shapes")
        worst = 0.0
        for layer in range(self.n_layers):
            if self.layer_total(layer) <= 0 or other.layer_total(layer) <= 0:
                continue
            p, q = self.probs(layer), other.probs(layer)
            worst = max(worst, 0.5 * sum(abs(a - b) for a, b in zip(p, q)))
        return worst

    def copy(self) -> "RoutingProfile":
        return RoutingProfile(self.n_layers, self.n_experts,
                              [list(row) for row in self.counts],
                              meta=dict(self.meta))

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        rec = {"n_layers": self.n_layers, "n_experts": self.n_experts,
               "counts": self.counts, "meta": self.meta}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "RoutingProfile":
        with open(path) as f:
            rec = json.load(f)
        return cls(n_layers=rec["n_layers"], n_experts=rec["n_experts"],
                   counts=[list(row) for row in rec["counts"]],
                   meta=rec.get("meta", {}))


def uniform_routing(n_layers: int, n_experts: int, tokens_per_layer: int,
                    *, seed: int = 0) -> RoutingProfile:
    """Seeded uniform routing: ``tokens_per_layer`` multinomial draws per
    layer with equal expert probabilities — the no-skew baseline."""
    rng = np.random.default_rng((15485863, seed))   # domain-separated seed
    counts = [list(map(int, rng.multinomial(
        tokens_per_layer, [1.0 / n_experts] * n_experts)))
        for _ in range(n_layers)]
    return RoutingProfile(n_layers, n_experts, counts,
                          meta={"kind": "uniform", "seed": seed,
                                "tokens_per_layer": tokens_per_layer})


def zipf_routing(n_layers: int, n_experts: int, tokens_per_layer: int,
                 *, alpha: float = 1.0, seed: int = 0) -> RoutingProfile:
    """Seeded Zipf-skewed routing: expert selection probabilities fall as
    ``1 / rank^alpha``, with an independent per-layer permutation mapping
    ranks to expert ids (hot experts differ layer to layer, as measured
    routed traffic does).  ``alpha=1.0`` reproduces the heavy skew the
    Mixtral/DeepSeek-V3 reports describe."""
    if alpha < 0:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    rng = np.random.default_rng((86028157, seed))   # domain-separated seed
    weights = [1.0 / (r + 1) ** alpha for r in range(n_experts)]
    total = sum(weights)
    probs = [w / total for w in weights]
    counts = []
    for _ in range(n_layers):
        perm = rng.permutation(n_experts)
        ranked = rng.multinomial(tokens_per_layer, probs)
        row = [0] * n_experts
        for rank, expert in enumerate(perm):
            row[int(expert)] = int(ranked[rank])
        counts.append(row)
    return RoutingProfile(n_layers, n_experts, counts,
                          meta={"kind": "zipf", "alpha": alpha, "seed": seed,
                                "tokens_per_layer": tokens_per_layer})



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


# ---------------------------------------------------------------------------
# SLOs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLO:
    """A per-request latency objective: TTFT and TPOT bounds in seconds.

    A request *meets* the SLO when its TTFT is within ``ttft_s`` and its
    decode tail averages within ``tpot_s`` per token (single-token
    requests have no TPOT and are judged on TTFT alone).  Goodput is
    the rate of SLO-met completions — the paper-grade serving metric.
    """

    ttft_s: float
    tpot_s: float

    def met(self, ttft: float, tpot: Optional[float]) -> bool:
        if ttft > self.ttft_s:
            return False
        return tpot is None or tpot <= self.tpot_s


# ---------------------------------------------------------------------------
# Slot autoscaling policies
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StaticSlots:
    """No autoscaling: hold ``slots`` decode slots forever."""

    slots: int

    def target(self, *, queue_len: int, slots: int, live: int,
               recent_ttft: Sequence[float]) -> int:
        return self.slots


@dataclasses.dataclass
class QueueProportionalSlots:
    """Scale decode slots with queue depth: one extra slot per
    ``per_queue`` queued requests above empty, clamped to
    ``[min_slots, max_slots]``.  Purely reactive — no SLO knowledge."""

    min_slots: int = 1
    max_slots: int = 16
    per_queue: int = 4

    def target(self, *, queue_len: int, slots: int, live: int,
               recent_ttft: Sequence[float]) -> int:
        want = self.min_slots + queue_len // max(1, self.per_queue)
        return max(self.min_slots, min(self.max_slots, want))


@dataclasses.dataclass
class SLOFeedbackSlots:
    """Closed-loop policy: grow while the recent TTFT tail violates the
    SLO, shrink when it sits comfortably inside it.

    Looks at the last ``window`` admitted requests' TTFTs: if the
    worst exceeds ``slo.ttft_s`` grow by one slot; if every one is
    under ``shrink_frac`` of the bound, give a slot back.
    """

    slo: SLO
    min_slots: int = 1
    max_slots: int = 16
    window: int = 16
    shrink_frac: float = 0.5

    def target(self, *, queue_len: int, slots: int, live: int,
               recent_ttft: Sequence[float]) -> int:
        recent = list(recent_ttft)[-self.window:]
        want = slots
        if recent and max(recent) > self.slo.ttft_s:
            want = slots + 1
        elif recent and max(recent) <= self.shrink_frac * self.slo.ttft_s \
                and queue_len == 0:
            want = slots - 1
        return max(self.min_slots, min(self.max_slots, want))
