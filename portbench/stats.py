"""Percentiles, rates and spreads of a run's stamps.

``percentile`` is a frozen copy of ``repro_torch.obs.metrics.Histogram.
percentile`` (exact, linear interpolation between order statistics),
taking ``inf`` for a request that never got its first token: such a
request sorts above every finite time, so it counts as missing any
limit.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

MISSING = math.inf


def percentile(values: Sequence[float], p: float) -> float:
    """Exact linear-interpolation percentile (``p`` in [0, 100]); ``inf``
    when it falls on or next to a missing value, ``nan`` for none."""
    if not values:
        return math.nan
    xs = sorted(values)
    rank = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(rank), math.ceil(rank)
    if lo == hi:
        return xs[lo]
    if math.isinf(xs[hi]):
        return MISSING
    return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)


def ttft_s(requests: List[Dict]) -> List[float]:
    """Due time to first token of every request due in the window."""
    return [r["first_token_at"] - r["due"] if r["first_token_at"] is not None
            else MISSING for r in requests]


def itl_s(requests: List[Dict], t_end: float) -> List[float]:
    """Gaps between consecutive output tokens that end by ``t_end``."""
    return [b - a for r in requests
            for a, b in zip(r["stamps"], r["stamps"][1:]) if b <= t_end]


def tokens_in(requests: List[Dict], t0: float, t_end: float) -> int:
    """Output tokens delivered inside [t0, t_end]."""
    return sum(t0 <= s <= t_end for r in requests for s in r["stamps"])


def ttft_tail_ms(run, p: float) -> float:
    """The p-th percentile of due -> first token over the window's
    requests, ms.  Where it falls among the missing, the longest wait
    any of them had when the run stopped (a lower bound)."""
    v = percentile(ttft_s(run.requests), p)
    if math.isinf(v):
        v = max(run.t_last - r["due"] for r in run.requests
                if r["first_token_at"] is None)
    return 1e3 * v


def itl_tail_ms(run, p: float):
    """The p-th percentile of the gaps that end in the window, ms; None
    when no request got a second token."""
    gaps = itl_s(run.requests, run.t_end)
    return 1e3 * percentile(gaps, p) if gaps else None
