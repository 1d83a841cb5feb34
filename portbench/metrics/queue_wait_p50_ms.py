"""Median wait in the Server's queue, ms: from each request's due time to
``admitted_at`` (its prefill starts, ``serve/loop.py:Server._admit``),
over every request due in the window; one never admitted counts as
missing."""
import math

from portbench import stats


def read(run):
    waits = [r["admitted_at"] - r["due"] if r["admitted_at"] is not None
             else math.inf for r in run.requests]
    v = stats.percentile(waits, 50)
    return 1e3 * v if math.isfinite(v) else None
