"""Lightweight metrics registry: counters, gauges, histograms.

A copy of ``repro.obs.metrics``: the port imports nothing of ``repro``,
not even its modules that do not import JAX.

The runtime's ledgers are *per-object* state — a ``PIMDevice`` knows its
own bytes, a ``StepRecord`` its own step — but serving-level questions
("what is TTFT p99 across this run?", "how many bytes crossed the host
link in total?") need accumulation across objects and time.  This module
is that accumulation layer: a :class:`MetricsRegistry` of named
instruments, each carrying a unit and a help string so reports are
self-describing (the catalog is rendered in ``docs/observability.md``).

Design constraints, in order:

* **Zero cost when off.**  Nothing here is instantiated unless a caller
  passes ``metrics=`` to a runtime/offload/server; instrumented code
  guards every touch with ``if metrics is not None``.  Ledgers, traces
  and numerics are byte-identical with metrics off (property-tested).
* **No dependencies, no threads, no exporters.**  Instruments are plain
  Python objects; :meth:`MetricsRegistry.snapshot` returns a JSON-ready
  dict — the serving simulator and the bench harness write it where
  they already write artifacts.
* **Percentiles over buckets.**  Histograms keep raw observations
  (bounded by :data:`HISTOGRAM_MAX_SAMPLES` reservoir truncation) and
  compute exact p50/p90/p99 — at simulation scale exactness beats
  bucket-boundary error, and the TTFT/TPOT gates want real percentiles.

Naming convention: dotted lowercase paths, ``<layer>.<quantity>_<unit>``
where the unit is not implied — ``runtime.h2d_bytes``, ``serve.ttft_s``,
``offload.step_pim_cycles``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Union

#: histograms keep raw samples up to this many observations; past it,
#: every k-th new sample overwrites a deterministic slot (cheap, keeps
#: the memory bound while staying reproducible — no RNG involved)
HISTOGRAM_MAX_SAMPLES = 65536


@dataclasses.dataclass
class Counter:
    """Monotonic accumulator (ops dispatched, bytes moved)."""

    name: str
    unit: str = ""
    help: str = ""
    value: float = 0.0

    def inc(self, n: Union[int, float] = 1) -> None:
        assert n >= 0, f"counter {self.name} can only increase (got {n})"
        self.value += n

    def snapshot(self) -> Dict:
        return {"type": "counter", "unit": self.unit, "value": self.value}


@dataclasses.dataclass
class Gauge:
    """Last-write-wins level (queue depth, live slots)."""

    name: str
    unit: str = ""
    help: str = ""
    value: float = 0.0

    def set(self, v: Union[int, float]) -> None:
        self.value = float(v)

    def inc(self, n: Union[int, float] = 1) -> None:
        self.value += n

    def dec(self, n: Union[int, float] = 1) -> None:
        self.value -= n

    def snapshot(self) -> Dict:
        return {"type": "gauge", "unit": self.unit, "value": self.value}


class Histogram:
    """Distribution of observations with exact percentiles.

    Keeps raw samples (reservoir-truncated past
    :data:`HISTOGRAM_MAX_SAMPLES`); ``count``/``total`` always reflect
    *every* observation, so means stay exact even when the sample buffer
    saturates.
    """

    def __init__(self, name: str, unit: str = "", help: str = ""):
        self.name = name
        self.unit = unit
        self.help = help
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: List[float] = []

    def record(self, v: Union[int, float]) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self._samples) < HISTOGRAM_MAX_SAMPLES:
            self._samples.append(v)
        else:  # deterministic overwrite keeps the buffer representative
            self._samples[self.count % HISTOGRAM_MAX_SAMPLES] = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Exact linear-interpolation percentile of the recorded samples
        (``p`` in [0, 100]); 0.0 when nothing was recorded."""
        if not self._samples:
            return 0.0
        xs = sorted(self._samples)
        rank = (len(xs) - 1) * p / 100.0
        lo = math.floor(rank)
        hi = math.ceil(rank)
        if lo == hi:
            return xs[lo]
        return xs[lo] + (xs[hi] - xs[lo]) * (rank - lo)

    def summary(self) -> Dict:
        """The percentile summary the latency gates read."""
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }

    def snapshot(self) -> Dict:
        return {"type": "histogram", "unit": self.unit, **self.summary()}


Instrument = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Named instruments, get-or-create by name.

    One registry per observed scope (a server run, an offload sidecar, a
    bench section); pass the same registry to several layers to merge
    their streams.  Re-requesting a name returns the existing instrument
    — the ``unit``/``help`` of the first registration win — and
    requesting an existing name as a different instrument type raises.
    """

    def __init__(self):
        self._instruments: Dict[str, Instrument] = {}

    def _get(self, cls, name: str, unit: str, help: str) -> Instrument:
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, unit, help)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str, unit: str = "", help: str = "") -> Counter:
        return self._get(Counter, name, unit, help)

    def gauge(self, name: str, unit: str = "", help: str = "") -> Gauge:
        return self._get(Gauge, name, unit, help)

    def histogram(self, name: str, unit: str = "",
                  help: str = "") -> Histogram:
        return self._get(Histogram, name, unit, help)

    def get(self, name: str) -> Optional[Instrument]:
        return self._instruments.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def __len__(self) -> int:
        return len(self._instruments)

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-ready view of every instrument, sorted by name."""
        return {name: self._instruments[name].snapshot()
                for name in sorted(self._instruments)}

    def catalog(self) -> List[Dict[str, str]]:
        """The (name, type, unit, help) rows of everything registered."""
        return [{"name": n, "type": type(i).__name__.lower(),
                 "unit": i.unit, "help": i.help}
                for n, i in sorted(self._instruments.items())]
