"""Observability: timeline profiling, critical-path attribution, metrics.

The runtime's ledgers answer "how much"; this package answers "when",
"why", and "how is it distributed":

* :mod:`repro_torch.obs.profile` — capture an op log (an async runtime's
  timeline, or a :class:`Profiler` shadow log on a serialized runtime)
  and export it as Chrome Trace Event JSON for Perfetto.
* :mod:`repro_torch.obs.critical_path` — walk the op DAG backward from the
  retiring op and partition the makespan into channel-bound /
  link-bound / slack segments (:class:`ProfileReport`).
* :mod:`repro_torch.obs.metrics` — counters / gauges / histograms with exact
  percentiles; instrumented in ``PIMRuntime``, ``PIMCluster``,
  ``DecodeOffload`` and the serve loop (TTFT/TPOT).
* :mod:`repro_torch.obs.spans` — the served path on the card, on the host's
  ``perf_counter`` clock: a :class:`SpanRecorder` given to ``Server(spans=)``
  records each step's span tree (admission, prefill, decode, the model's
  blocks) and every K1 launch under its span.

``python -m repro_torch.obs <file>`` summarizes a ``.trace`` file, a Chrome
trace JSON, or a dumped :class:`ProfileReport`.  See
``docs/observability.md`` for the formats and the metrics catalog.  Port
of ``repro.obs``.
"""
from repro_torch.obs.critical_path import PathSegment, ProfileReport, critical_path
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.profile import (
    Profiler,
    US_PER_CYCLE,
    chrome_trace,
    export_chrome_trace,
    profile_report,
)
from repro_torch.obs.spans import SpanRecorder

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PathSegment",
    "ProfileReport",
    "Profiler",
    "SpanRecorder",
    "US_PER_CYCLE",
    "chrome_trace",
    "critical_path",
    "export_chrome_trace",
    "profile_report",
]
