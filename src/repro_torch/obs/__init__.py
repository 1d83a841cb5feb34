"""Observability (port of ``repro.obs``): the metrics registry."""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry,
)
