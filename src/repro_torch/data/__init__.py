"""The deterministic synthetic data pipeline (port of ``repro.data``)."""
