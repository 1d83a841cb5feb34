"""Atomic, asynchronous checkpoints (port of ``repro.checkpoint``)."""
