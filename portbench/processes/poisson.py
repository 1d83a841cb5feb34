"""Poisson arrivals: a Poisson process that holds ``n`` arrivals in the
window has them at ``n`` sorted uniform times (the method of
``repro_torch.serve.traffic.poisson_trace``, frozen)."""
import numpy as np


def due(rng: np.random.Generator, n: int, seconds: float) -> np.ndarray:
    return np.sort(rng.uniform(0.0, seconds, n))
