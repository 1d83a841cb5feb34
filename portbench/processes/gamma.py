"""Bursty arrivals: gaps drawn from a Gamma distribution with coefficient
of variation ``cv`` (shape 1 / cv^2; cv 1 is Poisson, cv 3 the burstiness
that BurstGPT, arXiv:2401.17644, reads in conversation traces), scaled so
that the ``n`` arrivals fill the window as the rate says."""
import numpy as np


def due(rng: np.random.Generator, n: int, seconds: float,
        cv: float) -> np.ndarray:
    if cv <= 0:
        raise ValueError(f"cv must be > 0, got {cv}")
    gaps = rng.gamma(1.0 / cv ** 2, 1.0, n + 1)
    return seconds * np.cumsum(gaps)[:n] / gaps.sum()
