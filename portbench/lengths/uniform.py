"""Lengths uniform over [lo, hi] (``repro_torch.serve.traffic``'s)."""
import numpy as np


def draw(rng: np.random.Generator, lo: int, hi: int, n: int) -> np.ndarray:
    return rng.integers(lo, hi + 1, size=n, dtype=np.int64)
