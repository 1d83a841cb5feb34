"""Lengths whose logarithm is uniform over [lo, hi]: as many prompts of
32-64 tokens as of 512-1024."""
import numpy as np


def draw(rng: np.random.Generator, lo: int, hi: int, n: int) -> np.ndarray:
    x = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), size=n))
    return np.clip(np.floor(x).astype(np.int64), lo, hi)
