"""PyTorch/CUDA port of the AME-PIM reproduction.

A second package beside the JAX reference ``repro``: module names mirror
``repro`` so each counterpart is easy to find.  It imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``.  Every Pallas TPU kernel on
a ported path is a hand-written Hopper kernel under ``kernels/csrc``.
"""
