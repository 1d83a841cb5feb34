"""Ported architecture configs.  Importing this package registers every
ported arch in ``base.ARCHS`` (qwen3-1.7b and mamba2-370m so far)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCHS, ArchConfig, HybridConfig, MLAConfig, MoEConfig, Policy,
    SSMConfig, get, register,
)
from repro_torch.configs import mamba2_370m, qwen3_1_7b  # noqa: F401
