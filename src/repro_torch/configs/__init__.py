"""Ported architecture configs.  Importing this package registers every
ported arch in ``base.ARCHS`` (qwen3-1.7b so far)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCHS, ArchConfig, HybridConfig, MLAConfig, MoEConfig, Policy,
    SSMConfig, get, register,
)
from repro_torch.configs import qwen3_1_7b  # noqa: F401
