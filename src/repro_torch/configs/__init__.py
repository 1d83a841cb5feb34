"""Ported architecture configs.  Importing this package registers every
ported arch in ``base.ARCHS`` (qwen3-1.7b, mamba2-370m, zamba2-2.7b and
mixtral-8x22b so far)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCHS, ArchConfig, HybridConfig, MLAConfig, MoEConfig, Policy,
    SSMConfig, get, register,
)
from repro_torch.configs import (  # noqa: F401
    mamba2_370m, mixtral_8x22b, qwen3_1_7b, zamba2_2_7b,
)
