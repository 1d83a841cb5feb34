"""Architecture configs (port of ``repro.configs``).  Importing this
package registers every arch in ``base.ARCHS``."""
from repro_torch.configs.base import (  # noqa: F401
    ARCHS, SHAPES, ArchConfig, HybridConfig, MLAConfig, MoEConfig, Policy,
    SSMConfig, ShapeSpec, all_names, applicable, get, input_specs, register,
)
from repro_torch.configs import (  # noqa: F401
    command_r_35b,
    deepseek_v3_671b,
    gemma_2b,
    hubert_xlarge,
    internvl2_76b,
    mamba2_370m,
    mixtral_8x22b,
    phi4_mini_3_8b,
    qwen3_1_7b,
    zamba2_2_7b,
)
