"""zamba2-2.7b [hybrid] — 54 Mamba2 blocks, d_model=2560, shared attention
blocks (32H kv=32, d_ff=10240) every 6 blocks with per-application LoRA,
ssm_state=64.  [arXiv:2411.15242; hf]

d_inner = 2*2560 = 5120, head_dim 64 => 80 SSD heads of N = 64; the shared
blocks' attention has head_dim 2560/32 = 80.
"""
from repro_torch.configs.base import (
    ArchConfig, HybridConfig, Policy, SSMConfig, register,
)

ZAMBA2_2_7B = register(ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    act="gelu",
    rope_theta=1e4,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1),
    hybrid=HybridConfig(shared_every=6, n_shared_blocks=2, lora_rank=64),
    policy=Policy(param_dtype="float32", compute_dtype="bfloat16",
                  microbatches=8),
    source="arXiv:2411.15242",
))
