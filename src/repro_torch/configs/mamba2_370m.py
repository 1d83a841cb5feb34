"""mamba2-370m [ssm] — 48L d_model=1024, attention-free, ssm_state=128,
SSD (state-space duality).  [arXiv:2405.21060; unverified]

d_inner = 2*1024 = 2048, head_dim 64 => 32 SSD heads.  No attention =>
no KV cache; decode advances the recurrent state (O(1) per token).
"""
from repro_torch.configs.base import ArchConfig, Policy, SSMConfig, register

MAMBA2_370M = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    tie_embeddings=True,
    policy=Policy(param_dtype="float32", compute_dtype="bfloat16",
                  microbatches=4),
    source="arXiv:2405.21060",
))
