"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768; 8 experts top-2, SWA.  [arXiv:2401.04088; hf]

The reference's config, field for field: every layer's MLP is a bank of
8 experts (top-2, d_ff 16384), attention has a 4096-token sliding window.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, Policy, register

MIXTRAL_8X22B = register(ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    act="swiglu",
    rope_theta=1e6,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384,
                  capacity_factor=1.25, sharding="tp"),
    policy=Policy(param_dtype="bfloat16", compute_dtype="bfloat16",
                  fsdp=True, sp=True, microbatches=8, moment_dtype="bfloat16",
                  remat_policy="save_collectives",
                  grad_compression=True),
    source="arXiv:2401.04088",
))
