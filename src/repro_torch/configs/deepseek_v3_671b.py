"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280; MLA, 1 shared + 256 routed top-8, MTP.  [arXiv:2412.19437; hf]

The reference's config, field for field: 3 dense layers (d_ff 18432)
then MoE layers of 256 routed experts (top-8, d_ff 2048) and one shared
expert, MLA attention, and an MTP head (built, used by no serve path).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, Policy, register

DEEPSEEK_V3_671B = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    act="swiglu",
    rope_theta=1e4,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  first_dense_layers=3, capacity_factor=1.25,
                  sharding="ep"),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                  qk_rope_dim=64, v_head_dim=128),
    mtp=True,
    policy=Policy(param_dtype="bfloat16", compute_dtype="bfloat16",
                  fsdp=True, sp=True, microbatches=4, moment_dtype="int8",
                  remat_policy="save_collectives",
                  factored_v=True, grad_compression=True),
    source="arXiv:2412.19437",
))
