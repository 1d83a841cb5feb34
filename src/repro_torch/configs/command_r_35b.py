"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000; GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]

The reference's config, field for field.
"""
from repro_torch.configs.base import ArchConfig, Policy, register

COMMAND_R_35B = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    act="swiglu",
    rope_theta=4e6,
    attn_bias=False,
    tie_embeddings=True,
    policy=Policy(param_dtype="bfloat16", compute_dtype="bfloat16",
                  fsdp=True, sp=True, microbatches=8, grad_compression=True,
                  remat_policy="save_collectives"),
    source="hf:CohereForAI/c4ai-command-r-v01",
))
