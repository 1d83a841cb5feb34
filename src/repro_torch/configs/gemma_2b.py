"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000; GeGLU, head_dim=256.  [arXiv:2403.08295; hf]

The reference's config, field for field.
"""
from repro_torch.configs.base import ArchConfig, Policy, register

GEMMA_2B = register(ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=256000,
    head_dim=256,
    act="geglu",
    rope_theta=1e4,
    tie_embeddings=True,
    policy=Policy(param_dtype="float32", compute_dtype="bfloat16",
                  microbatches=4),
    source="arXiv:2403.08295",
))
