"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064; RoPE SwiGLU GQA.  [arXiv:2412.08905; hf]

The reference's config, field for field.
"""
from repro_torch.configs.base import ArchConfig, Policy, register

PHI4_MINI_3_8B = register(ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    act="swiglu",
    rope_theta=1e4,
    tie_embeddings=True,
    policy=Policy(param_dtype="float32", compute_dtype="bfloat16",
                  microbatches=4),
    source="arXiv:2412.08905",
))
