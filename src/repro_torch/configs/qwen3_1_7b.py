"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936; qk_norm, GQA, tied embeddings.  [hf:Qwen/Qwen3-1.7B]"""
from repro_torch.configs.base import ArchConfig, Policy, register

QWEN3_1_7B = register(ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    act="swiglu",
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    policy=Policy(param_dtype="float32", compute_dtype="bfloat16",
                  microbatches=4),
    source="hf:Qwen/Qwen3-1.7B",
))
