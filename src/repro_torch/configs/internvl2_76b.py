"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; InternViT + LLM backbone.  [arXiv:2404.16821; unverified]

The reference's config (the language backbone), field for field.  The
port builds the VLM family: it trains on ``backend="torch"``, and its
forward and loss run K1 on the kernel backend (forward-only), as do its
prefill and decode when it serves.  Its patch embeddings are stubbed as
in the reference.
"""
from repro_torch.configs.base import ArchConfig, Policy, register

INTERNVL2_76B = register(ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    act="swiglu",
    rope_theta=5e5,
    modality="vision_text",
    policy=Policy(param_dtype="bfloat16", compute_dtype="bfloat16",
                  fsdp=True, sp=True, microbatches=8, moment_dtype="bfloat16",
                  remat_policy="save_collectives",
                  grad_compression=True),
    source="arXiv:2404.16821",
))
