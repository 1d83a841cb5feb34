"""hubert-xlarge [audio] — 48L d_model=1280 16H d_ff=5120 vocab=504
(masked-prediction classes); encoder-only.  [arXiv:2106.07447; unverified]

The reference's config, field for field.  The port builds the encoder
family: it trains on ``backend="torch"``, and its forward and loss run K1
on the kernel backend (forward-only); there is no serving path, as the
model is encoder-only.  Its frame embeddings are stubbed as in the
reference.
"""
from repro_torch.configs.base import ArchConfig, Policy, register

HUBERT_XLARGE = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    act="gelu",
    norm="layernorm",
    pos_embed="sinusoidal",  # stand-in for HuBERT conv pos-embedding (stubbed)
    encoder_only=True,
    modality="audio_frames",
    policy=Policy(param_dtype="float32", compute_dtype="bfloat16",
                  microbatches=4),
    source="arXiv:2106.07447",
))
