"""Architecture configuration system (port of ``repro.configs.base``).

The dataclasses keep the reference's fields and defaults, so a config of
either package can be compared field by field; only the dtype accessors
differ, returning ``torch`` dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0               # shared (always-on) experts
    first_dense_layers: int = 0     # leading dense layers (deepseek: 3)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    sharding: str = "ep"            # "ep": experts on model axis; "tp": inside-expert


@dataclasses.dataclass(frozen=True)
class MLAConfig:                    # DeepSeek-V3 multi-head latent attention
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:                    # Mamba2 / SSD
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64              # P
    n_groups: int = 1               # B/C groups (GQA-like)
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class HybridConfig:                 # Zamba2: shared attention block
    shared_every: int = 6           # apply the shared block every N ssm blocks
    n_shared_blocks: int = 2        # distinct shared blocks, used round-robin
    lora_rank: int = 64             # per-application LoRA on the shared block


@dataclasses.dataclass(frozen=True)
class Policy:
    """Numerics + distribution policy (per arch, overridable per run).

    The distribution fields are kept for field-by-field parity with the
    reference; the port runs on one device and reads only the dtypes."""

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    fsdp: bool = False
    microbatches: int = 1
    moment_dtype: str = "float32"
    factored_v: bool = False
    sp: bool = False
    sp_rs: bool = False
    remat_policy: str = "full"
    tp_mode: str = "allreduce"
    grad_compression: bool = False


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense|moe|vlm|hybrid|ssm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # explicit (gemma: 256); default dm/heads
    act: str = "swiglu"             # swiglu|geglu|gelu
    norm: str = "rmsnorm"           # rmsnorm|layernorm
    pos_embed: str = "rope"         # rope|learned
    qk_norm: bool = False
    rope_theta: float = 1e6
    attn_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    sliding_window: int = 0         # >0: SWA (mixtral)
    encoder_only: bool = False      # hubert
    modality: str = "text"          # text|vision_text|audio_frames
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    mtp: bool = False               # multi-token-prediction aux head
    policy: Policy = dataclasses.field(default_factory=Policy)
    source: str = ""                # provenance note

    # -- derived -----------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (as the reference)."""
        return -(-self.vocab_size // 256) * 256

    def compute_dtype_(self) -> torch.dtype:
        return torch.bfloat16 if self.policy.compute_dtype == "bfloat16" \
            else torch.float32

    def param_dtype_(self) -> torch.dtype:
        return torch.bfloat16 if self.policy.param_dtype == "bfloat16" \
            else torch.float32

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def with_policy(self, **kw) -> "ArchConfig":
        return self.replace(policy=dataclasses.replace(self.policy, **kw))

    # -- smoke-test variant --------------------------------------------------

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny variant for CPU tests."""
        kw = dict(
            n_layers=min(self.n_layers, 4 if self.hybrid is None else 7),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=256,
            vocab_size=512,
            head_dim=32 if self.head_dim else None,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, d_ff_expert=64,
                n_shared=min(self.moe.n_shared, 1),
                first_dense_layers=min(self.moe.first_dense_layers, 1))
        if self.mla:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                  qk_nope_dim=16, qk_rope_dim=16,
                                  v_head_dim=32)
            kw["head_dim"] = None
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                            chunk=32)
        if self.hybrid:
            kw["hybrid"] = dataclasses.replace(self.hybrid, shared_every=3,
                                               lora_rank=8)
        kw["policy"] = dataclasses.replace(
            self.policy, param_dtype="float32", compute_dtype="float32",
            microbatches=1, fsdp=False)
        return self.replace(**kw)


#: registry, populated by the per-arch modules
ARCHS: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch registration)
    return ARCHS[name]
