"""Architecture configuration system (port of ``repro.configs.base``).

The dataclasses keep the reference's fields and defaults, so a config of
either package can be compared field by field; only the dtype accessors
differ, returning ``torch`` dtypes.  :func:`input_specs` stands each model
input in as a tensor on the meta device (shape and dtype, no storage),
where the reference uses ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
    # DeepSeek-V3's routing (``noaux_tc``), taken when ``scoring`` is
    # "sigmoid": sigmoid scores in f32, a correction bias that picks the
    # experts but not their weights, the ``topk_group`` best of ``n_group``
    # groups, the top-k weights normalised and times ``routed_scale``, and
    # no token dropped (``capacity_factor`` unused).  The defaults are the
    # Switch routing above, the reference's.
    scoring: str = "softmax"        # softmax|sigmoid
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0
    # the routed experts held here, ``held`` of them from ``held_from``
    # (expert parallelism's share; 0: all); the router scores all
    # ``num_experts`` and the layer adds its own experts' part alone
    held: int = 0
    held_from: int = 0


@dataclasses.dataclass(frozen=True)
class MLAConfig:                    # DeepSeek-V3 multi-head latent attention
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # YaRN on the rope dims (DeepSeek-V3: factor 40 over 4,096 original
    # positions); factor 1 is plain RoPE.  The softmax scale takes m^2,
    # m = 0.1 * mscale_all_dim * ln(factor) + 1.  The published config's
    # ``mscale`` equals ``mscale_all_dim``, so cos and sin keep a factor
    # of 1, and the port has no field for it
    yarn_factor: float = 1.0
    yarn_original_len: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale_all_dim: float = 1.0


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


#: tp_modes whose block outputs stay feature-sharded on 'model' (no
#: partial sum crosses it): the paper's dataflow and its PIM flavor
OUTPUT_SHARDED_TP_MODES = ("allgather", "ame_pim")


@dataclasses.dataclass(frozen=True)
class Policy:
    """Numerics + distribution policy (per arch, overridable per run).

    ``fsdp``, ``microbatches``, ``sp``, ``sp_rs`` and ``tp_mode`` drive the
    sharded steps (``launch/steps``, ``sharding/rules``); as in the
    reference, no step reads ``grad_compression``."""

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

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def quadratic_attention(self) -> bool:
        """True if the arch has no sub-quadratic path for 500k context."""
        if self.family in ("ssm",):
            return False
        if self.hybrid is not None:
            return False            # mamba backbone + sparse shared attn
        return self.sliding_window == 0

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


# ---------------------------------------------------------------------------
# Input shapes (assigned grid)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train|prefill|decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether this (arch x shape) cell runs, and why not if skipped."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and cfg.quadratic_attention:
        return False, "full quadratic attention at 500k context"
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                reduced: bool = False) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins (shape and dtype, no storage) for every model
    input of this cell.

    Modality frontends are stubs, as in the reference: vision supplies
    precomputed patch embeddings, audio precomputed frame embeddings.
    """
    b, t = shape.global_batch, shape.seq_len
    if reduced:
        b, t = min(b, 2), min(t, 64)
    i32, f = torch.int32, cfg.compute_dtype_()
    d = cfg.d_model

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "train":
        if cfg.modality == "audio_frames":
            return {"frames": spec((b, t, d), f),
                    "mask": spec((b, t), torch.bool),
                    "targets": spec((b, t), i32)}
        tt = t
        out = {}
        if cfg.modality == "vision_text":
            npatch = max(t // 4, 16)
            tt = t - npatch
            out["vision_embeds"] = spec((b, npatch, d), f)
        out.update(tokens=spec((b, tt), i32), targets=spec((b, tt), i32),
                   loss_mask=spec((b, tt), f))
        return out
    if shape.kind == "prefill":
        if cfg.modality == "audio_frames":
            return {"frames": spec((b, t, d), f)}
        if cfg.modality == "vision_text":
            npatch = max(t // 4, 16)
            return {"tokens": spec((b, t - npatch), i32),
                    "vision_embeds": spec((b, npatch, d), f)}
        return {"tokens": spec((b, t), i32)}
    # decode: one new token against a cache of length t
    return {"tokens": spec((b, 1), i32), "positions": spec((b,), i32)}


#: registry, populated by the per-arch modules
ARCHS: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch registration)
    return ARCHS[name]


def all_names():
    import repro_torch.configs  # noqa: F401
    return sorted(ARCHS)
