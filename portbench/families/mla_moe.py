"""Work counts of DeepSeek-V3's family on one chip's share of its experts:
per layer a multi-head latent attention (MLA) over a latent cache and
either a dense SwiGLU MLP (the leading layers) or a mixture of experts
(a router over every expert, the shared expert, and the experts held
here).

``sizes`` gives ``work.sizes``'s counts.  The readers of this family's
metrics take its own counts besides: the latent cache a position, the
absorbed attention's FLOPs a key, the parameters a token multiplies, and
the held experts a decode step reads.  Each is what the computation
needs: a held expert that no live row chose need not be read."""
from typing import Dict, Sequence, Tuple

from portbench import hw, work


def mla_params(cfg: Dict) -> int:
    """wdq, wuq, wdkv, wkr, wuk, wuv, wo of one layer."""
    m, d, h = cfg["mla"], cfg["d_model"], cfg["n_heads"]
    qd = m["qk_nope_dim"] + m["qk_rope_dim"]
    return (d * m["q_lora_rank"] + m["q_lora_rank"] * h * qd
            + d * m["kv_lora_rank"] + d * m["qk_rope_dim"]
            + m["kv_lora_rank"] * h * (m["qk_nope_dim"] + m["v_head_dim"])
            + h * m["v_head_dim"] * d)


def expert_params(cfg: Dict) -> int:
    """One routed (or the shared) expert: gate, up and down."""
    return 3 * cfg["d_model"] * cfg["moe"]["d_ff_expert"]


def layers(cfg: Dict) -> Tuple[int, int]:
    """(dense layers, MoE layers)."""
    fd = min(cfg["moe"]["first_dense_layers"], cfg["n_layers"])
    return fd, cfg["n_layers"] - fd


def held(cfg: Dict) -> int:
    mo = cfg["moe"]
    return mo["held"] or mo["num_experts"]


def latent_bytes(cfg: Dict) -> int:
    """The latent cache (ckv and the shared rope key) of one position in
    one layer."""
    m = cfg["mla"]
    return (m["kv_lora_rank"] + m["qk_rope_dim"]) * work.KV_BYTES


def attn_flops_per_key(cfg: Dict) -> float:
    """The absorbed attention of one query against one cached position in
    one layer: scores over kv_lora + qk_rope dims and the latent values,
    for every head."""
    m = cfg["mla"]
    return 2.0 * cfg["n_heads"] * (2 * m["kv_lora_rank"] + m["qk_rope_dim"])


def per_token(cfg: Dict) -> float:
    """Parameters one token multiplies (no embedding, no head): MLA, the
    dense MLP or the shared expert and the router, and of the held
    experts the share its choices land on (top_k x held / num_experts of
    an expert, routing spread evenly)."""
    mo = cfg["moe"]
    fd, nm = layers(cfg)
    d = cfg["d_model"]
    routed = mo["top_k"] * held(cfg) / mo["num_experts"]
    return (fd * (mla_params(cfg) + 3 * d * cfg["d_ff"])
            + nm * (mla_params(cfg) + mo["n_shared"] * expert_params(cfg)
                    + d * mo["num_experts"] + routed * expert_params(cfg)))


def held_reached(cfg: Dict, m: int) -> float:
    """The held experts of one MoE layer that m rows reach, expected under
    routing spread evenly: held x (1 - (1 - top_k / num_experts)^m)."""
    mo = cfg["moe"]
    return held(cfg) * (1.0 - (1.0 - mo["top_k"] / mo["num_experts"]) ** m)


def _norms(cfg: Dict) -> int:
    m = cfg["mla"]
    return 2 * cfg["d_model"] + m["q_lora_rank"] + m["kv_lora_rank"]


def sizes(cfg: Dict) -> Dict[str, int]:
    mo, d, v = cfg["moe"], cfg["d_model"], cfg["vocab_size"]
    fd, nm = layers(cfg)
    weights = (fd * (mla_params(cfg) + 3 * d * cfg["d_ff"])
               + nm * (mla_params(cfg) + d * mo["num_experts"]
                       + (mo["n_shared"] + held(cfg)) * expert_params(cfg))
               + cfg["n_layers"] * _norms(cfg) + nm * mo["num_experts"]
               + v * d + d)
    return dict(per_token=int(per_token(cfg)), attn_layers=cfg["n_layers"],
                state_layers=0, state_bytes=0,
                embed_bytes=v * d * work.PARAM_BYTES,
                weight_bytes=weights * work.PARAM_BYTES)


def decode_work(cfg: Dict, positions: Sequence[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode step of the live sequences, the i-th
    writing its token at ``positions[i]`` after that many cached ones.
    Bytes: every weight once but the held experts, of which those the
    live rows reach (:func:`held_reached`); the embedding's rows; the
    latent cache read and the new positions written."""
    mo, d, v = cfg["moe"], cfg["d_model"], cfg["vocab_size"]
    m = len(positions)
    fd, nm = layers(cfg)
    keys = sum(positions) + m
    flops = 2.0 * (per_token(cfg) + d * v) * m \
        + cfg["n_layers"] * attn_flops_per_key(cfg) * keys
    unread = nm * (held(cfg) - held_reached(cfg, m)) * expert_params(cfg)
    nbytes = (sizes(cfg)["weight_bytes"] - unread * work.PARAM_BYTES
              + m * d * work.PARAM_BYTES
              + cfg["n_layers"] * latent_bytes(cfg) * keys)
    return flops, float(nbytes)


def decode_bound_s(cfg: Dict, positions: Sequence[int]) -> float:
    """The least time of one decode step on the card."""
    return work.bound_s(*decode_work(cfg, positions), hw.PEAK_FLOPS_BF16)[0]
