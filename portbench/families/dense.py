"""Work counts of the dense decoder family (Qwen3): per layer an
attention (q, k, v, o) and an MLP, two norms and, with qk-norm, the
per-head q and k norms."""
from typing import Dict

from portbench import work


def sizes(cfg: Dict) -> Dict[str, int]:
    d, v, n = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    layer = work.attn_params(cfg) + work.mlp_params(cfg)
    norms = 2 * d + (2 * work.head_dim(cfg) if cfg.get("qk_norm") else 0)
    head = 0 if cfg["tie_embeddings"] else v * d
    return dict(per_token=n * layer, attn_layers=n, state_layers=0,
                state_bytes=0, embed_bytes=v * d * work.PARAM_BYTES,
                weight_bytes=(n * (layer + norms) + head + d)
                * work.PARAM_BYTES)
