"""Reference of the dense decoder (Qwen3): embedding, then per layer a
pre-norm GQA attention with qk-norm and RoPE and a pre-norm SwiGLU MLP,
each added to the residual, then the final RMSNorm and the head (tied to
the embedding where the configuration says so).

Departure from the published model: none in the mathematics; the port
pads the vocabulary, and the reference reads only the real rows.
"""
from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import plain

#: fields of the port's configuration that this reference does not model,
#: with the values they must keep
PLAIN = dict(norm="rmsnorm", pos_embed="rope", attn_bias=False,
             sliding_window=0, encoder_only=False, modality="text",
             moe=None, mla=None, ssm=None, hybrid=None, mtp=False)


@torch.no_grad()
def forward(w: Dict, cfg: Dict, tokens: torch.Tensor, rows: slice,
            prec: str = "f32") -> torch.Tensor:
    """Logits (float32, real vocabulary) at positions ``rows`` of the
    causal forward over ``tokens`` (T,)."""
    plain.exact()
    st = w["stack"]["dense_stack"]
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    h = w["embed"]["table"][tokens].float()
    for i in range(cfg["n_layers"]):
        h = h + plain.block_delta(plain.layer(st, i), h, cfg, pos, prec)
    h = plain.rmsnorm(h[rows], w["final_norm"]["scale"], cfg["norm_eps"])
    return plain.head(w, h, cfg, prec)
