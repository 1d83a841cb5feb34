"""The work a step or a kernel launch needs, counted from shapes.

This is the yardstick that the roofline and ``mfu`` metrics divide by;
the program never supplies it.  Each count is of what the computation
needs, not of what the program does: every weight read once, every
cached key and value read once, every output written once, and the
FLOPs of the products (``2 * N_active * tokens`` as in
``repro_torch.launch.modelflops``, plus attention, which that count
leaves out).  The K1 and K4 bounds are frozen copies of
``chip_smoke.py``'s.

``cfg`` is a configuration file of ``configs/`` as a dict; the counts of
its family are in ``families/<family>.py``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, Sequence, Tuple

from portbench import hw

PKG = Path(__file__).resolve().parent

#: bytes of a served parameter, of a cached key or value
PARAM_BYTES = 2
KV_BYTES = 2


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def attn_params(cfg: Dict) -> int:
    """q, k, v and o of one attention layer."""
    d, h, hkv, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        head_dim(cfg)
    return d * h * hd + 2 * d * hkv * hd + h * hd * d


def mlp_params(cfg: Dict) -> int:
    gated = cfg["act"] in ("swiglu", "geglu")
    return (3 if gated else 2) * cfg["d_model"] * cfg["d_ff"]


def sizes(cfg: Dict) -> Dict[str, int]:
    """The counts of ``families/<family>.py``: ``per_token``, the
    parameters every token multiplies (no embedding, no head);
    ``weight_bytes``, every distinct parameter once, the embedding table
    apart (``embed_bytes``); ``attn_layers``, the attention applications
    a token passes; ``state_layers`` and ``state_bytes``, the layers that
    keep a recurrent state and one sequence's state in one of them."""
    path = PKG / "families" / f"{cfg['family']}.py"
    if not path.is_file():
        raise ValueError(f"no work count for the {cfg['family']!r} family "
                         f"({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        f"portbench.families.{cfg['family']}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.sizes(cfg)


def _kv_per_token(cfg: Dict) -> int:
    return 2 * cfg["n_kv_heads"] * head_dim(cfg) * KV_BYTES


def _weights_read(cfg: Dict, z: Dict[str, int], rows: int) -> int:
    """A tied table is read whole by the head; an untied one only at the
    ``rows`` tokens it embeds."""
    embed = z["embed_bytes"] if cfg["tie_embeddings"] \
        else rows * cfg["d_model"] * PARAM_BYTES
    return z["weight_bytes"] + embed


def prefill_work(cfg: Dict, t: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of a prefill of ``t`` tokens that returns the last
    position's logits and writes the prompt's KV and final states."""
    z = sizes(cfg)
    flops = 2.0 * z["per_token"] * t + 2.0 * cfg["d_model"] \
        * cfg["vocab_size"] + z["attn_layers"] * cfg["n_heads"] * 2.0 \
        * head_dim(cfg) * t * (t + 1)
    nbytes = _weights_read(cfg, z, t) + z["attn_layers"] * t \
        * _kv_per_token(cfg) + z["state_layers"] * z["state_bytes"]
    return flops, float(nbytes)


def decode_work(cfg: Dict, positions: Sequence[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode step of the live sequences, the i-th
    writing its token at ``positions[i]`` after that many cached ones."""
    z = sizes(cfg)
    m = len(positions)
    kv = _kv_per_token(cfg)
    cached = sum(positions)
    flops = 2.0 * (z["per_token"] + cfg["d_model"] * cfg["vocab_size"]) * m \
        + z["attn_layers"] * cfg["n_heads"] * 4.0 * head_dim(cfg) \
        * (cached + m)
    nbytes = _weights_read(cfg, z, m) + z["attn_layers"] * kv * (cached + m) \
        + 2 * m * z["state_layers"] * z["state_bytes"]
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float, peak: float = hw.PEAK_FLOPS_BF16
            ) -> Tuple[float, str]:
    """The least time the chip could take, and which bound sets it."""
    t_ops, t_bytes = flops / peak, nbytes / hw.HBM_BW
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "flops"


def k1_bound_s(m: int, k: int, n: int, in_bytes: int, out_bytes: int
               ) -> float:
    """One ``ame_gemm`` launch: 2mkn FLOPs at the peak of its operands'
    width, or A and B read once and C written once."""
    return bound_s(2.0 * m * k * n,
                   float((m * k + k * n) * in_bytes + m * n * out_bytes),
                   hw.peak_flops(in_bytes))[0]


def k4_bound_s(bh: int, t: int, p: int, n: int, chunk: int, x_bytes: int,
               bc_bytes: int, bc_rows: int) -> float:
    """One ``ssd_scan`` launch (``chip_smoke.k4_bound``).  Bytes: x,
    log_a, b, c read once and y written once, b and c holding ``bc_rows``
    distinct rows.  Operations: per row and chunk of l steps the cheaper
    of two exact forms, the sequential recurrence (5 N P f32 FLOPs a step
    on the CUDA cores) or the chunked form on the tensor cores, each
    f32-accurate product at three bf16 passes (one for C B^T when b and c
    are bf16)."""
    lc = min(chunk, t)
    nbytes = bh * t * (2 * p * x_bytes + 4) + bc_rows * t * 2 * n * bc_bytes
    cb_passes = 1 if bc_bytes == 2 else 3
    t_ops = 0.0
    for t0 in range(0, t, lc):
        ln = min(lc, t - t0)
        recurrence = 5 * ln * n * p / hw.PEAK_FLOPS_F32
        chunked = (cb_passes * ln * (ln + 1) * n
                   + 3 * (ln * (ln + 1) * p + 4 * ln * n * p)) \
            / hw.PEAK_FLOPS_BF16
        t_ops += bh * min(recurrence, chunked)
    return max(nbytes / hw.HBM_BW, t_ops)
