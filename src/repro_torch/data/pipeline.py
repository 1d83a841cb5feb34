"""Deterministic, sharded, checkpointable data pipeline (port of
``repro.data.pipeline``: the same numpy code, so its batches are ``==``
the reference's).

Synthetic but *learnable* streams (a fixed seeded bigram chain for text, a
fixed frame->cluster mapping for audio), so end-to-end training examples
show real loss decrease.  Determinism contract: ``batch(step)`` depends only
on (seed, step, shard), so restart-from-checkpoint resumes the exact
stream — the pipeline state IS the step counter.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))


class SyntheticLM:
    """Seeded bigram-chain token stream (model can learn the chain)."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec, seed: int = 0,
                 shard: int = 0, num_shards: int = 1,
                 batch_override: Optional[int] = None,
                 seq_override: Optional[int] = None,
                 active_vocab: Optional[int] = None):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.batch_size = batch_override or shape.global_batch
        self.seq = seq_override or shape.seq_len
        v = min(cfg.vocab_size, active_vocab or 4096)
        self.active_vocab = v
        rng = np.random.default_rng(seed)  # FIXED chain, shared by all shards
        logits = rng.standard_normal((v, v)) * 2.0
        self.probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        self.cum = np.cumsum(self.probs, axis=-1)

    def _sample_chain(self, rng: np.random.Generator, b: int, t: int):
        toks = np.empty((b, t + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.active_vocab, b)
        u = rng.random((b, t))
        for i in range(t):
            toks[:, i + 1] = (self.cum[toks[:, i]] > u[:, i:i + 1]).argmax(-1)
        return toks

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 97 + self.shard)
        b = self.batch_size // self.num_shards
        cfg = self.cfg
        if cfg.modality == "audio_frames":
            targets = rng.integers(0, cfg.vocab_size, (b, self.seq),
                                   dtype=np.int32)
            proj = np.random.default_rng(self.seed).standard_normal(
                (cfg.vocab_size, cfg.d_model)).astype(np.float32)
            frames = proj[targets] * 0.1 \
                + rng.standard_normal((b, self.seq, cfg.d_model)) * 0.01
            mask = rng.random((b, self.seq)) < 0.25
            return {"frames": frames.astype(np.float32), "mask": mask,
                    "targets": targets}
        toks = self._sample_chain(rng, b, self.seq)
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "targets": toks[:, 1:].astype(np.int32),
               "loss_mask": np.ones((b, self.seq), np.float32)}
        if cfg.modality == "vision_text":
            npatch = max(self.seq // 4, 16)
            tt = self.seq - npatch
            out = {"tokens": toks[:, :tt].astype(np.int32),
                   "targets": toks[:, 1:tt + 1].astype(np.int32),
                   "loss_mask": np.ones((b, tt), np.float32),
                   "vision_embeds": rng.standard_normal(
                       (b, npatch, cfg.d_model)).astype(np.float32) * 0.1}
        return out

    def iterate(self, state: PipelineState) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch(state.step)
            state.step += 1
