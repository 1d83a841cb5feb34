"""Fault-tolerant training loop (port of ``repro.train.loop``).

* checkpoint/restart: periodic async checkpoints + resume autodiscovery;
  the data-pipeline state (a step counter) rides in checkpoint meta, so a
  restart resumes the exact batch stream.
* preemption: SIGTERM/SIGINT trigger a final blocking checkpoint before
  exit.
* straggler watchdog: per-step wall time EWMA; steps slower than
  ``straggler_factor`` x EWMA are counted and logged.
* metrics: JSONL per step, with the reference's keys.

:func:`make_step` is the plain single-device training step (the
reference's examples jit the same composition; the sharded, microbatched
step on a mesh is ``launch/steps.make_train_step``): ``loss_fn`` on
``backend="torch"``, its gradients by autograd, then one AdamW step in
place.
"""
from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import PipelineState
from repro_torch.launch.device import resolve_device
from repro_torch.models import model as lm
from repro_torch.optim import adamw


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    out_dir: str = "runs/default"
    keep_ckpts: int = 3
    straggler_factor: float = 3.0


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A pipeline batch as tensors on ``device``; integer arrays (tokens,
    targets) become int64 indices."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v), device=device)
        out[k] = t.long() if t.dtype == torch.int32 else t
    return out


def trainable(params) -> Dict:
    """``params`` with every leaf marked as requiring a gradient."""
    return adamw.tree_map(lambda p: p.requires_grad_(True), params)


def grad_tree(loss: torch.Tensor, params) -> Dict:
    """d loss / d every leaf of ``params``, in ``params``' structure (zeros
    for a leaf the loss does not reach, as ``jax.grad`` gives)."""
    leaves = [p for _, p in adamw.tree_leaves(params)]
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True))
    return adamw.tree_map(lambda _: next(grads), params)


def make_step(cfg: ArchConfig, opt: adamw.AdamWConfig,
              device=None) -> Callable:
    """``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients on ``backend="torch"`` (the
    kernel backend is forward-only), then AdamW in place.  Metrics are
    detached 0-d tensors: ``loss_fn``'s and ``lr``, ``grad_norm``."""
    device = resolve_device(device)

    def step_fn(params, opt_state, batch):
        loss, mets = lm.loss_fn(params, batch_to(batch, device), cfg)
        grads = grad_tree(loss, params)
        params, opt_state, om = adamw.apply(params, grads, opt_state, opt)
        return params, opt_state, {k: v.detach()
                                   for k, v in dict(mets, **om).items()}
    return step_fn


@torch.no_grad()
def _copy_into(dst, src) -> None:
    """Copy a restored tree of host tensors into the live tensors of the
    same structure, in place (devices, dtypes and ``requires_grad`` stay
    the live ones')."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    else:
        dst.copy_(src)


class TrainLoop:
    """Drives (params, opt_state) through ``step_fn`` with fault tolerance.

    ``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    is any step (:func:`make_step`); ``metrics["loss"]`` is a tensor on the
    device the step ran on, synchronised once per step.
    """

    def __init__(self, cfg: LoopConfig, step_fn: Callable, params, opt_state,
                 pipeline):
        self.cfg = cfg
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.pstate = PipelineState()
        self.out = Path(cfg.out_dir)
        self.out.mkdir(parents=True, exist_ok=True)
        self.ckpt = CheckpointManager(self.out / "ckpt", keep=cfg.keep_ckpts)
        self.metrics_file = self.out / "metrics.jsonl"
        self.step = 0
        self.straggler_steps = 0
        self._ewma: Optional[float] = None
        self._preempted = False

    # -- fault-tolerance hooks -------------------------------------------------

    def _install_signal_handlers(self) -> Dict:
        """Preemption handlers for SIGTERM and SIGINT; returns the ones
        they replace, which :meth:`run` puts back when it returns."""
        def handler(signum, frame):
            self._preempted = True
        return {sig: signal.signal(sig, handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    def try_resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        restored, meta = self.ckpt.restore((self.params, self.opt_state))
        _copy_into((self.params, self.opt_state), restored)
        self.step = meta["step"]
        self.pstate = PipelineState.from_dict(meta["pipeline"])
        return True

    def _save(self, blocking=False):
        self.ckpt.save(self.step, (self.params, self.opt_state),
                       meta={"pipeline": self.pstate.to_dict()},
                       blocking=blocking)

    # -- main ------------------------------------------------------------------

    def run(self) -> Dict:
        previous = self._install_signal_handlers()
        try:
            return self._run()
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)

    def _run(self) -> Dict:
        resumed = self.try_resume()
        last_metrics: Dict = {}
        with self.metrics_file.open("a") as log:
            while self.step < self.cfg.total_steps:
                if self._preempted:
                    self._save(blocking=True)
                    return {"status": "preempted", "step": self.step,
                            **last_metrics}
                batch = self.pipeline.batch(self.pstate.step)
                t0 = time.time()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                loss = metrics["loss"]
                if loss.is_cuda:
                    torch.cuda.synchronize(loss.device)
                dt = time.time() - t0
                self.pstate.step += 1
                self.step += 1

                # straggler watchdog
                if self._ewma is None:
                    self._ewma = dt
                else:
                    if dt > self.cfg.straggler_factor * self._ewma:
                        self.straggler_steps += 1
                    self._ewma = 0.9 * self._ewma + 0.1 * dt

                last_metrics = {k: float(v) for k, v in metrics.items()}
                if self.step % self.cfg.log_every == 0 or \
                        self.step == self.cfg.total_steps:
                    rec = dict(step=self.step, sec_per_step=round(dt, 4),
                               stragglers=self.straggler_steps,
                               resumed=resumed, **last_metrics)
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                if self.step % self.cfg.ckpt_every == 0:
                    self._save()
            self._save(blocking=True)
        return {"status": "done", "step": self.step,
                "stragglers": self.straggler_steps, **last_metrics}
