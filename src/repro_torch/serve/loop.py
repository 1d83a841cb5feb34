"""Batched serving loop: slot-based continuous batching.

Port of ``repro.serve.loop.Server``.  A fixed decode batch of ``slots``;
finished sequences free their slot and the next queued request is
prefilled into it.  Greedy sampling (argmax).  The decode step runs over
the whole slot batch and updates the KV cache (dense), the recurrent
state (ssm) or both (hybrid) in place.

Every dense projection and the SSM prefill scan go through ``backend``:
``"kernel"`` (default) launches the hand-written ``ame_gemm`` and
``ssd_scan`` on the card, ``"torch"`` runs their plain versions.  Unlike the reference, whose jitted steps always take the
default XLA backend, the backend reaches ``prefill`` and ``decode_step``.

Request timestamps come from a :class:`~repro_torch.serve.traffic.
SimClock` by default — admission advances it by the prefill roofline,
each decode iteration by the decode roofline of the
:class:`~repro_torch.serve.traffic.HostCostModel` — so
:meth:`Server.latency_summary` is deterministic; ``wall=True`` stamps
wall-clock time instead.  The PIM decode offload (``pim_offload=``) and
fault injection (``faults=``) wait for their slices.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.device import resolve_device
from repro_torch.models import model as lm
from repro_torch.models.layers import as_backend
from repro_torch.obs.metrics import Histogram
from repro_torch.serve.traffic import HostCostModel, SimClock, WallClock


class AdmissionError(RuntimeError):
    """Admission control shed this request (queue over ``max_queue``).
    Callers should back off and resubmit."""


# eq=False: the generated __eq__ would compare the ndarray prompt field
# and raise on membership tests; identity is the right request equality
@dataclasses.dataclass(eq=False)
class Request:
    uid: int
    prompt: np.ndarray              # (Tp,) int32
    max_new: int = 16
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_at: float = 0.0
    admitted_at: float = 0.0        # left the queue (prefill started)
    first_token_at: float = 0.0     # prefill produced the first token
    finished_at: float = 0.0


class Server:
    def __init__(self, cfg: ArchConfig, params, slots: int = 4,
                 cache_len: int = 128, eos_id: Optional[int] = None,
                 pim_offload=None, metrics=None, faults=None,
                 max_queue: Optional[int] = None, wall: bool = False,
                 cost: Optional[HostCostModel] = None,
                 backend="kernel", device=None):
        if pim_offload is not None:
            raise NotImplementedError(
                "pim_offload= waits for the offload slice (ROADMAP.md, "
                "queue 1, item 6)")
        if faults is not None:
            raise NotImplementedError(
                "faults= waits for the obs/faults slice (ROADMAP.md, "
                "queue 1, item 4)")
        self.cfg = cfg
        self.device = resolve_device(device)
        for leaf in (params["embed"]["table"], params["final_norm"]["scale"]):
            if leaf.device != self.device:
                raise ValueError(f"parameters live on {leaf.device}, the "
                                 f"server on {self.device}")
        # one compute-dtype copy of the weights, made once: bit-identical
        # to the per-call cast and without its bytes on every step
        self.params = lm.compute_params(params, cfg)
        self.backend = as_backend(backend)
        self.slots = slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.clock = WallClock() if wall else SimClock()
        self.cost = cost if cost is not None else HostCostModel(cfg)
        self.metrics = metrics
        self.active: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros((slots,), np.int32)
        self.caches = lm.make_caches(cfg, slots, cache_len, self.device)
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.max_queue = max_queue
        self.shed = 0                   # submissions refused at admission
        self.undrained = 0              # left pending by run_until_drained
        self._iter = 0                  # serving-iteration counter (1-based)
        self.prefills = 0               # prefill forwards run
        self.decode_steps = 0           # batched decode forwards run

    def _check_prompt(self, req: Request) -> None:
        """A prompt must leave at least one cache position for decode."""
        if len(req.prompt) >= self.cache_len:
            raise ValueError(
                f"prompt of request uid={req.uid} has {len(req.prompt)} "
                f"tokens but cache_len={self.cache_len} leaves no room "
                f"to decode — truncate the prompt or grow cache_len")

    def submit(self, req: Request):
        self._check_prompt(req)
        if self.max_queue is not None and \
                len(self.queue) >= max(1, self.max_queue):
            self.shed += 1
            if self.metrics is not None:
                self.metrics.counter(
                    "serve.shed", unit="requests",
                    help="submissions shed by admission control").inc()
            raise AdmissionError(
                f"queue at {len(self.queue)} >= cap {self.max_queue}; "
                f"shedding request uid={req.uid}")
        req.submitted_at = self.clock.now
        self.queue.append(req)

    def _admit(self):
        """Prefill queued requests into free slots (FIFO)."""
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                self._check_prompt(req)
                req.admitted_at = self.clock.now
                if self.metrics is not None:
                    self.metrics.histogram(
                        "serve.queue_delay_s", unit="s",
                        help="queue wait (submit -> prefill start)"
                    ).record(req.admitted_at - req.submitted_at)
                toks = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                       device=self.device)
                logits, fresh = lm.prefill(self.params, {"tokens": toks},
                                           self.cfg, cache_len=self.cache_len,
                                           backend=self.backend)
                self.prefills += 1
                _splice(self.caches, fresh, i)
                req.out_tokens.append(int(torch.argmax(logits[0])))
                # the prefill's argmax IS the first token: TTFT closes here
                self.clock.advance(self.cost.prefill_s(len(req.prompt)))
                req.first_token_at = self.clock.now
                if self.metrics is not None:
                    self.metrics.histogram(
                        "serve.ttft_s", unit="s",
                        help="time to first token (submit -> prefill "
                             "argmax)").record(
                        req.first_token_at - req.submitted_at)
                self.active[i] = req
                self.pos[i] = len(req.prompt)

    def _retire(self, i: int):
        req = self.active[i]
        req.done = True
        req.finished_at = self.clock.now
        self.completed.append(req)
        self.active[i] = None
        if self.metrics is not None:
            m = self.metrics
            m.counter("serve.requests", unit="requests",
                      help="requests completed").inc()
            m.counter("serve.tokens", unit="tokens",
                      help="tokens generated (first token included)").inc(
                len(req.out_tokens))
            if len(req.out_tokens) >= 2:      # TPOT needs a decode tail
                m.histogram(
                    "serve.tpot_s", unit="s",
                    help="time per output token after the first").record(
                    (req.finished_at - req.first_token_at)
                    / (len(req.out_tokens) - 1))

    def step(self):
        """One serving iteration: admit, batched decode, retire."""
        t0 = time.time() if self.metrics is not None else 0.0
        self._iter += 1
        self._admit()
        live = [i for i in range(self.slots) if self.active[i] is not None]
        if not live:
            return bool(self.queue)
        toks = np.zeros((self.slots, 1), np.int64)
        for i in live:
            toks[i, 0] = self.active[i].out_tokens[-1]
        logits, self.caches = lm.decode_step(
            self.params, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(self.pos.astype(np.int64)).to(self.device),
            self.caches, self.cfg, backend=self.backend)
        self.decode_steps += 1
        self.clock.advance(self.cost.decode_step_s(len(live)))
        nxt = torch.argmax(logits, -1).cpu().numpy()
        for i in live:
            req = self.active[i]
            req.out_tokens.append(int(nxt[i]))
            self.pos[i] += 1
            hit_eos = self.eos_id is not None and int(nxt[i]) == self.eos_id
            if (len(req.out_tokens) >= req.max_new or hit_eos
                    or int(self.pos[i]) >= self.cache_len - 1):
                self._retire(i)
        if self.metrics is not None:
            self.metrics.histogram(
                "serve.step_s", unit="s",
                help="serving-iteration wall time").record(time.time() - t0)
            self.metrics.gauge(
                "serve.live_slots", unit="slots",
                help="slots decoding in the last iteration").set(len(live))
        return True

    def run_until_drained(self, max_iters: int = 10_000,
                          on_undrained: str = "raise"):
        """Step until every request completes.  If ``max_iters`` runs out
        with requests still queued or active, ``on_undrained="raise"``
        (default) raises ``RuntimeError``; ``"warn"`` warns and returns
        the partial results."""
        if on_undrained not in ("raise", "warn"):
            raise ValueError(
                f"on_undrained must be 'raise' or 'warn', "
                f"got {on_undrained!r}")
        it = 0
        while (self.queue or any(a is not None for a in self.active)) \
                and it < max_iters:
            self.step()
            it += 1
        self.undrained = len(self.queue) \
            + sum(a is not None for a in self.active)
        if self.undrained:
            msg = (f"run_until_drained exhausted max_iters={max_iters} "
                   f"with {self.undrained} request(s) still "
                   f"queued/active ({len(self.completed)} completed)")
            if on_undrained == "raise":
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return self.completed

    def latency_summary(self) -> Dict:
        """TTFT/TPOT/queue-delay percentile summary over completed
        requests (virtual seconds by default).  Same keys as the
        reference's; ``failed``, ``deadline_misses`` and ``retries`` stay
        0 until fault injection and step deadlines are ported."""
        ttft = Histogram("serve.ttft_s", unit="s")
        tpot = Histogram("serve.tpot_s", unit="s")
        qdel = Histogram("serve.queue_delay_s", unit="s")
        for req in self.completed:
            if req.first_token_at:
                ttft.record(req.first_token_at - req.submitted_at)
                qdel.record(req.admitted_at - req.submitted_at)
                if req.finished_at and len(req.out_tokens) >= 2:
                    tpot.record((req.finished_at - req.first_token_at)
                                / (len(req.out_tokens) - 1))
        return {
            "requests": len(self.completed),
            "tokens": sum(len(r.out_tokens) for r in self.completed),
            "ttft_s": _pct_summary(ttft),
            "tpot_s": _pct_summary(tpot),
            "queue_delay_s": _pct_summary(qdel),
            "undrained": self.undrained,
            "failed": 0,
            "shed": self.shed,
            "deadline_misses": 0,
            "retries": 0,
        }


def _pct_summary(h: Histogram) -> Dict:
    """``Histogram.summary()`` plus the serving tail (p99.9)."""
    s = h.summary()
    s["p99.9"] = h.percentile(99.9)
    return s


def _splice(full, one, slot: int) -> None:
    """Copy the single-sequence prefill cache ``one`` into batch slot
    ``slot`` of the server cache ``full``, in place.  Cache leaves put
    batch at axis 1 (layer-stacked), the hybrid's mixed {groups,
    shared_kv, tail} cache included."""
    for k, v in full.items():
        if isinstance(v, dict):
            _splice(v, one[k], slot)
        else:
            v[:, slot].copy_(one[k][:, 0])
