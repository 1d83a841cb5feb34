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

Pass ``pim_offload=DecodeOffload(cfg, ...)`` to mirror every decode
step's matmuls onto a resident-weight PIM runtime (balanced placement,
weights uploaded once): the sidecar accumulates a per-step PIM-vs-host
roofline without touching the serving numerics — see
:mod:`repro_torch.serve.offload`.  With ``kv_offload=True`` the sidecar
also keeps each live request's KV resident: admission ships the prompt's
KV in, retirement and knock-outs release it.

Graceful degradation (:mod:`repro_torch.faults`): ``Server(faults=...)``
accepts a :class:`~repro_torch.faults.plan.FaultPlan` (or DSL string)
and consumes its :class:`~repro_torch.faults.plan.ServeFault` entries —
the request decoding in the named slot at the named iteration is knocked
out and requeued with per-request exponential backoff
(``retry_backoff_steps`` doubling per retry, capped), failing permanently
after ``max_retries``; a knocked-out request restarts from its prompt.
``step_deadline_s`` counts over-deadline serving iterations;
``max_queue`` turns :meth:`Server.submit` into admission control that
sheds load (:class:`AdmissionError`) when the queue exceeds the cap
*scaled by surviving PIM capacity*.

Request timestamps come from a :class:`~repro_torch.serve.traffic.
SimClock` by default — admission advances it by the prefill roofline,
each decode iteration by the offload's ``StepRecord.pim_s`` (or the
decode roofline of the :class:`~repro_torch.serve.traffic.HostCostModel`
without a sidecar) — so :meth:`Server.latency_summary` is deterministic;
``wall=True`` stamps wall-clock time instead, and an explicit ``clock=``
shares one clock across servers.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.faults.plan import as_plan
from repro_torch.launch.device import resolve_device
from repro_torch.models import model as lm
from repro_torch.models.layers import as_backend
from repro_torch.obs.metrics import Histogram
from repro_torch.serve.offload import DecodeOffload
from repro_torch.serve.traffic import HostCostModel, SimClock, WallClock


class AdmissionError(RuntimeError):
    """Admission control shed this request (queue over the surviving-
    capacity-scaled cap).  Callers should back off and resubmit."""


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
    retries: int = 0                # fault knock-outs survived so far
    not_before: int = 0             # earliest serving iteration to re-admit


class Server:
    def __init__(self, cfg: ArchConfig, params, slots: int = 4,
                 cache_len: int = 128, eos_id: Optional[int] = None,
                 pim_offload: Optional[DecodeOffload] = None,
                 metrics=None, faults=None,
                 step_deadline_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 retry_backoff_steps: int = 2,
                 retry_backoff_cap: int = 16,
                 max_retries: int = 2,
                 wall: bool = False, clock=None,
                 cost: Optional[HostCostModel] = None,
                 backend="kernel", device=None):
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
        self.pim_offload = pim_offload
        # virtual-time stamping by default; wall=True stamps wall time,
        # and an explicit clock= shares one SimClock across servers
        self.clock = clock if clock is not None \
            else (WallClock() if wall else SimClock())
        self.cost = cost if cost is not None else HostCostModel(cfg)
        self.metrics = metrics
        self.active: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros((slots,), np.int32)
        self.caches = lm.make_caches(cfg, slots, cache_len, self.device)
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        # -- graceful degradation state (all zero / empty without faults)
        self.step_deadline_s = step_deadline_s
        self.max_queue = max_queue
        self.retry_backoff_steps = retry_backoff_steps
        self.retry_backoff_cap = retry_backoff_cap
        self.max_retries = max_retries
        self.failed_requests: List[Request] = []
        self.shed = 0                   # submissions refused at admission
        self.deadline_misses = 0        # serving iterations over deadline
        self.retries_total = 0          # fault knock-outs requeued
        self.undrained = 0              # left pending by run_until_drained
        self._iter = 0                  # serving-iteration counter (1-based)
        self.prefills = 0               # prefill forwards run
        self.decode_steps = 0           # batched decode forwards run
        self._serve_faults: List = []
        if faults is not None:
            self._serve_faults = sorted(
                as_plan(faults).serve_faults,
                key=lambda f: (f.at_iter, f.slot))

    def _check_prompt(self, req: Request) -> None:
        """A prompt must leave at least one cache position for decode."""
        if len(req.prompt) >= self.cache_len:
            raise ValueError(
                f"prompt of request uid={req.uid} has {len(req.prompt)} "
                f"tokens but cache_len={self.cache_len} leaves no room "
                f"to decode — truncate the prompt or grow cache_len")

    @property
    def _kv(self):
        """The offload sidecar's KV manager when KV-resident attention
        is on (``DecodeOffload(kv_offload=True)``), else None — every
        hook below is a no-op without it."""
        off = self.pim_offload
        return off.kv if off is not None else None

    @property
    def surviving_fraction(self) -> float:
        """Fraction of PIM decode capacity still alive (1.0 without an
        offload sidecar or without faults) — scales the admission cap."""
        off = self.pim_offload
        return off.surviving_fraction if off is not None else 1.0

    def submit(self, req: Request):
        self._check_prompt(req)
        if self.max_queue is not None:
            cap = max(1, int(self.max_queue * self.surviving_fraction))
            if len(self.queue) >= cap:
                self.shed += 1
                if self.metrics is not None:
                    self.metrics.counter(
                        "serve.shed", unit="requests",
                        help="submissions shed by admission control").inc()
                raise AdmissionError(
                    f"queue at {len(self.queue)} >= cap {cap} "
                    f"(max_queue={self.max_queue}, surviving="
                    f"{self.surviving_fraction:.2f}); shedding "
                    f"request uid={req.uid}")
        req.submitted_at = self.clock.now
        self.queue.append(req)

    def _apply_serve_faults(self):
        """Fire ServeFaults due this iteration: knock out the slot's
        request and requeue it with exponential backoff (or fail it
        permanently past max_retries)."""
        due = [f for f in self._serve_faults if f.at_iter == self._iter]
        if not due:
            return
        self._serve_faults = [f for f in self._serve_faults
                              if f.at_iter != self._iter]
        for f in due:
            if f.slot >= self.slots or self.active[f.slot] is None:
                continue
            req = self.active[f.slot]
            self.active[f.slot] = None
            # the slot's cache is considered poisoned: restart the
            # request from its prompt (prefill re-runs on re-admission);
            # its PIM-resident KV drops with it
            if self._kv is not None:
                self.pim_offload.kv_release(req.uid)
            req.out_tokens = []
            req.first_token_at = 0.0
            req.retries += 1
            if req.retries > self.max_retries:
                req.done = True
                req.finished_at = self.clock.now
                self.failed_requests.append(req)
                if self.metrics is not None:
                    self.metrics.counter(
                        "serve.failed", unit="requests",
                        help="requests failed past max_retries").inc()
                continue
            backoff = min(
                self.retry_backoff_steps * 2 ** (req.retries - 1),
                self.retry_backoff_cap)
            req.not_before = self._iter + backoff
            self.queue.append(req)
            self.retries_total += 1
            if self.metrics is not None:
                self.metrics.counter(
                    "serve.retries", unit="requests",
                    help="fault knock-outs requeued with backoff").inc()

    def _admit(self):
        """Prefill queued requests into free slots (FIFO among requests
        whose retry backoff has elapsed)."""
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                idx = next((j for j, r in enumerate(self.queue)
                            if r.not_before <= self._iter), None)
                if idx is None:
                    return           # everything queued is backing off
                req = self.queue.pop(idx)
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
                # the prefill produced the prompt's KV: ship it onto the
                # sidecar's PIM pages once, decode grows it in place
                if self._kv is not None:
                    self.pim_offload.kv_prefill(req.uid, len(req.prompt))

    def _retire(self, i: int):
        req = self.active[i]
        req.done = True
        req.finished_at = self.clock.now
        self.completed.append(req)
        self.active[i] = None
        if self._kv is not None:
            self.pim_offload.kv_release(req.uid)
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
        """One serving iteration: fire serve faults, admit, batched
        decode, retire; count the iteration against the step deadline."""
        track_wall = self.metrics is not None \
            or self.step_deadline_s is not None
        t0 = time.time() if track_wall else 0.0
        self._iter += 1
        self._apply_serve_faults()
        self._admit()
        live = [i for i in range(self.slots) if self.active[i] is not None]
        if not live:
            # backing-off requests still count as pending work
            return bool(self.queue)
        toks = np.zeros((self.slots, 1), np.int64)
        for i in live:
            toks[i, 0] = self.active[i].out_tokens[-1]
        logits, self.caches = lm.decode_step(
            self.params, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(self.pos.astype(np.int64)).to(self.device),
            self.caches, self.cfg, backend=self.backend)
        self.decode_steps += 1
        rec = None
        if self.pim_offload is not None:
            rec = self.pim_offload.step(
                len(live),
                request_ids=[self.active[i].uid for i in live])
        # the decode iteration's virtual duration: the PIM step's clocked
        # makespan when a sidecar ran it, else the host decode roofline
        self.clock.advance(rec.pim_s if rec is not None
                           else self.cost.decode_step_s(len(live)))
        nxt = torch.argmax(logits, -1).cpu().numpy()
        for i in live:
            req = self.active[i]
            req.out_tokens.append(int(nxt[i]))
            self.pos[i] += 1
            hit_eos = self.eos_id is not None and int(nxt[i]) == self.eos_id
            if (len(req.out_tokens) >= req.max_new or hit_eos
                    or int(self.pos[i]) >= self.cache_len - 1):
                self._retire(i)
        if track_wall:
            wall = time.time() - t0
            if self.step_deadline_s is not None \
                    and wall > self.step_deadline_s:
                self.deadline_misses += 1
                if self.metrics is not None:
                    self.metrics.counter(
                        "serve.deadline_misses", unit="steps",
                        help="serving iterations over step_deadline_s"
                    ).inc()
            if self.metrics is not None:
                self.metrics.histogram(
                    "serve.step_s", unit="s",
                    help="serving-iteration wall time").record(wall)
                self.metrics.gauge(
                    "serve.live_slots", unit="slots",
                    help="slots decoding in the last iteration").set(
                    len(live))
        return True

    def run_until_drained(self, max_iters: int = 10_000,
                          on_undrained: str = "raise"):
        """Step until every request completes (or fails permanently).  If ``max_iters`` runs out
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
        requests (virtual seconds by default), with the degradation
        accounting (all zero on a fault-free run); the reference's keys."""
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
            "failed": len(self.failed_requests),
            "shed": self.shed,
            "deadline_misses": self.deadline_misses,
            "retries": self.retries_total,
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
