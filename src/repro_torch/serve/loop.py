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
``wall=True`` stamps wall-clock time (``time.perf_counter``) instead,
and an explicit ``clock=`` shares one clock across servers.

``spans=SpanRecorder()`` (or setting ``Server.spans``) records a span
tree of every step, with the model's spans and K1's launch records
inside it, on the same ``perf_counter`` clock
(:mod:`repro_torch.obs.spans`); the default, None, records nothing.

:class:`TrafficServer` is the load-study twin: it drives a
:class:`~repro_torch.serve.offload.DecodeOffload` under a stochastic
arrival :class:`~repro_torch.serve.traffic.Trace` entirely in virtual
time, with prefill/decode disaggregation (prefill priced on the host
roofline, decode PIM-resident, the prefilled KV handed off across the
shared :class:`~repro_torch.runtime.cluster.HostLinkLedger`), chunked
prefill, admission control, slot autoscaling and SLO goodput accounting.
It runs no model and nothing on the card.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.isa import PIM_FREQ_HZ
from repro_torch.faults.plan import as_plan
from repro_torch.launch.device import resolve_device
from repro_torch.models import model as lm
from repro_torch.models.layers import as_backend
from repro_torch.obs import spans
from repro_torch.obs.metrics import Histogram
from repro_torch.obs.spans import SpanRecorder
from repro_torch.runtime.cluster import HostLinkLedger
from repro_torch.serve.offload import DecodeOffload
from repro_torch.serve.traffic import (SLO, HostCostModel, SimClock, Trace,
                                       TraceRequest, WallClock)


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
                 backend="kernel", device=None,
                 spans: Optional[SpanRecorder] = None):
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
        self.spans = spans
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
                with spans.span("serve.admit", uid=req.uid):
                    self._prefill(i, req)

    def _prefill(self, i: int, req: Request):
        """Prefill ``req`` into slot ``i``; its first token is the
        prefill's argmax."""
        req.admitted_at = self.clock.now
        if self.metrics is not None:
            self.metrics.histogram(
                "serve.queue_delay_s", unit="s",
                help="queue wait (submit -> prefill start)"
            ).record(req.admitted_at - req.submitted_at)
        toks = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                               device=self.device)
        logits, fresh = lm.prefill(self.params, {"tokens": toks}, self.cfg,
                                   cache_len=self.cache_len,
                                   backend=self.backend)
        self.prefills += 1
        with spans.span("serve.splice"):
            _splice(self.caches, fresh, i)
        with spans.span("serve.first_token"):
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
        decode, retire; count the iteration against the step deadline.
        With a span recorder the iteration is one ``serve.step`` span."""
        rec = self.spans
        with spans.NULL if rec is None else rec.span("serve.step"):
            return self._step()

    def _step(self):
        track_wall = self.metrics is not None \
            or self.step_deadline_s is not None
        t0 = time.perf_counter() if track_wall else 0.0
        self._iter += 1
        self._apply_serve_faults()
        self._admit()
        live = [i for i in range(self.slots) if self.active[i] is not None]
        if not live:
            # backing-off requests still count as pending work
            return bool(self.queue)
        with spans.span("serve.decode",
                        positions=[int(self.pos[i]) for i in live]) as rec:
            if rec:             # the live rows, for moe.py's counters
                mask = torch.zeros(self.slots, dtype=torch.bool)
                mask[live] = True
                rec.live = mask.to(self.device)
            toks = np.zeros((self.slots, 1), np.int64)
            for i in live:
                toks[i, 0] = self.active[i].out_tokens[-1]
            logits, self.caches = lm.decode_step(
                self.params, torch.from_numpy(toks).to(self.device),
                torch.from_numpy(self.pos.astype(np.int64)).to(self.device),
                self.caches, self.cfg, backend=self.backend)
            if rec:
                rec.live = None
            self.decode_steps += 1
            rec_off = None
            if self.pim_offload is not None:
                rec_off = self.pim_offload.step(
                    len(live),
                    request_ids=[self.active[i].uid for i in live])
            # the decode iteration's virtual duration: the PIM step's
            # clocked makespan when a sidecar ran it, else the host decode
            # roofline
            self.clock.advance(rec_off.pim_s if rec_off is not None
                               else self.cost.decode_step_s(len(live)))
            with spans.span("serve.wait"):
                nxt = torch.argmax(logits, -1).cpu().numpy()
        # on serve.step; an admitted request is live: its first two tokens
        # are here
        spans.note(uids=[self.active[i].uid for i in live])
        for i in live:
            req = self.active[i]
            req.out_tokens.append(int(nxt[i]))
            self.pos[i] += 1
            hit_eos = self.eos_id is not None and int(nxt[i]) == self.eos_id
            if (len(req.out_tokens) >= req.max_new or hit_eos
                    or int(self.pos[i]) >= self.cache_len - 1):
                with spans.span("serve.retire"):
                    self._retire(i)
        if track_wall:
            wall = time.perf_counter() - t0
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


# ---------------------------------------------------------------------------
# Traffic-driven virtual-time serving: prefill/decode disaggregation
# ---------------------------------------------------------------------------


class _BusyLane:
    """One contended resource as a set of reserved busy intervals.

    A scalar "free after the last reservation" clock is wrong for the
    host link: prefill KV handoffs are reserved *into the future* (each
    chunk ships only after its compute lands), and a decode step's small
    activation window arriving *now* may use the idle gap in front of
    them instead of queueing behind the whole prefill pipeline.
    ``reserve`` places a duration at the earliest gap at or after
    ``ready`` — first-fit, which is link arbitration with no preemption.
    """

    def __init__(self):
        self._busy: List[Tuple[float, float]] = []   # sorted, disjoint

    def prune(self, now: float) -> None:
        """Drop intervals that ended before ``now`` — reservations are
        never placed in the past, so they can no longer collide."""
        self._busy = [iv for iv in self._busy if iv[1] > now]

    def reserve(self, ready: float, dur: float) -> Tuple[float, float]:
        """Occupy the lane for ``dur`` seconds starting at the earliest
        instant >= ``ready`` with no overlap; returns ``(start, end)``."""
        if dur <= 0:
            return ready, ready
        t = ready
        at = 0
        for i, (s, e) in enumerate(self._busy):
            if s - t >= dur:        # fits in the gap before interval i
                at = i
                break
            t = max(t, e)
            at = i + 1
        self._busy.insert(at, (t, t + dur))
        return t, t + dur


class TrafficServer:
    """Virtual-time load simulator: a decode-resident PIM server under a
    stochastic arrival :class:`~repro_torch.serve.traffic.Trace` (port of
    ``repro.serve.loop.TrafficServer``).

    Where :class:`Server` runs the model, ``TrafficServer`` *clocks*
    serving at full scale: every duration comes from the analytic cost
    substrate (the offload's per-step PIM makespan, the
    :class:`~repro_torch.serve.traffic.HostCostModel` prefill roofline,
    and the host-link cycles of
    :class:`~repro_torch.runtime.cluster.HostLinkLedger`), so thousands
    of requests simulate in seconds and every latency percentile is
    deterministic and machine-independent.

    Three resources contend, each in virtual seconds:

    * the **host device** (prefill chunks — compute the prompt's KV and
      first token), priced by ``cost`` (the H100 descriptor by default;
      pass the reference's constants to reproduce its numbers);
    * the **shared host link** (prefilled KV handed off to PIM pages as
      ``"prefill"`` windows, per-decode-step activations as ``"acts"``
      windows — charged on the offload cluster's own ledger when it has
      one, so they land in its trace);
    * the **PIM decode pipeline** (batched decode steps, priced by the
      offload's :class:`~repro_torch.serve.offload.StepRecord`).

    ``disaggregate=True`` (default) lets the host prefill ahead while PIM
    decodes — the two phases contend only on the link.
    ``disaggregate=False`` is the **colocated** baseline: prefill chunks
    serialize on the decode lane (one chunk per prefilling request per
    serving iteration), stalling decode as a single-pipeline server does.
    ``chunk_tokens`` bounds that stall in both modes.

    Admission control (``max_queue``), slot autoscaling (``autoscale=``
    one of the :mod:`repro_torch.serve.traffic` policies) and an
    :class:`~repro_torch.serve.traffic.SLO` for goodput/attainment
    complete the load study.  With ``kv_offload`` sidecars the KV
    lifecycle (``kv_prefill`` at handoff, ``kv_release`` at retire) runs
    for real; analytic decode step costs are probed once per distinct
    batch size (``cache_steps``; exact stepping is forced when the step
    cost is stateful, i.e. the KV cache grows).

    Strictly additive: running an empty trace leaves the offload's
    ledgers ``==`` and its trace byte-identical.
    """

    def __init__(self, offload: DecodeOffload, *, slots: int = 4,
                 disaggregate: bool = True, chunk_tokens: int = 256,
                 max_queue: Optional[int] = None, autoscale=None,
                 slo: Optional[SLO] = None, metrics=None, clock=None,
                 cost: Optional[HostCostModel] = None,
                 cache_steps: Optional[bool] = None,
                 step_costs: Optional[Dict[int, Tuple[float, int]]] = None):
        if offload.async_mode:
            raise ValueError(
                "TrafficServer clocks its own virtual lanes; drive it "
                "with a serialized (async_mode=False) offload")
        self.off = offload
        self.cfg = offload.cfg
        self.cost = cost if cost is not None else HostCostModel(offload.cfg)
        self.slots = slots
        self.disaggregate = disaggregate
        self.chunk_tokens = max(1, chunk_tokens)
        self.max_queue = max_queue
        self.autoscale = autoscale
        self.slo = slo
        self.metrics = metrics
        self.clock = clock if clock is not None else SimClock()
        # analytic StepRecords are pure functions of the batch size, so
        # one probe step per distinct batch prices every iteration; a
        # growing KV cache makes the cost stateful -> step exactly
        self.cache_steps = (offload.kv is None) if cache_steps is None \
            else cache_steps
        self._step_costs: Dict[int, Tuple[float, int]] = \
            step_costs if step_costs is not None else {}
        # the shared host link: the offload cluster's ledger when it has
        # one (multi-stack — handoff windows then land in its trace),
        # else an own ledger with identical accounting
        stack = offload.rt.stack
        self.link: HostLinkLedger = getattr(stack, "link", None) \
            or HostLinkLedger()
        # host and PIM are monotonic "free at" times (their work is
        # always scheduled at the current sim time); the link takes
        # future reservations, so it books busy intervals
        self._host_free_s = 0.0         # host prefill lane
        self._pim_free_s = 0.0          # PIM decode lane
        self._link_lane = _BusyLane()
        if self.link.tl_free > 0:       # respect prior async occupancy
            self._link_lane.reserve(0.0, self.link.tl_free / PIM_FREQ_HZ)
        self.queue: List[Request] = []
        self.active: List[Request] = []         # decode-resident
        self.prefilling: List[Request] = []     # colocated chunk progress
        self._tokens_left: Dict[int, int] = {}  # colocated prefill tokens
        self._ready_s: Dict[int, float] = {}    # uid -> KV handoff done
        self._last_tok_s: Dict[int, float] = {}
        self.completed: List[Request] = []
        self.shed_requests: List[TraceRequest] = []
        self.shed = 0
        self.iterations = 0
        self.slots_max_seen = slots
        self.max_decode_gap_s = 0.0     # worst inter-token decode stall
        self._recent_ttft: List[float] = []

    # -- resource lanes -------------------------------------------------------

    def _link_window(self, kind: str, nbytes: int,
                     ready_s: float) -> Tuple[float, float]:
        """Charge ``nbytes`` on the shared host link as one ``kind``
        event and occupy the link lane for its clocked duration starting
        no earlier than ``ready_s``; returns ``(start, end)`` seconds."""
        if nbytes <= 0:
            return ready_s, ready_s
        cyc = self.link.charge(kind, nbytes)
        self._link_lane.prune(self.clock.now)
        start, end = self._link_lane.reserve(ready_s, cyc / PIM_FREQ_HZ)
        self.link.tl_free = max(self.link.tl_free, end * PIM_FREQ_HZ)
        return start, end

    def _step_cost(self, batch: int,
                   rids: List[int]) -> Tuple[float, int]:
        """One decode iteration's ``(pim_s, h2d_bytes)`` over ``batch``
        slots — probed once per distinct batch when cacheable."""
        if not self.cache_steps:
            rec = self.off.step(batch, request_ids=rids)
            return rec.pim_s, rec.h2d_bytes
        if batch not in self._step_costs:
            rec = self.off.step(batch)
            self._step_costs[batch] = (rec.pim_s, rec.h2d_bytes)
        return self._step_costs[batch]

    @property
    def routing_observed(self):
        """The offload's observed per-layer expert-selection histogram
        (a :class:`~repro_torch.serve.traffic.RoutingProfile`), or
        ``None`` when the offload is not routed (``routing=None``)."""
        return self.off.observed

    # -- request lifecycle ----------------------------------------------------

    def _arrive(self, tr: TraceRequest) -> None:
        if self.max_queue is not None:
            cap = max(1, int(self.max_queue * self.off.surviving_fraction))
            if len(self.queue) >= cap:
                self.shed += 1
                self.shed_requests.append(tr)
                if self.metrics is not None:
                    self.metrics.counter(
                        "serve.shed", unit="requests",
                        help="arrivals shed by admission control").inc()
                return
        req = Request(uid=tr.uid,
                      prompt=np.zeros((tr.prompt_len,), np.int32),
                      max_new=tr.max_new, submitted_at=tr.at_s)
        self.queue.append(req)

    def _admit(self, req: Request) -> None:
        now = self.clock.now
        req.admitted_at = now
        if self.metrics is not None:
            self.metrics.histogram(
                "serve.queue_delay_s", unit="s",
                help="queue wait (arrival -> prefill start)").record(
                now - req.submitted_at)
        if not self.disaggregate:
            # colocated: chunks serialize on the decode lane, one per
            # serving iteration (see _prefill_chunk_colocated)
            self._tokens_left[req.uid] = len(req.prompt)
            self.prefilling.append(req)
            return
        # disaggregated: the whole chunked prefill schedules on the host
        # lane now; each chunk's KV hands off over the link as soon as
        # its compute lands.  TTFT closes at the last chunk's compute
        # (the prefill argmax); decode may start once the last handoff
        # clears the link.
        tokens, t, ready = len(req.prompt), now, now
        while tokens > 0:
            ct = min(self.chunk_tokens, tokens)
            tokens -= ct
            cs = max(t, self._host_free_s)
            ce = cs + self.cost.prefill_s(ct)
            self._host_free_s = t = ce
            _, ready = self._link_window(
                "prefill", self.cost.kv_ship_bytes(ct), ce)
        req.first_token_at = t
        self._finish_prefill(req, ready)

    def _prefill_chunk_colocated(self, req: Request) -> None:
        """Advance one colocated request's prefill by one chunk *on the
        decode lane* — the serialization that makes colocated serving
        stall, and what ``chunk_tokens`` bounds."""
        ct = min(self.chunk_tokens, self._tokens_left[req.uid])
        cs = max(self.clock.now, self._pim_free_s)
        ce = cs + self.cost.prefill_s(ct)
        self._pim_free_s = ce
        _, ready = self._link_window(
            "prefill", self.cost.kv_ship_bytes(ct), ce)
        self.clock.advance_to(ce)
        self._tokens_left[req.uid] -= ct
        if self._tokens_left[req.uid] <= 0:
            del self._tokens_left[req.uid]
            self.prefilling.remove(req)
            req.first_token_at = ce
            self._finish_prefill(req, ready)

    def _finish_prefill(self, req: Request, ready_s: float) -> None:
        req.out_tokens.append(0)        # the prefill argmax (token 1)
        ttft = req.first_token_at - req.submitted_at
        self._recent_ttft.append(ttft)
        if self.metrics is not None:
            self.metrics.histogram(
                "serve.ttft_s", unit="s",
                help="time to first token (arrival -> prefill argmax)"
            ).record(ttft)
        self._ready_s[req.uid] = ready_s
        self._last_tok_s[req.uid] = req.first_token_at
        self.active.append(req)
        if self.off.kv is not None:
            self.off.kv_prefill(req.uid, len(req.prompt))

    def _decode_step(self) -> bool:
        """One batched decode iteration over every handoff-complete
        active request; returns False when none is eligible yet."""
        now = self.clock.now
        eligible = [r for r in self.active if self._ready_s[r.uid] <= now]
        if not eligible:
            return False
        pim_s, h2d = self._step_cost(len(eligible),
                                     [r.uid for r in eligible])
        # the step's activations cross the link, then PIM computes
        _, le = self._link_window("acts", h2d, now)
        ds = max(le, self._pim_free_s)
        de = ds + pim_s
        self._pim_free_s = de
        self.clock.advance_to(de)
        for req in eligible:
            self.max_decode_gap_s = max(
                self.max_decode_gap_s, de - self._last_tok_s[req.uid])
            self._last_tok_s[req.uid] = de
            req.out_tokens.append(0)
            if len(req.out_tokens) >= req.max_new:
                self._retire(req, de)
        return True

    def _retire(self, req: Request, at_s: float) -> None:
        req.done = True
        req.finished_at = at_s
        self.active.remove(req)
        del self._ready_s[req.uid], self._last_tok_s[req.uid]
        self.completed.append(req)
        if self.off.kv is not None:
            self.off.kv_release(req.uid)
        if self.metrics is not None:
            m = self.metrics
            m.counter("serve.requests", unit="requests",
                      help="requests completed").inc()
            m.counter("serve.tokens", unit="tokens",
                      help="tokens generated (first token included)").inc(
                len(req.out_tokens))
            if len(req.out_tokens) >= 2:
                m.histogram(
                    "serve.tpot_s", unit="s",
                    help="time per output token after the first").record(
                    (req.finished_at - req.first_token_at)
                    / (len(req.out_tokens) - 1))

    # -- the serving loop -----------------------------------------------------

    def run(self, trace: Trace, max_iters: int = 2_000_000
            ) -> List[Request]:
        """Replay ``trace`` to completion; returns the completed
        requests (``latency_summary`` aggregates them)."""
        pending = list(trace)
        pi, n = 0, len(pending)
        while pi < n or self.queue or self.active or self.prefilling:
            self.iterations += 1
            if self.iterations > max_iters:
                raise RuntimeError(
                    f"traffic simulation exceeded max_iters={max_iters} "
                    f"({len(self.completed)} completed, "
                    f"{len(self.queue)} queued)")
            now = self.clock.now
            while pi < n and pending[pi].at_s <= now:
                self._arrive(pending[pi])
                pi += 1
            if self.autoscale is not None:
                live = len(self.active) + len(self.prefilling)
                self.slots = max(1, self.autoscale.target(
                    queue_len=len(self.queue), slots=self.slots,
                    live=live, recent_ttft=self._recent_ttft))
                self.slots_max_seen = max(self.slots_max_seen, self.slots)
            if self.metrics is not None:
                self.metrics.gauge(
                    "serve.queue_depth", unit="requests",
                    help="queued requests at iteration start").set(
                    len(self.queue))
                self.metrics.gauge(
                    "serve.slots", unit="slots",
                    help="decode slot capacity (autoscaled)").set(
                    self.slots)
            while self.queue and \
                    len(self.active) + len(self.prefilling) < self.slots:
                self._admit(self.queue.pop(0))
            for req in list(self.prefilling):
                self._prefill_chunk_colocated(req)
            stepped = self._decode_step() if self.active else False
            if stepped or self.prefilling or self.clock.now > now:
                continue
            # idle: jump to the next event (an arrival, or a pending KV
            # handoff completing)
            horizon = []
            if self.active:
                horizon.append(min(self._ready_s[r.uid]
                                   for r in self.active))
            if pi < n:
                horizon.append(pending[pi].at_s)
            if not horizon:
                raise RuntimeError(
                    "traffic simulation stalled with work pending — "
                    "this is a scheduler bug")
            self.clock.advance_to(min(horizon))
        return self.completed

    # -- reporting ------------------------------------------------------------

    def latency_summary(self) -> Dict:
        """Load-study summary: latency percentiles (virtual seconds),
        throughput and, with an :class:`~repro_torch.serve.traffic.SLO`
        attached, attainment and goodput; the reference's keys.

        Attainment counts shed arrivals as SLO misses (shedding is a
        service failure from the client's side); goodput is SLO-met
        completions per second of simulated serving time.
        """
        ttft = Histogram("serve.ttft_s", unit="s")
        tpot = Histogram("serve.tpot_s", unit="s")
        qdel = Histogram("serve.queue_delay_s", unit="s")
        met = 0
        for req in self.completed:
            t = req.first_token_at - req.submitted_at
            ttft.record(t)
            qdel.record(req.admitted_at - req.submitted_at)
            p = None
            if len(req.out_tokens) >= 2:
                p = (req.finished_at - req.first_token_at) \
                    / (len(req.out_tokens) - 1)
                tpot.record(p)
            if self.slo is not None and self.slo.met(t, p):
                met += 1
        span = max((r.finished_at for r in self.completed),
                   default=self.clock.now) or 1e-12
        offered = len(self.completed) + self.shed
        out = {
            "requests": len(self.completed),
            "shed": self.shed,
            "tokens": sum(len(r.out_tokens) for r in self.completed),
            "duration_s": span,
            "throughput_rps": len(self.completed) / span,
            "ttft_s": _pct_summary(ttft),
            "tpot_s": _pct_summary(tpot),
            "queue_delay_s": _pct_summary(qdel),
            "max_decode_gap_s": self.max_decode_gap_s,
            "iterations": self.iterations,
            "slots_max": self.slots_max_seen,
            "link_prefill_bytes": sum(
                b for k, b in self.link.events if k == "prefill"),
            "link_acts_bytes": sum(
                b for k, b in self.link.events if k == "acts"),
        }
        if self.slo is not None:
            out["slo"] = {"ttft_s": self.slo.ttft_s,
                          "tpot_s": self.slo.tpot_s}
            out["slo_met"] = met
            out["slo_attainment"] = met / offered if offered else 0.0
            out["goodput_rps"] = met / span
        return out


def _pct_summary(h: Histogram) -> Dict:
    """``Histogram.summary()`` plus the serving tail (p99.9)."""
    s = h.summary()
    s["p99.9"] = h.percentile(99.9)
    return s


def _splice(full, one, slot: int) -> None:
    """Copy the single-sequence prefill cache ``one`` into batch slot
    ``slot`` of the server cache ``full``, in place.  Cache leaves put
    batch at axis 1 (layer-stacked) for every family: the hybrid's mixed
    {groups, shared_kv, tail} cache and MLA's latent {ckv, kr} included.
    A leaf of ``one`` longer than ``full``'s along another axis is cut
    to it, a shorter one zero-filled to it, as the reference trims and
    pads."""
    for k, v in full.items():
        if isinstance(v, dict):
            _splice(v, one[k], slot)
            continue
        src, dst = one[k][:, 0], v[:, slot]
        if src.shape != dst.shape:
            overlap = tuple(slice(0, min(a, b))
                            for a, b in zip(dst.shape, src.shape))
            dst.zero_()
            dst, src = dst[overlap], src[overlap]
        dst.copy_(src)
