"""Spans and kernel launch records of the serve path, on one host clock.

A :class:`SpanRecorder` given to ``Server(spans=...)`` (or set as
``Server.spans``) records, in memory:

* **spans** — ``id``, ``parent``, ``name``, ``start_ns``, ``end_ns`` and
  ``attrs``, stamped with ``time.perf_counter_ns``.  The tree under one
  ``serve.step``::

      serve.step                     uids (the requests given a token)
        serve.admit                  one per admitted request: uid
          model.prefill
            model.attention, model.mlp      per block
          serve.splice               the prefill cache into its slot
          serve.first_token          the prefill's argmax on the host
        serve.decode                 positions (of the live slots)
          model.decode_step
            model.attention, model.mlp      per block
          serve.wait                 the argmax's ``.cpu()``
        serve.retire                 one per finished request

  ``model.mlp`` is a block's feed-forward half, an MoE's in an MoE
  block; a Mamba2 layer has no span of its own.  Under the sigmoid
  routing (``models/moe.py:moe_sigmoid``) ``model.mlp`` holds
  ``model.experts``, the held experts' products, with two counters kept
  as device tensors until :meth:`SpanRecorder.records`: ``routed``, the
  (live row, choice) pairs that landed on a held expert, and
  ``held_reached``, the held experts with at least one.

* **launch records** of K1 (``ame_gemm``: m, k, n, in_bytes,
  out_bytes), of the decode attention (``decode_attention``: slots b,
  KV heads hkv, group size g, head dim d, cache length clen, in_bytes)
  and of MLA's decode attention (``mla_decode``: slots b, heads h,
  latent and rope widths r and rd, cache length clen, in_bytes), each
  with the id of the span open at the launch and a stamp.

* **a decode step run from its CUDA graph.**  On the card
  ``model.decode_step`` runs its torch operations from CUDA graphs of
  its buffers from their second call on (``models/decode_graph.py``),
  and launches K1 and the decode attentions from Python between them.
  Such a step's span carries ``graph: "capture"`` (the call that
  captured the graphs) or ``graph: "replay"``, and the records of all
  its launches, as an eager step's; it has no ``model.attention``,
  ``model.mlp`` or ``model.experts`` span inside it, and so no MoE
  counters, since nothing of a recorder is captured into a graph.

* **clock anchors** — ``(perf_counter_ns, time_ns)`` pairs read back to
  back when the recorder is made and at each :meth:`SpanRecorder.records`
  call.  ``torch.profiler``'s kineto events carry Unix-epoch
  nanoseconds; :func:`unix_to_perf_ns` maps them onto the spans' clock.

While a ``serve.step`` span is open the recorder is :data:`ACTIVE`.
The serve, model and kernel layers reach it through three hooks, with
no change of signature: ``with span(name, **attrs):`` makes the block a
span inside the innermost open one (closed also when the block raises),
:func:`note` adds attributes to the innermost open span, and
:func:`record_launch` appends a kernel's launch record.  With no
recorder each hook is one ``is None`` test: nothing is allocated and
nothing synchronises, and :func:`span` returns the shared :data:`NULL`.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: the recorder of the open ``Server`` span, else None; the hooks below
#: read it
ACTIVE: Optional["SpanRecorder"] = None
#: what :func:`span` returns with no recorder: a ``with`` that does
#: nothing and binds None
NULL = contextlib.nullcontext()
#: the fields of each kernel's launch record, in the order ``launch``
#: takes them
LAUNCH_FIELDS = {"k1": ("m", "k", "n", "in_bytes", "out_bytes"),
                 "decode_attention": ("b", "hkv", "g", "d", "clen",
                                      "in_bytes"),
                 "mla_decode": ("b", "h", "r", "rd", "clen", "in_bytes")}

_now = time.perf_counter_ns


def clock_anchor() -> Tuple[int, int]:
    """``(time.perf_counter_ns(), time.time_ns())`` read back to back."""
    return _now(), time.time_ns()


class SpanRecorder:
    """In-memory spans, launch records and clock anchors (module doc)."""

    def __init__(self):
        # [id, parent, name, start_ns, end_ns, attrs]
        self._spans: List[list] = []
        # (kernel, span id, perf_counter_ns, fields)
        self._launches: List[tuple] = []
        self._open: List[int] = []
        self.anchors: List[Tuple[int, int]] = [clock_anchor()]
        #: during a decode step, the server's live slots as a device bool
        #: (slots,) tensor, for counters that count live rows alone
        self.live = None

    def open(self, name: str, **attrs) -> int:
        """Open span ``name`` inside the innermost open one; returns its id.
        The first span opened makes this recorder :data:`ACTIVE`."""
        global ACTIVE
        o = self._open
        sid = len(self._spans)
        if o:
            parent = o[-1]
        else:
            parent, ACTIVE = None, self
        self._spans.append([sid, parent, name, _now(), None, attrs])
        o.append(sid)
        return sid

    def close(self, sid: int) -> None:
        """Close span ``sid`` and any still open inside it (a raise that
        left them open).  Closing the outermost span sets :data:`ACTIVE`
        back to None."""
        global ACTIVE
        t = _now()
        o, ss = self._open, self._spans
        while o:
            top = o.pop()
            ss[top][4] = t
            if top == sid:
                break
        if not o:
            ACTIVE = None

    def span(self, name: str, **attrs) -> "_Span":
        """``with rec.span(name):`` the block as span ``name`` (opened and
        closed as :meth:`open` and :meth:`close` do), bound to this
        recorder."""
        return _Span(self, name, attrs)

    def note(self, **attrs) -> None:
        """Add ``attrs`` to the innermost open span."""
        self._spans[self._open[-1]][5].update(attrs)

    def launch(self, kernel: str, *fields) -> None:
        """Record one launch of ``kernel`` (its :data:`LAUNCH_FIELDS`, in
        order) under the innermost open span."""
        o = self._open
        self._launches.append((kernel, o[-1] if o else None, _now(), fields))

    def records(self) -> Dict:
        """Everything recorded, as plain data: ``spans`` and ``launches``
        (dicts, in the order they opened or ran) and ``anchors``, this
        call's pair appended.  A span still open has ``end_ns`` None.
        Counters kept as device tensors are read here, as numbers."""
        self.anchors.append(clock_anchor())
        return {
            "spans": [dict(id=i, parent=p, name=n, start_ns=s, end_ns=e,
                           attrs={k: v.tolist() if hasattr(v, "tolist")
                                  else v for k, v in a.items()})
                      for i, p, n, s, e, a in self._spans],
            "launches": [dict(kernel=k, span=sid, t_ns=t,
                              **dict(zip(LAUNCH_FIELDS[k], f)))
                         for k, sid, t, f in self._launches],
            "anchors": list(self.anchors),
        }


class _Span:
    """A span of ``rec`` opened on entering a ``with`` and closed on
    leaving it, by a raise too."""
    __slots__ = ("rec", "name", "attrs", "sid")

    def __init__(self, rec: SpanRecorder, name: str, attrs: Dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self) -> SpanRecorder:
        self.sid = self.rec.open(self.name, **self.attrs)
        return self.rec

    def __exit__(self, *exc) -> None:
        self.rec.close(self.sid)


def span(name: str, **attrs):
    """``with span(name, **attrs) as rec:`` the block as a span of the
    :data:`ACTIVE` recorder, ``rec``; :data:`NULL` (``rec`` None) with
    none."""
    rec = ACTIVE
    return NULL if rec is None else _Span(rec, name, attrs)


def note(**attrs) -> None:
    """Add ``attrs`` to the active recorder's innermost open span."""
    rec = ACTIVE
    if rec is not None:
        rec.note(**attrs)


def record_launch(kernel: str, *fields) -> None:
    """Record a launch of ``kernel`` (its :data:`LAUNCH_FIELDS`, in order)
    under the active recorder's innermost open span."""
    rec = ACTIVE
    if rec is not None:
        rec.launch(kernel, *fields)


def unix_to_perf_ns(anchors: Sequence[Tuple[int, int]], unix_ns: float
                    ) -> float:
    """A Unix-epoch time in ns on the ``perf_counter_ns`` clock, by the
    line through the first and last anchors (the offset alone with one)."""
    p0, u0 = anchors[0]
    p1, u1 = anchors[-1]
    rate = (p1 - p0) / (u1 - u0) if u1 != u0 else 1.0
    return p0 + (unix_ns - u0) * rate


def paths(spans: Iterable[Dict]) -> Dict[int, str]:
    """Each span's id -> the names from its root down to it, joined by
    ``/`` (``serve.step/serve.decode/model.decode_step``)."""
    out: Dict[int, str] = {}
    for s in spans:                     # parents open before children
        p = s["parent"]
        out[s["id"]] = s["name"] if p is None else out[p] + "/" + s["name"]
    return out


def innermost(spans: Sequence[Dict], intervals: Iterable[Tuple[float, float]]
              ) -> Dict[Optional[str], float]:
    """Split ``intervals`` (on the spans' clock, in their unit) among the
    innermost spans open over them: each piece's length goes to that
    span's path (:func:`paths`), a piece under no span to None.  Spans
    nest, so the values partition the intervals and sum to their total.
    Spans still open, and spans of no length, are left out."""
    path = paths(spans)
    events = []
    for s in spans:
        if s["end_ns"] is not None and s["end_ns"] > s["start_ns"]:
            events.append((s["start_ns"], 1, s["id"]))
            events.append((s["end_ns"], 0, s["id"]))
    events.sort()          # at one instant, closes (0) before opens (1)
    # (start, end, innermost id or None) covering the spans' whole range
    pieces: List[Tuple[float, float, Optional[int]]] = []
    stack: List[int] = []
    t = None
    for when, kind, sid in events:
        if t is not None and when > t:
            pieces.append((t, when, stack[-1] if stack else None))
        t = when
        if kind:
            stack.append(sid)
        else:
            stack.remove(sid)
    out: Dict[Optional[str], float] = {}
    j = 0
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= lo:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < hi:
            s, e, sid = pieces[k]
            o = min(e, hi) - max(s, lo)
            if o > 0:
                key = path[sid] if sid is not None else None
                out[key] = out.get(key, 0.0) + o
                covered += o
            k += 1
        if hi - lo - covered > 0:
            out[None] = out.get(None, 0.0) + (hi - lo - covered)
    return out
