"""CUDA graphs of the batched decode step, one for each set of buffers.

An eager decode step issues every operation of every layer from Python:
a few thousand small launches a step, whose issue the card waits for.
:func:`run`, which ``models.model.decode_step`` calls with its body,
captures the body's torch operations once into CUDA graphs and replays
them; the port's hand-written kernels (K1, the decode attention) are
still launched from Python, each between two graphs.

**Pieces.**  While a step is captured, every launch of a hand-written
kernel (``kernels.ops.launch(name, ...)``) ends the graph captured so
far (a *piece*), replays it, launches the kernel outside any capture and
begins the next piece.  A step is then pieces and launches in turn, and
a replay runs them in the same order, each launch through ``ops.<name>``
as it is at the replay, with its output written into the tensor that
the capture's launch returned.  So every kernel launch the card runs is
a call of its wrapper, as in an eager step: its launch counter counts
it, an active span recorder gets its record, and a wrapper put in the
kernel's place (a benchmark's tracer) sees it.  The
pieces share one memory pool and always run in capture order, so what
one piece frees a later one may reuse; a piece in which nothing was
captured is dropped.

**When a graph engages** (:func:`engages`): the tokens, positions,
parameters and caches are plain tensors (no DTensor, no other subclass)
on one CUDA device, none needs a gradient, and no capture is under way
on the current stream.  Any other call runs eagerly: CPU tensors, the
sharded step's DTensors.  The **buffers** of a call are the data
pointers, shapes, strides and dtypes of its parameter and cache leaves,
the shapes and dtypes of its tokens and positions, the config and the
backend.  For one set of buffers:

1. the first call runs eagerly, so that a caller that decodes once never
   pays a capture, and the lazy set-up of what the step launches (kernel
   builds, shared-memory attributes, cached frequencies, the decode
   kernel's arrival counts) happens outside any capture;
2. the second call captures the step, running each piece as soon as it
   is captured and each launch as it comes, so it computes the step;
3. every later call replays: it copies tokens and positions into the
   graph's own, runs the pieces and launches, and returns a copy of the
   logits, so a later call never overwrites logits returned before.  The
   caches are updated in place, as the eager step updates them.

**Spans.**  No span, counter or device-side hook of a span recorder is
captured: the pieces are captured with no recorder active
(``obs.spans.ACTIVE`` None), and the launches between them run under
the caller's.  Under a recorder a capturing or replaying step is one
``model.decode_step`` span that carries ``graph: "capture"`` or
``"replay"`` and the records of its K1 and decode attention launches,
with no span inside it.

**Lifetime.**  A graph belongs to its buffers: it goes, with its memory
pool, when any of their tensors is freed (a ``Server`` deleted), so
processes that build many servers hold one graph for each live one.  It
holds aliases of the tensors its launches read, never the buffers'
tensors themselves, which would keep them alive.

Counters: :data:`eager`, :data:`captures`, :data:`replays`; every call
is counted by exactly one of them.
"""
from __future__ import annotations

import warnings
import weakref
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.obs import spans

#: decode steps that ran their body eagerly
eager = 0
#: decode steps that captured their buffers' graph
captures = 0
#: decode steps that replayed a graph
replays = 0

#: a set of buffers -> its :class:`_Entry`
_ENTRIES: Dict[tuple, "_Entry"] = {}
#: a device -> the one stream every capture on it runs on, as
#: ``torch.cuda.graph`` keeps one (a stream of its own for each capture
#: would leave each its own cuBLAS workspace)
_SIDE: Dict[torch.device, torch.cuda.Stream] = {}


def _leaves(tree, out: List) -> List:
    for v in tree.values():
        if isinstance(v, dict):
            _leaves(v, out)
        else:
            out.append(v)
    return out


def engages(tensors) -> bool:
    """Whether a step over ``tensors`` may run from a graph: each a plain
    tensor on the first one's CUDA device, none requiring a gradient, and
    no capture under way on the current stream."""
    dev = tensors[0].device
    for t in tensors:
        if type(t) is not torch.Tensor or not t.is_cuda or t.device != dev \
                or t.requires_grad:
            return False
    return not torch.cuda.is_current_stream_capturing()


def _alias(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


class _Graph:
    """One step captured in pieces (module doc): its own tokens and
    positions, the pieces and launches in order, and the logits."""

    def __init__(self, body, params, tokens, positions, caches, cfg,
                 backend):
        self.tokens, self.positions = tokens.clone(), positions.clone()
        #: pieces (``torch.cuda.CUDAGraph``) and launches (name, args,
        #: kw), in the order they run
        self.steps: List = []
        self._pool = torch.cuda.graph_pool_handle()
        self._piece: Optional[torch.cuda.CUDAGraph] = None
        self._active = spans.ACTIVE
        here = torch.cuda.current_stream(tokens.device)
        side = _SIDE.get(tokens.device)
        if side is None:
            side = _SIDE[tokens.device] = torch.cuda.Stream(tokens.device)
        side.wait_stream(here)
        saved, ops.split, spans.ACTIVE = ops.split, self._launch, None
        try:
            with torch.cuda.stream(side):
                self._begin()
                logits = body(params, self.tokens, self.positions, caches,
                              cfg, backend)
                self._end()
        finally:
            if self._piece is not None:      # the body raised mid-piece
                self._piece.capture_end()
            ops.split, spans.ACTIVE = saved, self._active
        here.wait_stream(side)
        for s in self.steps:                 # made on ``side``, read on
            if isinstance(s, tuple):         # the caller's stream
                s[2]["out"].record_stream(here)
        self.logits = _alias(logits)
        del self._active

    def _begin(self) -> None:
        self._piece = torch.cuda.CUDAGraph()
        self._piece.capture_begin(pool=self._pool)

    def _end(self) -> None:
        piece, self._piece = self._piece, None
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            piece.capture_end()
        if any("empty" in str(w.message) for w in said):
            return                           # nothing was captured
        piece.replay()
        self.steps.append(piece)

    def _launch(self, name: str, args, kw):
        self._end()
        spans.ACTIVE = self._active
        try:
            out = getattr(ops, name)(*args, **kw)
        finally:
            spans.ACTIVE = None
        self.steps.append((name, tuple(map(_alias, args)),
                           dict(kw, out=_alias(out))))
        self._begin()
        return out

    def replay(self, tokens, positions) -> torch.Tensor:
        self.tokens.copy_(tokens)
        self.positions.copy_(positions)
        for s in self.steps:
            if isinstance(s, tuple):
                name, args, kw = s
                getattr(ops, name)(*args, **kw)
            else:
                s.replay()
        return self.logits.clone()


class _Entry:
    """A set of buffers seen: ``graph`` None until the second call."""
    __slots__ = ("graph", "__weakref__")

    def __init__(self):
        self.graph: Optional[_Graph] = None


def _forget(key: tuple, entry: "weakref.ref") -> None:
    e = entry()
    if e is not None and _ENTRIES.get(key) is e:
        del _ENTRIES[key]


def run(body, params, tokens, positions, caches, cfg, backend
        ) -> torch.Tensor:
    """``body(params, tokens, positions, caches, cfg, backend)`` -> logits,
    run eagerly or from its buffers' graph (module doc).  Under an active
    recorder its innermost open span is the step's."""
    global eager, captures, replays
    leaves = _leaves(caches, _leaves(params, [tokens, positions]))
    entry = None
    if engages(leaves):
        key = (cfg, backend, tokens.shape, tokens.dtype, positions.shape,
               positions.dtype, tuple((t.data_ptr(), t.shape, t.stride(),
                                       t.dtype) for t in leaves[2:]))
        entry = _ENTRIES.get(key)
        if entry is None:                    # first sight: eager
            ref = weakref.ref(_ENTRIES.setdefault(key, _Entry()))
            for t in leaves[2:]:
                weakref.finalize(t, _forget, key, ref)
    if entry is None:
        eager += 1
        return body(params, tokens, positions, caches, cfg, backend)
    if entry.graph is None:
        entry.graph = _Graph(body, params, tokens, positions, caches, cfg,
                             backend)
        captures += 1
        spans.note(graph="capture")
        return entry.graph.logits.clone()
    replays += 1
    spans.note(graph="replay")
    return entry.graph.replay(tokens, positions)
