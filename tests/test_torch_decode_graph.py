"""The decode step's CUDA graphs (``repro_torch.models.decode_graph``).

On the CPU: every step runs eagerly, and the rule that engages a graph
takes plain card tensors alone.  The capture in pieces runs against
stand-ins for the CUDA graph API on a synthetic step whose torch
operations a fake graph records and replays: pieces and launches in
turn, empty pieces dropped, replays equal to eager steps, launches
through the wrapper in the kernel's place at replay, no recorder inside
a piece, the graph freed with its buffers, a capture that raises; the
hand-off in ``ops.launch`` and the two launches routed through it (K1 in
``ops.gemm``, the decode attention); RoPE's cached frequencies equal the
per-call form bit for bit.  ``gpu``-marked, on the card: replayed steps
``torch.equal`` to eager ones in logits and every cache leaf (the
reference is the same call on cloned caches: new buffers, so eager),
served tokens, launch counts against the counters and the profiler's
kernels, and memory.
"""
import contextlib
import gc
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.kernels import ame_gemm as k1
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import ops, ref
from repro_torch.models import decode_graph as dg
from repro_torch.models import layers
from repro_torch.models import model as lm
from repro_torch.obs import SpanRecorder, spans
from repro_torch.serve.loop import Request, Server
from test_torch_spans import _step_records

ROOT = Path(__file__).resolve().parents[1]
#: K1 projections of a qwen3 layer: q, k, v, o, gate, up, down
K1_PER_LAYER = 7


def _counters():
    return dg.eager, dg.captures, dg.replays


def _rise(before):
    return tuple(a - b for a, b in zip(_counters(), before))


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _leaves(tree):
    return dg._leaves(tree, [])


def _graph_of(caches):
    """The graph captured over ``caches``."""
    ptr = _leaves(caches)[-1].data_ptr()
    return next(e.graph for k, e in dg._ENTRIES.items()
                if e.graph is not None and k[-1][-1][0] == ptr)


def _prefilled(cfg, params, b, cache_len, device, seed=0):
    """Caches of ``b`` slots prefilled with random prompts of 5 tokens,
    the next tokens and positions."""
    gen = torch.Generator(device=device).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (b, 5), generator=gen,
                         device=device)
    with torch.no_grad():
        lg, caches = lm.prefill(params, {"tokens": toks}, cfg, cache_len)
    return caches, lg.argmax(-1)[:, None], torch.full((b,), 5, device=device)


# ---------------------------------------------------------------------------
# the CPU: eager, and the rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-370m", "zamba2-2.7b",
                                  "mixtral-8x22b", "deepseek-v3-671b"])
def test_cpu_steps_run_eagerly(name):
    """Every decode step over CPU tensors runs its body eagerly, with the
    body's logits and cache writes, and leaves no entry behind."""
    cfg = get(name).reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches, nxt, pos = _prefilled(cfg, params, 2, 16, "cpu")
    entries, before = len(dg._ENTRIES), _counters()
    for _ in range(3):
        mine = _clone(caches)
        want = lm._decode_body(params, nxt, pos, mine, cfg, lm.TORCH)
        got, out = lm.decode_step(params, nxt, pos, caches, cfg)
        assert out is caches and torch.equal(got, want)
        assert all(map(torch.equal, _leaves(caches), _leaves(mine)))
        nxt, pos = got.argmax(-1)[:, None], pos + 1
    assert _rise(before) == (3, 0, 0)
    assert len(dg._ENTRIES) == entries


class _Sub(torch.Tensor):
    """A tensor subclass, as a DTensor is one."""


@pytest.mark.parametrize("case,engages", [("plain", True),
                                          ("subclass", False),
                                          ("grad", False),
                                          ("capturing", False)])
def test_the_rule_takes_plain_card_tensors_alone(monkeypatch, case,
                                                 engages):
    """With every tensor made to read as a card tensor: plain tensors
    engage; a subclass (a DTensor), a tensor that needs a gradient, or a
    capture under way on the stream does not."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: case == "capturing")
    ts = [torch.zeros(3), torch.ones(2, 2)]
    if case == "subclass":
        ts.append(torch.zeros(4).as_subclass(_Sub))
    elif case == "grad":
        ts.append(torch.zeros(4, requires_grad=True))
    assert dg.engages(ts) is engages


def test_cpu_tensors_never_engage():
    assert not dg.engages([torch.zeros(3)])


# ---------------------------------------------------------------------------
# pieces and launches, with stand-ins for the CUDA graph API
# ---------------------------------------------------------------------------


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: between
    ``capture_begin`` and ``capture_end`` the operations handed to
    :func:`_op` are recorded, not run (with aliases of their tensors, as a
    CUDA graph holds addresses and no tensor), and each replay runs them;
    an empty capture warns as torch's does."""
    made: list = []
    capturing = None

    def __init__(self):
        self.ops, self.replays = [], 0
        _FakeGraph.made.append(self)

    def capture_begin(self, pool=None):
        assert _FakeGraph.capturing is None
        _FakeGraph.capturing = self

    def capture_end(self):
        _FakeGraph.capturing = None
        if not self.ops:
            import warnings
            warnings.warn("The CUDA Graph is empty. This usually means that "
                          "the graph was attempted to be captured on wrong "
                          "device or stream.")

    def replay(self):
        self.replays += 1
        for fn, args in self.ops:
            fn(*args)


def _op(fn, *args):
    """A torch operation of the synthetic step: recorded while a fake
    graph captures, else run; checks that no recorder is active inside a
    piece."""
    g = _FakeGraph.capturing
    if g is None:
        fn(*args)
    else:
        assert spans.ACTIVE is None
        g.ops.append((fn, [a.detach() if isinstance(a, torch.Tensor) else a
                           for a in args]))


class _Stream:
    def wait_stream(self, other):
        pass


class _Kernel:
    """A hand-written kernel's wrapper: out = 2 x scale + 1, each launch
    recorded as K1's wrapper records one."""

    def __call__(self, x, *, scale=1.0, out=None):
        if out is None:
            out = torch.empty_like(x)
        out.copy_(2 * x * scale + 1)
        spans.record_launch("k1", x.shape[0], x.shape[1], x.shape[1], 4, 4)
        return out


@pytest.fixture
def fake_card(monkeypatch):
    """The graph engaged for plain CPU tensors, over stand-ins for the
    CUDA graph, stream and pool API, with a fake kernel ``k`` set on
    ``ops``."""
    monkeypatch.setattr(dg, "engages", lambda ts: all(
        type(t) is torch.Tensor and not t.requires_grad for t in ts))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda t, s: None)
    monkeypatch.setattr(_FakeGraph, "made", [])
    monkeypatch.setattr(ops, "k", _Kernel(), raising=False)


def _body():
    """A synthetic decode step: an embedding, a launch, a cache update
    that reads the positions, two launches back to back (an empty piece
    between them), and a launch that returns the logits, with a cache
    tensor handed to a launch as it is."""
    def body(params, tokens, positions, caches, cfg, backend):
        h = torch.empty(tokens.shape[0], 4)
        _op(lambda t, w, o: o.copy_(w[t[:, 0]]), tokens, params["w"], h)
        y = ops.launch("k", h)
        _op(lambda c, a, p: c.add_(a + p[:, None]), caches["c"], y,
            positions)
        z = ops.launch("k", caches["c"], scale=0.5)
        z = ops.launch("k", z)
        u = torch.empty_like(z)
        _op(lambda a, b, o: torch.mul(a, b, out=o), z, params["w"][:1], u)
        return ops.launch("k", u)
    return body


def _synthetic(b=2):
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(7, 4, generator=gen)}
    caches = {"c": torch.randn(b, 4, generator=gen)}
    return params, caches


def _run(params, tokens, positions, caches):
    return dg.run(_body(), params, tokens, positions, caches, "cfg",
                  "kernel")




def _tokens(i, b=2):
    return (torch.arange(b)[:, None] + i) % 7, torch.arange(b) + 10 * i


def test_a_step_is_pieces_and_launches_in_turn(fake_card):
    """The capturing call: pieces and launches alternate, the empty piece
    between two back-to-back launches is dropped, each piece is replayed
    once as it is captured, and the call computes the eager step."""
    params, caches = _synthetic()
    tokens, positions = _tokens(0)
    _run(params, tokens, positions, caches)
    mine = _clone(caches)
    want = _body()(params, tokens, positions, mine, None, None)
    got = _run(params, tokens, positions, caches)
    assert torch.equal(got, want) and torch.equal(caches["c"], mine["c"])
    g = _graph_of(caches)
    kinds = ["launch" if isinstance(s, tuple) else "piece" for s in g.steps]
    assert kinds == ["piece", "launch", "piece", "launch", "launch",
                     "piece", "launch"]
    assert [s.replays for s in g.steps if not isinstance(s, tuple)] \
        == [1, 1, 1]
    assert len(_FakeGraph.made) == 5                 # two empty, dropped


def test_replays_equal_eager_steps(fake_card):
    """Steps over new tokens and positions: each replay's logits and
    caches equal the same call on cloned caches (new buffers: eager), and
    the counters split the calls eager, capture, replays."""
    params, caches = _synthetic(3)
    rises = []
    for i in range(6):
        tokens, positions = _tokens(i, 3)
        mine = _clone(caches)
        before = _counters()
        want = _run(params, tokens, positions, mine)
        assert _rise(before) == (1, 0, 0)
        before = _counters()
        got = _run(params, tokens, positions, caches)
        rises.append(_rise(before))
        assert torch.equal(got, want), i
        assert torch.equal(caches["c"], mine["c"]), i
    assert rises == [(1, 0, 0), (0, 1, 0)] + [(0, 0, 1)] * 4


def test_a_replay_launches_through_the_wrapper_in_the_kernels_place(
        fake_card):
    """A wrapper put in the kernel's place after the capture gets every
    launch of a replay, in order, each writing into the tensor the
    capture's launch returned; the graph holds aliases of the launches'
    tensors, never the cache tensor itself."""
    params, caches = _synthetic()
    tokens, positions = _tokens(0)
    for _ in range(2):
        _run(params, tokens, positions, caches)
    g = _graph_of(caches)
    captured = [s for s in g.steps if isinstance(s, tuple)]
    seen = []

    def wrapper(x, **kw):
        out = _Kernel()(x, **kw)
        seen.append((x.data_ptr(), kw))
        return out
    ops.k = wrapper
    _run(params, *_tokens(1), caches)
    assert [(x.data_ptr(), kw) for _, (x,), kw in captured] == seen
    assert all(kw["out"].data_ptr() == o.data_ptr()
               for (_, kw), o in zip(seen, [s[2]["out"] for s in captured]))
    assert seen[1][1]["scale"] == 0.5
    assert all(a is not caches["c"] for _, args, _ in captured
               for a in args)


def test_logits_returned_are_never_overwritten(fake_card):
    params, caches = _synthetic()
    outs = []
    for i in range(4):
        lg = _run(params, *_tokens(i), caches)
        outs.append((lg, lg.clone()))
    assert all(torch.equal(a, b) for a, b in outs)
    assert len({id(a) for a, _ in outs}) == 4


def test_new_buffers_start_eager(fake_card):
    params, caches = _synthetic()
    before = _counters()
    _run(params, *_tokens(0), caches)
    _run(params, *_tokens(0), _clone(caches))
    _run(params, *_tokens(0), caches)
    tokens, positions = _tokens(0)
    _run(params, tokens, positions.int(), caches)  # another dtype
    assert _rise(before) == (3, 1, 0)


def test_a_recorder_is_active_for_the_launches_and_not_in_the_pieces(
        fake_card):
    """Under an active recorder the step captures (no recorder inside a
    piece: :func:`_op` checks it) and replays, its span noted
    ``graph: "capture"`` then ``"replay"``, with the launch records of an
    eager step's launches in each; the recorder is active again after."""
    params, caches = _synthetic()
    rec = SpanRecorder()
    sid = rec.open("serve.step")
    for i in range(4):
        s = rec.open("model.decode_step")
        _run(params, *_tokens(i), caches)
        rec.close(s)
        assert spans.ACTIVE is rec
    rec.close(sid)
    steps = _step_records(rec.records())
    assert [s["attrs"] for s, _, _ in steps] \
        == [{}, {"graph": "capture"}, {"graph": "replay"},
            {"graph": "replay"}]
    assert all(got == steps[0][1] and len(got) == 4 for _, got, _ in steps)


def test_a_graph_goes_with_its_buffers(fake_card):
    """Freeing the caches drops their graph and its entry, though a
    launch of the step reads a cache tensor: the graph holds an alias."""
    gc.collect()
    seen = set(dg._ENTRIES)
    params, caches = _synthetic()
    for i in range(3):
        _run(params, *_tokens(i), caches)
    mine = set(dg._ENTRIES) - seen
    assert len(mine) == 1
    g = weakref.ref(dg._ENTRIES[next(iter(mine))].graph)
    assert g() is not None
    del caches
    gc.collect()
    assert not mine & set(dg._ENTRIES) and g() is None


def test_a_body_that_raises_mid_capture_leaves_no_split(fake_card):
    """A step that raises while it is captured ends the open piece, takes
    the hand-off back and restores the recorder; the next call captures
    again."""
    params, caches = _synthetic()
    _run(params, *_tokens(0), caches)

    def boom(x, **kw):
        raise RuntimeError("launch failed")
    ops.k = boom
    with pytest.raises(RuntimeError, match="launch failed"):
        _run(params, *_tokens(0), caches)
    assert ops.split is None and _FakeGraph.capturing is None
    assert spans.ACTIVE is None
    ops.k = _Kernel()
    before = _counters()
    _run(params, *_tokens(1), caches)
    assert _rise(before) == (0, 1, 0)


def test_launch_calls_the_module_attribute_or_hands_it_off(monkeypatch):
    """``ops.launch`` calls ``ops.<name>`` as it is at the call, and
    hands the launch to ``ops.split`` while one is set; ``ops.gemm``
    launches K1 through it on card tensors and takes the plain product
    on the CPU."""
    monkeypatch.setattr(ops, "k", lambda x, **kw: ("k", x, kw),
                        raising=False)
    assert ops.launch("k", 1, a=2) == ("k", 1, {"a": 2})
    monkeypatch.setattr(ops, "k", lambda x, **kw: ("k2", x, kw))
    assert ops.launch("k", 1, a=2) == ("k2", 1, {"a": 2})
    handed = []
    monkeypatch.setattr(ops, "split", lambda *a: handed.append(a) or "x")
    assert ops.launch("k", 1, a=2) == "x"
    assert handed == [("k", (1,), {"a": 2})]
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    assert torch.equal(ops.gemm(a, b, use_kernel=True), ref.gemm(a, b))
    assert len(handed) == 1
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    ops.gemm(a, b, use_kernel=True, out_dtype=torch.bfloat16, block_m=64)
    assert handed[1] == ("ame_gemm", (a, b),
                         {"out_dtype": torch.bfloat16, "block_m": 64})


def test_the_decode_route_hands_its_launch_to_the_split(monkeypatch):
    """The decode attention kernel is launched through ``ops.launch``
    by its name, so a capture takes it out of its pieces."""
    from repro_torch.models import attention
    cfg = get("qwen3-1.7b").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches, nxt, pos = _prefilled(cfg, params, 2, 16, "cpu")
    handed = []

    def split(name, args, kw):
        handed.append(name)
        q, k, v, kpos, qpos = args
        return attention.chunked_attention(q, k, v, causal=True,
                                           q_offset=qpos, kv_positions=kpos)
    monkeypatch.setattr(attention, "takes_decode_kernel", lambda *t: True)
    monkeypatch.setattr(ops, "split", split)
    lm.decode_step(params, nxt, pos, caches, cfg)
    assert handed == ["decode_attention"] * cfg.n_layers


def test_the_mla_decode_route_hands_its_launch_to_the_split(monkeypatch):
    """MLA's decode kernel is launched through ``ops.launch`` by its name
    too, so a capture takes it out of its pieces: once a layer, with the
    layer's latent cache."""
    from repro_torch.kernels import mla_decode as km
    from repro_torch.models import attention
    cfg = get("deepseek-v3-671b").reduced().with_policy(
        compute_dtype="bfloat16", param_dtype="bfloat16")
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches, nxt, pos = _prefilled(cfg, params, 2, 16, "cpu")
    handed = []

    def split(name, args, kw):
        handed.append((name, args[1].data_ptr()))
        return km.plain(*args)
    monkeypatch.setattr(attention, "takes_decode_kernel", lambda *t: True)
    monkeypatch.setattr(ops, "split", split)
    lm.decode_step(params, nxt, pos, caches, cfg)
    ckv = [c["ckv"][i].data_ptr() for c in caches.values()
           for i in range(c["ckv"].shape[0])]
    assert handed == [("mla_decode", p) for p in ckv]
    assert len(handed) == cfg.n_layers


def _serve(cfg, params, device, spans_after=None):
    """A reduced qwen3 served from five requests; with ``spans_after`` a
    recorder is set after that many steps."""
    srv = Server(cfg, params, slots=3, cache_len=48, backend="kernel",
                 device=device)
    rng = np.random.default_rng(0)
    for uid in range(5):
        srv.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, 6 + 4 * uid).astype(np.int32), max_new=7))
    n = 0
    while srv.queue or any(a is not None for a in srv.active):
        if n == spans_after:
            srv.spans = SpanRecorder()
        srv.step()
        n += 1
    return srv


# ---------------------------------------------------------------------------
# the capture-safety repairs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("theta,half", [(1e6, 64), (1e4, 16), (5e5, 40),
                                        (10000.0, 8)])
def test_cached_rope_frequencies_equal_the_per_call_form(theta, half):
    """Built once per (theta, half, device), bit for bit the frequencies a
    call would build; rope over a plain tensor takes them."""
    fresh = layers.rope_freq(theta, half, torch.device("cpu"))
    cached = layers.cached_rope_freq(theta, half, torch.device("cpu"))
    assert torch.equal(cached, fresh)
    assert layers.cached_rope_freq(theta, half, torch.device("cpu")) \
        is cached
    x = torch.randn(2, 3, 4, 2 * half)
    p = torch.arange(3)[None].expand(2, 3)
    assert torch.equal(layers.rope(x, p, theta),
                       layers.rope(x, p, theta, fresh))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qwen3_at_published_widths(cuda):
    """qwen3-1.7b at its published widths, 4 of its 28 layers, bf16, over
    the chat cell's 32 slots of 1,312 positions."""
    cfg = get("qwen3-1.7b").replace(n_layers=4).with_policy(
        compute_dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = lm.compute_params(lm.init(cfg, gen, device=cuda), cfg)
    return cfg, params, 32, 1312


def _deepseek_v3_at_published_widths(cuda):
    """The benchmark's DeepSeek-V3 at its published widths, its 3 dense
    layers and 1 MoE layer (8 of 256 experts held), 16 slots of 1,312."""
    import json
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    from portbench import port, weights
    cfg = json.loads((ROOT / "portbench" / "configs" / "deepseek-v3.json")
                     .read_text())
    cfg["n_layers"] = 4
    a = port.arch(cfg)
    w = weights.make(port.meta_params(a), 2718281829, cuda)
    return a, lm.compute_params(w, a), 16, 1312


def _filled_caches(cfg, b, clen, pos, cuda, gen):
    """Caches of ``b`` slots whose first ``pos[i]`` positions hold random
    keys and values (latents for MLA)."""
    caches = lm.make_caches(cfg, b, clen, cuda)
    for c in caches.values():
        for name, t in c.items():
            if name == "pos":
                j = torch.arange(clen, device=cuda)
                t[:] = torch.where(j[None, :] < pos[:, None], j, -1).to(
                    torch.int32)
            else:
                t.normal_(generator=gen)
    return caches


def _join(caches, slot, n, gen):
    """Slot ``slot`` takes a new request of ``n`` positions: its rows are
    rewritten in place, as ``Server._splice`` writes a prefill's."""
    for c in caches.values():
        for name, t in c.items():
            if name == "pos":
                j = torch.arange(t.shape[2], device=t.device)
                t[:, slot] = torch.where(j < n, j, -1).to(torch.int32)
            else:
                t[:, slot].normal_(generator=gen)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["qwen3-1.7b", "deepseek-v3"])
def test_replayed_steps_equal_eager_steps_on_the_card(cuda, model):
    """Ten decode steps at published widths, from a graph after the
    first: logits and every cache leaf ``torch.equal`` to the same call
    on cloned caches (eager).  Slots leave (token 0, position held) and
    join (rows rewritten in place, a new position), and positions cross a
    key split of the decode kernel (qwen3: splits of 146 keys at 32
    slots) or a 1,024-key chunk of MLA's attention (DeepSeek-V3)."""
    cfg, params, b, clen = (_qwen3_at_published_widths if model ==
                            "qwen3-1.7b" else
                            _deepseek_v3_at_published_widths)(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    start = 140 if model == "qwen3-1.7b" else 1018
    pos = start + torch.arange(b, device=cuda) % 8
    caches = _filled_caches(cfg, b, clen, pos, cuda, gen)
    toks = torch.randint(0, cfg.vocab_size, (b, 1), device=cuda,
                         generator=gen)
    rises = []
    with torch.no_grad():
        for i in range(10):
            if i == 3:                                   # slot 5 leaves
                left = int(pos[5])
            if i >= 3:
                toks[5], pos[5] = 0, left
            if i == 4:                                   # slot 7 joins
                _join(caches, 7, 286, gen)
                pos[7] = 286
            mine = _clone(caches)
            want, _ = lm.decode_step(params, toks, pos, mine, cfg,
                                     backend="kernel")
            before = _counters()
            got, _ = lm.decode_step(params, toks, pos, caches, cfg,
                                    backend="kernel")
            rises.append(_rise(before))
            assert torch.equal(got, want), i
            assert all(map(torch.equal, _leaves(caches), _leaves(mine))), i
            del mine
            toks, pos = got.argmax(-1)[:, None], pos + 1
    assert rises == [(1, 0, 0), (0, 1, 0)] + [(0, 0, 1)] * 8


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-370m", "zamba2-2.7b",
                                  "mixtral-8x22b", "deepseek-v3-671b",
                                  "gemma-2b"])
def test_every_family_replays_its_eager_step_on_the_card(cuda, name):
    """Reduced dense, SSM, hybrid, MoE (with a sliding window), MLA and
    gemma models in bf16: a capture and five replays after the first step
    equal the same calls on cloned caches in logits and every cache
    leaf."""
    cfg = get(name).reduced().with_policy(compute_dtype="bfloat16")
    params = lm.compute_params(lm.init(
        cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda), cfg)
    caches, nxt, pos = _prefilled(cfg, params, 3, 24, cuda)
    before = _counters()
    with torch.no_grad():
        for i in range(6):
            mine = _clone(caches)
            want, _ = lm.decode_step(params, nxt, pos, mine, cfg,
                                     backend="kernel")
            got, _ = lm.decode_step(params, nxt, pos, caches, cfg,
                                    backend="kernel")
            assert torch.equal(got, want), i
            assert all(map(torch.equal, _leaves(caches), _leaves(mine))), i
            del mine
            nxt, pos = got.argmax(-1)[:, None], pos + 1
    assert _rise(before) == (6 + 1, 1, 4)


@pytest.fixture
def reduced_bf16(cuda):
    cfg = get("qwen3-1.7b").reduced().with_policy(compute_dtype="bfloat16")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    return cfg, params


@pytest.mark.gpu
def test_a_server_serves_the_tokens_it_serves_eagerly(cuda, reduced_bf16,
                                                      monkeypatch):
    """A ``Server`` on the card: one eager step, one capture, replays for
    every later step; the same tokens as with the graph turned off."""
    cfg, params = reduced_bf16
    before = _counters()
    srv = _serve(cfg, params, cuda)
    assert _rise(before) == (1, 1, srv.decode_steps - 2)
    with monkeypatch.context() as mp:
        mp.setattr(dg, "engages", lambda ts: False)
        eager = _serve(cfg, params, cuda)
    assert {r.uid: r.out_tokens for r in srv.completed} \
        == {r.uid: r.out_tokens for r in eager.completed}
    assert len(srv.completed) == 5


@pytest.mark.gpu
def test_deleting_a_server_frees_its_graph(cuda, reduced_bf16):
    """Each server captures its own graph, and deleting it returns
    ``torch.cuda.memory_allocated`` to where the previous one left it."""
    cfg, params = reduced_bf16
    left = []
    for _ in range(3):
        before = _counters()
        srv = _serve(cfg, params, cuda)
        assert _rise(before)[1] == 1
        entries = len(dg._ENTRIES)
        del srv
        gc.collect()
        torch.cuda.synchronize()
        assert len(dg._ENTRIES) == entries - 1
        left.append(torch.cuda.memory_allocated(cuda))
    assert left[1] == left[2] <= left[0], left


@pytest.mark.gpu
def test_replays_count_every_launch_on_the_card(cuda, reduced_bf16):
    """After N replayed steps ``ame_gemm.launches`` (by variant too) and
    ``decode_attention.launches`` rose by N times an eager step's: each
    replay launches the kernels through their wrappers.  The pieces
    between back-to-back launches, where nothing is captured, are
    dropped."""
    cfg, params = reduced_bf16
    params = lm.compute_params(params, cfg)
    caches, nxt, pos = _prefilled(cfg, params, 3, 24, cuda)

    def counts():
        return (k1.launches, k1.launches_by_variant["mma"],
                k1.launches_by_variant["fma"], kd.launches)
    with torch.no_grad():
        c0 = counts()
        lm.decode_step(params, nxt, pos, caches, cfg, backend="kernel")
        step = tuple(a - b for a, b in zip(counts(), c0))
        assert step == (K1_PER_LAYER * cfg.n_layers,
                        K1_PER_LAYER * cfg.n_layers, 0, cfg.n_layers)
        c0 = counts()
        for i in range(6):
            lm.decode_step(params, nxt, pos + i, caches, cfg,
                           backend="kernel")
    assert tuple(a - b for a, b in zip(counts(), c0)) \
        == tuple(6 * n for n in step)
    g = _graph_of(caches)
    launched = [s[0] for s in g.steps if isinstance(s, tuple)]
    assert launched.count("ame_gemm") == step[0]
    assert launched.count("decode_attention") == step[3]
    assert len(g.steps) - len(launched) < len(launched)


@pytest.mark.gpu
def test_the_profiler_sees_every_counted_launch_on_the_card(cuda,
                                                            reduced_bf16):
    """``torch.profiler`` over N replayed steps finds as many K1 and
    decode attention kernels on the card as the launch counters rose by,
    N times an eager step's launches."""
    cfg, params = reduced_bf16
    params = lm.compute_params(params, cfg)
    caches, nxt, pos = _prefilled(cfg, params, 3, 24, cuda)
    with torch.no_grad():
        for i in range(2):                       # eager, then the capture
            lm.decode_step(params, nxt, pos + i, caches, cfg,
                           backend="kernel")
        torch.cuda.synchronize()
        c0 = (k1.launches, kd.launches)
        before = _counters()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(5):
                lm.decode_step(params, nxt, pos + 2 + i, caches, cfg,
                               backend="kernel")
            torch.cuda.synchronize()
    assert _rise(before) == (0, 0, 5)
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    seen = (sum("ame_gemm" in n for n in names),
            sum("decode_attention" in n for n in names))
    assert seen == (k1.launches - c0[0], kd.launches - c0[1]) \
        == (5 * K1_PER_LAYER * cfg.n_layers, 5 * cfg.n_layers)


@pytest.mark.gpu
def test_first_calls_stay_eager_and_a_recorder_takes_the_graph(
        cuda, reduced_bf16):
    """On the card: CPU tensors and a first call on new buffers run
    eagerly; a seen set captures under an active recorder too, and
    replays under it."""
    cfg, params = reduced_bf16
    params = lm.compute_params(params, cfg)
    caches, nxt, pos = _prefilled(cfg, params, 2, 24, cuda)
    with torch.no_grad():
        before = _counters()
        lm.decode_step(params, nxt, pos, caches, cfg, backend="kernel")
        assert _rise(before) == (1, 0, 0)
        rec = SpanRecorder()
        sid = rec.open("serve.step")
        for i in range(3):
            lm.decode_step(params, nxt, pos + i, caches, cfg,
                           backend="kernel")
        rec.close(sid)
        assert _rise(before) == (1, 1, 2)
        cpu = get("qwen3-1.7b").reduced()
        p = lm.init(cpu, torch.Generator().manual_seed(0), device="cpu")
        c, n, q = _prefilled(cpu, p, 2, 24, "cpu")
        for _ in range(3):
            lm.decode_step(p, n, q, c, cpu)
        assert _rise(before) == (4, 1, 2)
