"""The serve path's span recorder (``repro_torch.obs.spans``).

A reduced qwen3 is served twice on the CPU with the same requests, once
with ``Server(spans=SpanRecorder())`` and once without: the tokens, the
registry's counters and the virtual-time summary must be equal, the span
tree well formed, and every K1 product made under its block's span.  On
the CPU the kernel backend takes K1's plain version, so ``ops.gemm`` is
replaced by the plain product followed by the record that the K1
wrapper appends after a launch; the card runs the wrapper itself and
holds its records to ``ame_gemm.launches`` (``tests/test_torch_gpu.py``).
The decode attention kernel's records are held on the card here
(``gpu``-marked: one a layer under each decode step's attention spans),
and so are the records of decode steps captured into and replayed from
their CUDA graphs.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get
from repro_torch.kernels import ops, ref
from repro_torch.models import model as lm
from repro_torch.obs import MetricsRegistry, SpanRecorder, spans
from repro_torch.serve.loop import Request, Server
from repro_torch.serve.traffic import WallClock

SLOTS, CACHE_LEN = 2, 40
#: K1 projections of a qwen3 layer: q, k, v, o, gate, up, down
K1_PER_LAYER = 7


def _recording_gemm(seen):
    """``ops.gemm`` on the CPU, each kernel-backend product followed by
    the record K1's wrapper appends; ``seen`` collects
    :data:`spans.ACTIVE` at each such product."""
    def gemm(a, b, *, use_kernel=False, out_dtype=None, **blocks):
        out = ref.gemm(a, b, out_dtype=out_dtype)
        if use_kernel:
            rec = spans.ACTIVE
            seen.append(rec)
            if rec is not None:
                rec.launch("k1", a.shape[0], a.shape[1], b.shape[1],
                           a.element_size(), out.element_size())
        return out
    return gemm


def _requests(vocab):
    rng = np.random.default_rng(3)
    return [Request(uid=10 + u,
                    prompt=rng.integers(0, vocab, int(rng.choice([5, 9, 14]))
                                        ).astype(np.int32),
                    max_new=int(rng.integers(2, 7))) for u in range(5)]


def _serve(cfg, params, rec):
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "gemm", _recording_gemm(seen))
        srv = Server(cfg, params, slots=SLOTS, cache_len=CACHE_LEN,
                     backend="kernel", device="cpu",
                     metrics=MetricsRegistry(), spans=rec)
        for req in _requests(cfg.vocab_size):
            srv.submit(req)
        srv.run_until_drained()
    return srv, len(seen), seen


@pytest.fixture(scope="module")
def served():
    cfg = get("qwen3-1.7b").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    off = _serve(cfg, params, None)
    rec = SpanRecorder()
    on = _serve(cfg, params, rec)
    return cfg, off, on, rec.records()


def _counters(srv):
    return {k: v for k, v in srv.metrics.snapshot().items()
            if v["type"] == "counter"}


def test_recorder_changes_no_token_and_no_counter(served):
    _, (off, rise_off, _), (on, rise_on, _), _ = served
    assert {r.uid: r.out_tokens for r in on.completed} \
        == {r.uid: r.out_tokens for r in off.completed}
    assert len(on.completed) == 5
    assert _counters(on) == _counters(off) and _counters(on)
    assert on.latency_summary() == off.latency_summary()
    assert rise_on == rise_off > 0


def test_nothing_is_recorded_or_active_when_off(served):
    _, (off, _, seen_off), (_, _, seen_on), _ = served
    assert off.spans is None
    assert seen_off and all(a is None for a in seen_off)
    assert seen_on and all(isinstance(a, SpanRecorder) for a in seen_on)
    assert spans.ACTIVE is None


def test_span_tree_is_well_formed(served):
    cfg, _, (on, _, _), recs = served
    ss = recs["spans"]
    by_id = {s["id"]: s for s in ss}
    assert [s["id"] for s in ss] == list(range(len(ss)))
    for s in ss:
        assert s["end_ns"] is not None and s["start_ns"] <= s["end_ns"]
        if s["parent"] is None:
            assert s["name"] == "serve.step"
            continue
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    steps = [s for s in ss if s["name"] == "serve.step"]
    assert len(steps) == on._iter
    kids = {}
    for s in ss:
        kids.setdefault(s["parent"], []).append(s)
    # one admit, holding one prefill, per admission
    admits = [s for s in ss if s["name"] == "serve.admit"]
    assert len(admits) == on.prefills == 5
    for a in admits:
        assert [k["name"] for k in kids[a["id"]]] == [
            "model.prefill", "serve.splice", "serve.first_token"]
    assert sorted(a["attrs"]["uid"] for a in admits) \
        == sorted(r.uid for r in on.completed)
    # each token: the first in its admission, the rest in the steps
    # whose uids name the request
    for r in on.completed:
        got = sum(r.uid in s["attrs"].get("uids", ()) for s in steps)
        assert got == len(r.out_tokens) - 1
    assert sum(s["name"] == "serve.retire" for s in ss) == len(on.completed)
    # a decode under every step that gave a token, at the live slots'
    # positions
    blocks = ["model.attention", "model.mlp"] * cfg.n_layers
    pos = {r.uid: len(r.prompt) for r in on.completed}
    for st in steps:
        dec = [k for k in kids.get(st["id"], [])
               if k["name"] == "serve.decode"]
        uids = st["attrs"].get("uids", [])
        assert len(dec) == bool(uids)
        for d in dec:
            sub = kids[d["id"]]
            assert [k["name"] for k in sub] == ["model.decode_step",
                                                "serve.wait"]
            assert sorted(d["attrs"]["positions"]) \
                == sorted(pos[u] for u in uids)
            for u in uids:
                pos[u] += 1
            assert [k["name"] for k in kids[sub[0]["id"]]] == blocks
    for pf in (s for s in ss if s["name"] == "model.prefill"):
        assert [k["name"] for k in kids[pf["id"]]] == blocks


def _ancestor(by_id, sid, names):
    while sid is not None:
        if by_id[sid]["name"] in names:
            return by_id[sid]
        sid = by_id[sid]["parent"]
    return None


def test_k1_products_sit_in_their_block_spans(served):
    cfg, _, (on, n_on, _), recs = served
    by_id = {s["id"]: s for s in recs["spans"]}
    k1s = [ln for ln in recs["launches"] if ln["kernel"] == "k1"]
    assert len(k1s) == n_on
    assert [ln["t_ns"] for ln in k1s] == sorted(ln["t_ns"] for ln in k1s)
    per_step = {}
    for ln in k1s:
        assert by_id[ln["span"]]["name"] in ("model.attention", "model.mlp")
        top = _ancestor(by_id, ln["span"], ("model.decode_step",
                                            "model.prefill"))
        per_step[top["id"]] = per_step.get(top["id"], 0) + 1
        assert ln["in_bytes"] == ln["out_bytes"] == 4       # f32 reduced
        if top["name"] == "model.decode_step":
            assert ln["m"] == SLOTS
    steps = [s for s in recs["spans"] if s["name"] == "model.decode_step"]
    assert len(steps) == on.decode_steps
    for s in steps:
        assert per_step[s["id"]] == K1_PER_LAYER * cfg.n_layers
    shapes = [(ln["k"], ln["n"]) for ln in k1s[:K1_PER_LAYER]]
    d, hd = cfg.d_model, cfg.head_dim
    assert shapes == [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                      (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d),
                      (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]


def test_setting_the_attribute_turns_recording_on():
    cfg = get("qwen3-1.7b").reduced().replace(n_layers=1)
    params = lm.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    srv = Server(cfg, params, slots=1, cache_len=16, backend="torch",
                 device="cpu")
    srv.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                       max_new=4))
    srv.step()                          # the first two tokens, unrecorded
    srv.spans = SpanRecorder()
    srv.run_until_drained()
    names = [s["name"] for s in srv.spans.records()["spans"]]
    assert names.count("serve.step") == 2 and "serve.admit" not in names
    assert names.count("model.decode_step") == 2


def test_a_raise_closes_the_spans_and_clears_the_handle(monkeypatch):
    cfg = get("qwen3-1.7b").reduced().replace(n_layers=1)
    params = lm.init(cfg, torch.Generator().manual_seed(1), device="cpu")
    rec = SpanRecorder()
    srv = Server(cfg, params, slots=1, cache_len=16, backend="torch",
                 device="cpu", spans=rec)
    srv.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                       max_new=3))

    def broken(*args, **kw):
        rec.open("model.decode_step")
        raise RuntimeError("planted")
    monkeypatch.setattr(lm, "decode_step", broken)
    with pytest.raises(RuntimeError, match="planted"):
        srv.step()
    assert spans.ACTIVE is None
    ss = rec.records()["spans"]
    assert [s["name"] for s in ss][:2] == ["serve.step", "serve.admit"]
    assert all(s["end_ns"] is not None for s in ss)


@pytest.mark.parametrize("name,block", [("mamba2-370m", []),
                                        ("mixtral-8x22b",
                                         ["model.attention", "model.mlp"])])
def test_other_families_name_their_blocks(name, block):
    """An MoE block's feed-forward half is ``model.mlp``; a Mamba2 layer
    opens no span."""
    cfg = get(name).reduced().replace(n_layers=2)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    rec = SpanRecorder()
    sid = rec.open("serve.step")
    assert spans.ACTIVE is rec
    toks = torch.arange(1, 7).reshape(1, 6)
    lm.prefill(params, {"tokens": toks}, cfg, cache_len=12)
    rec.close(sid)
    assert spans.ACTIVE is None
    ss = rec.records()["spans"]
    assert [s["name"] for s in ss] == ["serve.step", "model.prefill"] \
        + block * 2
    assert all(s["attrs"] == {} for s in ss)


def test_launch_records_name_the_innermost_open_span():
    rec = SpanRecorder()
    top = rec.open("serve.step")
    rec.launch("k1", 1, 2, 3, 2, 2)
    sid = rec.open("model.mlp")
    rec.launch("k1", 4, 5, 6, 2, 4)
    rec.close(sid)
    assert spans.ACTIVE is rec
    rec.close(top)
    assert spans.ACTIVE is None
    got = rec.records()
    assert [(ln["kernel"], ln["span"], ln["m"], ln["k"], ln["n"],
             ln["in_bytes"], ln["out_bytes"]) for ln in got["launches"]] \
        == [("k1", top, 1, 2, 3, 2, 2), ("k1", sid, 4, 5, 6, 2, 4)]
    assert got["launches"][0]["t_ns"] <= got["spans"][sid]["start_ns"] \
        <= got["launches"][1]["t_ns"] <= got["spans"][sid]["end_ns"]
    # plain data: editing what records() returned leaves the recorder as is
    got["spans"][0]["attrs"]["x"] = 1
    assert rec.records()["spans"][0]["attrs"] == {}


def test_decode_attention_records_carry_their_fields():
    """The decode attention kernel's record names its shape: slots, KV
    heads, group size, head dim, cache length and element bytes."""
    rec = SpanRecorder()
    top = rec.open("serve.step")
    sid = rec.open("model.attention")
    rec.launch("decode_attention", 32, 8, 2, 128, 1312, 2)
    rec.close(top)
    (ln,) = rec.records()["launches"]
    assert ln == dict(kernel="decode_attention", span=sid, t_ns=ln["t_ns"],
                      b=32, hkv=8, g=2, d=128, clen=1312, in_bytes=2)


def test_span_is_the_shared_null_when_off_and_closes_on_a_raise():
    """With no recorder ``spans.span`` returns the shared ``NULL`` (bound
    to None) and ``note`` / ``record_launch`` record nothing; under one,
    a raise inside a span closes it and leaves the span around it open."""
    assert spans.ACTIVE is None
    assert spans.span("model.mlp") is spans.NULL
    assert spans.span("serve.decode", positions=[3]) is spans.NULL
    with spans.span("model.mlp") as rec:
        assert rec is None
        spans.note(x=1)
        spans.record_launch("k1", 1, 2, 3, 2, 2)
    rec = SpanRecorder()
    with rec.span("serve.step") as got:
        assert got is rec and spans.ACTIVE is rec
        with pytest.raises(RuntimeError, match="planted"):
            with spans.span("model.prefill", n=1) as inner:
                assert inner is rec
                spans.note(k=2)
                spans.record_launch("k1", 1, 2, 3, 2, 2)
                raise RuntimeError("planted")
        assert spans.ACTIVE is rec
        ss = rec.records()["spans"]
        assert ss[1]["end_ns"] is not None and ss[0]["end_ns"] is None
    assert spans.ACTIVE is None
    got = rec.records()
    assert [(s["name"], s["parent"], s["attrs"]) for s in got["spans"]] \
        == [("serve.step", None, {}), ("model.prefill", 0, {"n": 1, "k": 2})]
    assert got["spans"][0]["end_ns"] is not None
    assert [(ln["kernel"], ln["span"]) for ln in got["launches"]] \
        == [("k1", 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_decode_records_one_decode_attention_launch_a_layer(cuda):
    """A reduced bf16 qwen3 served on the card under a recorder: every
    ``model.decode_step`` holds one decode attention record a layer, each
    naming the slots and the cache, under its layer's ``model.attention``
    span in the eager first step and directly under the step in the steps
    run from its CUDA graphs (``graph`` noted, no span inside); a prefill
    holds none; the records equal the rise in the kernel's
    ``launches``."""
    from repro_torch.kernels import decode_attention as kd
    cfg = get("qwen3-1.7b").reduced().with_policy(compute_dtype="bfloat16")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    srv = Server(cfg, params, slots=SLOTS, cache_len=CACHE_LEN,
                 backend="kernel", device=cuda, spans=SpanRecorder())
    for req in _requests(cfg.vocab_size):
        srv.submit(req)
    before = kd.launches
    srv.run_until_drained()
    recs = srv.spans.records()
    by_id = {s["id"]: s for s in recs["spans"]}
    mine = [ln for ln in recs["launches"]
            if ln["kernel"] == "decode_attention"]
    assert len(mine) == kd.launches - before \
        == cfg.n_layers * srv.decode_steps > 0
    per = {}
    for ln in mine:
        span = by_id[ln["span"]]
        if span["name"] == "model.attention":
            top = by_id[span["parent"]]
            assert top["attrs"] == {}
        else:
            top = span
            assert top["attrs"]["graph"] in ("capture", "replay")
        assert top["name"] == "model.decode_step"
        per[top["id"]] = per.get(top["id"], 0) + 1
        assert (ln["b"], ln["hkv"], ln["g"], ln["d"], ln["clen"],
                ln["in_bytes"]) == (SLOTS, cfg.n_kv_heads,
                                    cfg.n_heads // cfg.n_kv_heads,
                                    cfg.head_dim_, CACHE_LEN, 2)
    steps = [s for s in recs["spans"] if s["name"] == "model.decode_step"]
    assert len(steps) == srv.decode_steps
    assert all(per.get(s["id"]) == cfg.n_layers for s in steps)
    assert [s["attrs"].get("graph") for s in steps[:3]] \
        == [None, "capture", "replay"]


def _step_records(recs):
    """Each ``model.decode_step`` span with the launch records made under
    it (kernel and fields, in launch order) and whether a span lies
    inside it."""
    parent = {s["id"]: s["parent"] for s in recs["spans"]}
    tops = {s["id"]: s for s in recs["spans"]
            if s["name"] == "model.decode_step"}
    mine = {sid: [] for sid in tops}
    for ln in recs["launches"]:
        at = ln["span"]
        while at is not None and at not in tops:
            at = parent[at]
        if at is not None:
            mine[at].append((ln["kernel"],) + tuple(
                ln[f] for f in spans.LAUNCH_FIELDS[ln["kernel"]]))
    inner = {parent[s["id"]] for s in recs["spans"]}
    return [(tops[sid], mine[sid], sid in inner) for sid in tops]


@pytest.mark.gpu
def test_card_graph_steps_carry_their_launch_records(cuda, monkeypatch):
    """A reduced bf16 qwen3 served on the card under a recorder, with its
    decode steps' graphs (the first step eager, the second captures, the
    rest replay) and without (every step eager): the same tokens; the
    capturing and replaying ``model.decode_step`` spans carry ``graph:
    "capture"`` and ``"replay"``, no span inside them, and the K1 and
    decode attention records of an eager step, equal in count, order and
    shape."""
    from repro_torch.models import decode_graph as dg
    cfg = get("qwen3-1.7b").reduced().with_policy(compute_dtype="bfloat16")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    served = []
    for graphs in (True, False):
        with monkeypatch.context() as mp:
            if not graphs:
                mp.setattr(dg, "engages", lambda ts: False)
            srv = Server(cfg, params, slots=SLOTS, cache_len=CACHE_LEN,
                         backend="kernel", device=cuda,
                         spans=SpanRecorder())
            for req in _requests(cfg.vocab_size):
                srv.submit(req)
            while srv.queue or any(a is not None for a in srv.active):
                srv.step()
        served.append(srv)
    graph, eager = served
    assert {r.uid: r.out_tokens for r in graph.completed} \
        == {r.uid: r.out_tokens for r in eager.completed}
    mine = _step_records(graph.spans.records())
    steps = _step_records(eager.spans.records())
    assert len(mine) == graph.decode_steps == eager.decode_steps > 2
    assert all(s["attrs"] == {} and inner for s, _, inner in steps)
    assert mine[0][0]["attrs"] == {} and mine[0][2]
    want = steps[0][1]
    assert len(want) == (K1_PER_LAYER + 1) * cfg.n_layers
    assert [k for k, *_ in want].count("decode_attention") == cfg.n_layers
    assert [s["attrs"] for s, _, _ in mine[1:]] \
        == [{"graph": "capture"}] + [{"graph": "replay"}] * (len(mine) - 2)
    for s, got, inner in mine[1:]:
        assert got == want and not inner
    assert spans.ACTIVE is None


def _span(i, parent, name, s, e):
    return dict(id=i, parent=parent, name=name, start_ns=s, end_ns=e,
                attrs={})


def test_innermost_partition_worked_by_hand():
    ss = [_span(0, None, "serve.step", 0, 100),
          _span(1, 0, "serve.decode", 10, 90),
          _span(2, 1, "model.decode_step", 10, 60),
          _span(3, 2, "model.attention", 20, 30),
          _span(4, 2, "model.mlp", 30, 50),
          _span(5, 1, "serve.wait", 60, 90),
          _span(6, None, "serve.step", 120, 130),
          _span(7, 6, "serve.decode", 125, 130)]   # a child at its end
    idle = [(-5, 15), (25, 35), (40, 70), (95, 125), (128, 140)]
    got = spans.innermost(ss, idle)
    want = {
        None: 5 + 20 + 10,                        # -5..0, 100..120, 130..140
        "serve.step": 10 + 5 + 5,                 # 0..10, 95..100, 120..125
        "serve.step/serve.decode/model.decode_step": 5 + 10,
        "serve.step/serve.decode/model.decode_step/model.attention": 5,
        "serve.step/serve.decode/model.decode_step/model.mlp": 5 + 10,
        "serve.step/serve.decode/serve.wait": 10,
        "serve.step/serve.decode": 2,             # 128..130
    }
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(sum(e - s for s, e in idle))
    # an open span and a span of no length change nothing
    assert spans.innermost(ss + [_span(8, 3, "serve.splice", 25, 25),
                                 _span(9, None, "x", 140, None)], idle) \
        == pytest.approx(want)
    assert spans.innermost([], [(0, 3)]) == {None: 3}


def test_clock_anchors_map_unix_time_onto_the_span_clock():
    assert spans.unix_to_perf_ns([(100, 1000)], 1500) == 600
    anchors = [(100, 1000), (2100, 3000)]
    assert spans.unix_to_perf_ns(anchors, 2000) == 1100
    rec = SpanRecorder()
    a = rec.records()["anchors"]
    assert len(a) == 2 and a[0][0] <= a[1][0]
    # the two clocks read back to back agree to well under a millisecond
    p, u = spans.clock_anchor()
    assert abs(spans.unix_to_perf_ns(a, u) - p) < 5e6


def test_wall_clock_reads_perf_counter():
    t = time.perf_counter()
    assert t <= WallClock().now <= time.perf_counter()
    assert WallClock().advance(1e6) <= time.perf_counter()


# -- the sigmoid-routed MoE's counters (DeepSeek-V3) -------------------------


def _ds_serve(rec, routes=None):
    """The small DeepSeek-V3-shaped model of ``test_torch_deepseek_v3``
    served on the CPU (kernel backend, K1 records as above); with
    ``routes`` each ``route_sigmoid`` call's choices are kept, with the
    live slots of the decode step it ran in (None in a prefill)."""
    import test_torch_deepseek_v3 as ds

    from portbench import port, weights
    from repro_torch.models import moe
    cfg = ds.small_cfg()
    a = port.arch(cfg)
    w = weights.make(port.meta_params(a), 5, "cpu")
    box = {"live": None}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "gemm", _recording_gemm([]))
        if routes is not None:
            route, step = moe.route_sigmoid, lm.decode_step

            def keep_route(*args):
                out = route(*args)
                routes.append((out[1], box["live"]))
                return out

            def keep_step(*args, **kw):
                box["live"] = [i for i in range(srv.slots)
                               if srv.active[i] is not None]
                try:
                    return step(*args, **kw)
                finally:
                    box["live"] = None
            mp.setattr(moe, "route_sigmoid", keep_route)
            mp.setattr(lm, "decode_step", keep_step)
        srv = Server(a, w, slots=3, cache_len=CACHE_LEN, backend="kernel",
                     device="cpu", spans=rec)
        for req in _requests(cfg["vocab_size"]):
            srv.submit(req)
        srv.run_until_drained()
    return cfg, srv


def test_moe_recorder_changes_no_token():
    _, off = _ds_serve(None)
    _, on = _ds_serve(SpanRecorder())
    assert {r.uid: r.out_tokens for r in on.completed} \
        == {r.uid: r.out_tokens for r in off.completed}
    assert len(on.completed) == 5 and spans.ACTIVE is None


def test_moe_counters_recount_the_live_rows_choices():
    """``routed`` summed over a decode step's MoE layers is the (live row,
    choice) pairs that landed on a held expert, and ``held_reached`` each
    layer's held experts that a live row chose, by a plain recount of the
    routing's choices; in a prefill every row counts."""
    routes = []
    cfg, srv = _ds_serve(SpanRecorder(), routes)
    mo = cfg["moe"]
    lo, hi = mo["held_from"], mo["held_from"] + mo["held"]
    recs = srv.spans.records()
    ss = recs["spans"]
    by_id = {s["id"]: s for s in ss}
    experts = [s for s in ss if s["name"] == "model.experts"]
    assert len(experts) == len(routes) \
        == (srv.decode_steps + srv.prefills) * (cfg["n_layers"] - 3)
    per_step, want_step = {}, {}
    for s, (idx, live) in zip(experts, routes):
        assert by_id[s["parent"]]["name"] == "model.mlp"
        rows = idx if live is None else idx[live]
        held = [[int(e) for e in r if lo <= e < hi] for r in rows.tolist()]
        assert s["attrs"]["routed"] == sum(map(len, held))
        assert s["attrs"]["held_reached"] == len({e for r in held
                                                  for e in r})
        top = by_id[s["parent"]]
        while top["name"] not in ("model.decode_step", "model.prefill"):
            top = by_id[top["parent"]]
        per_step[top["id"]] = per_step.get(top["id"], 0) \
            + s["attrs"]["routed"]
        want_step[top["id"]] = want_step.get(top["id"], 0) \
            + sum(map(len, held))
    assert per_step == want_step and sum(per_step.values()) > 0
    # empty slots were decoded too, and are left out of the count
    assert any(live is not None and len(live) < srv.slots
               for _, live in routes)
    # the K1 products of the held experts sit in the span
    k1 = [ln for ln in recs["launches"]
          if by_id[ln["span"]]["name"] == "model.experts"]
    assert k1 and all((ln["k"], ln["n"]) in {(64, 32), (32, 64)}
                      for ln in k1)


def test_moe_hooks_cost_one_none_test_when_off(monkeypatch):
    """Off, the MoE's hook is one ``is None`` test: the counters are never
    computed."""
    from repro_torch.models import moe

    def boom(*a, **k):
        raise AssertionError("counted with no recorder")
    monkeypatch.setattr(moe, "_count", boom)
    _, srv = _ds_serve(None)
    assert len(srv.completed) == 5


def test_serve_spans_prints_the_moe_counters():
    """``tools/serve_spans.py``'s ``experts`` reading: each MoE layer's
    counters a decode step, beside the family file's expectation."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / "serve_spans.py"
    spec = importlib.util.spec_from_file_location("serve_spans", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cfg, srv = _ds_serve(SpanRecorder())
    got = tool.expert_counts(srv.spans.records(), cfg)
    assert got["layer_steps"] == srv.decode_steps * (cfg["n_layers"] - 3)
    assert got["routed_per_live_row_even"] == 4 * 4 / 16
    assert 0 < got["held_reached"] <= 4
    assert 0 < got["held_reached_expected"] <= 4
    assert tool.expert_counts({"spans": []}, cfg) is None
