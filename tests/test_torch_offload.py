"""The port's decode offload against the reference on the CPU.

Mirrors the offload tests of tests/test_residency.py, the offload half of
tests/test_kvcache.py, tests/test_moe.py and the offload's stack failover
in tests/test_faults.py.  Each scenario drives a ``DecodeOffload`` of
each package with the same arguments (the port on ``device="cpu"`` with
the reference's host constants, ``hw.PEAK_FLOPS``/``hw.HBM_BW`` of the
TPU v5e, so ``host_s`` compares): every ``StepRecord``, roofline,
ledger, command trace and MoE summary must be ``==``, and numeric
outputs bit for bit.

One exception, by design: the three error maxima of a numeric record
(``numeric_max_err``, ``logits_max_err``, ``attn_max_err``) are
``max |y_pim - y_fp32|`` against an FP32 reference that XLA and torch sum
in different orders, so they agree within :data:`ERR_TOL`, not bit for
bit (the PIM outputs ``y`` themselves are bit-exact).

The reference values of ``results/BENCH_runtime.json`` (``decode``,
``kv``, ``obs``) and the committed dump
``results/dryrun/qwen3-1.7b.decode.pim_offload.json`` are reproduced from
the port alone, with the reference's setups (benchmarks/paper_figures.py).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.faults as JF
import repro.runtime as JR
import repro.serve.offload as JO
import repro.serve.traffic as JT
import repro_torch.faults as TF
import repro_torch.runtime as TR
import repro_torch.serve.offload as TO
import repro_torch.serve.traffic as TT
from repro.configs import get as jget
from repro.launch import hw as jhw
from repro_torch.configs import get
from repro_torch.obs import MetricsRegistry, export_chrome_trace, \
    profile_report
from test_torch_runtime import BENCH, fresh_uids, norm

ROOT = Path(__file__).resolve().parents[1]
DUMP = ROOT / "results" / "dryrun" / "qwen3-1.7b.decode.pim_offload.json"
#: two FP32 references of the same FP16 operands, summed in another order,
#: put an error maximum at most this far from the other package's (the
#: sums differ by ~1e-8 at these sizes; NUMERIC_ATOL is 0.05)
ERR_TOL = 1e-6
ERR_FIELDS = ("numeric_max_err", "logits_max_err", "attn_max_err")
#: the port's offload on the CPU, priced with the reference's host
PORT_KW = {"device": "cpu", "peak_flops": jhw.PEAK_FLOPS,
           "hbm_bw": jhw.HBM_BW}
PACKAGES = {"reference": (JO, JR, JF, JT, jget, {}),
            "port": (TO, TR, TF, TT, get, PORT_KW)}


def offload_record(O, R, off, extra=None, trace=False):
    """Steps, upload, ledgers (every device's event log included), stack
    map and roofline of one offload; with ``trace=True`` also the command
    trace the events serialize to (slow at large sizes)."""
    rec = {"steps": [s.to_json() for s in off.steps],
           "upload": (off.upload_bytes, off.upload_bytes_per_stack,
                      off.weight_bytes),
           "ledgers": off.rt.stack, "stack_map": off.stack_map}
    if trace:
        rec["trace"] = R.emit_trace(off.rt.stack)
    if off.steps:
        roof = off.roofline()
        roof.pop("steps")
        rec["roofline"] = roof
    rec.update(extra or {})
    return rec


def assert_offloads_equal(ref, port):
    """Records ``==`` key by key; steps on their JSON form, with the error
    maxima within ERR_TOL."""
    assert list(ref) == list(port)
    for key in ref:
        if key == "steps":
            assert len(ref[key]) == len(port[key])
            for a, b in zip(ref[key], port[key]):
                a, b = dict(a), dict(b)
                for f in ERR_FIELDS:
                    assert abs(a.pop(f) - b.pop(f)) <= ERR_TOL, f
                assert b == a
        else:
            assert norm(port[key]) == norm(ref[key]), key


def run_both(scenario, *args):
    """``scenario`` on each package, each run from uid 1 (the stack
    failover's fault instants name tensor uids)."""
    out = []
    for pkg in PACKAGES.values():
        fresh_uids()
        out.append(scenario(*pkg, *args))
    return tuple(out)


def check(scenario, *args):
    ref, port = run_both(scenario, *args)
    assert_offloads_equal(ref, port)
    return ref, port


# ---------------------------------------------------------------------------
# analytic sidecars: serialized, async, kv, pipeline, full width
# ---------------------------------------------------------------------------

ANALYTIC = {
    "serialized 16ch": (dict(channels=16, placement="balanced"),
                        [4, 4, 1], 0),
    "serialized 1ch": (dict(channels=1), [2, 2], 0),
    "serialized 4x4 stacks": (dict(channels=4, stacks=4,
                                   placement="row-striped"), [2, 2, 2], 0),
    "async 16ch x 4 stacks": (dict(channels=16, stacks=4,
                                   placement="balanced", async_mode=True),
                              [1, 1, 4], 0),
    "async 8ch x 2 stacks, kv": (dict(channels=8, stacks=2,
                                      async_mode=True, kv_offload=True),
                                 [2, 2, 2], 2),
    "serialized kv, capacity": (dict(channels=4, kv_offload=True,
                                     kv_capacity_bytes=150_000),
                                [3, 3, 3], 3),
    "switched 2 stacks": (dict(channels=4, stacks=2,
                               link_topology="switched"), [2, 2], 0),
    "metrics": (dict(channels=8, stacks=2, async_mode=True,
                     kv_offload=True, metrics=True), [2, 2], 2),
}


def analytic_run(O, R, F, T, getc, kw, name, size, steps, nreq):
    cfg = getc("qwen3-1.7b")
    if size == "reduced":
        cfg = cfg.reduced()
    args = dict(ANALYTIC[name][0] if isinstance(name, str) else name)
    reg = None
    if args.pop("metrics", False):
        from repro.obs import MetricsRegistry as JM
        reg = JM() if O is JO else MetricsRegistry()
        args["metrics"] = reg
    off = O.DecodeOffload(cfg, **args, **kw)
    rids = [f"r{i}" for i in range(nreq)]
    for i, rid in enumerate(rids):
        off.kv_prefill(rid, 40 + 30 * i)
    for b in steps:
        if rids:
            off.step(b, request_ids=rids[:b])
        else:
            off.step(b)
    extra = {"snapshot": reg.snapshot()} if reg is not None else {}
    if off.kv is not None:
        extra["kv"] = off.kv.summary()
        for rid in rids:
            extra[f"release {rid}"] = off.kv_release(rid)
    return offload_record(O, R, off, extra)


@pytest.mark.parametrize("name", list(ANALYTIC))
def test_analytic_records_equal(name):
    args, steps, nreq = ANALYTIC[name]
    _, port = check(analytic_run, name, "reduced", steps, nreq)
    assert all(s["pim_cycles"] > 0 for s in port["steps"])


def test_analytic_records_equal_at_full_width():
    """Full-width qwen3-1.7b (28 layers, d_model 2048) as the card serves
    it: 16 channels x 4 stacks, async, KV offload, 4 live requests."""
    args = dict(channels=16, stacks=4, async_mode=True, kv_offload=True)
    _, port = check(analytic_run, args, "full", [4, 4, 4], 4)
    assert port["roofline"]["matmuls_per_step"] == 28 * 7 + 1


def pipeline_run(O, R, F, T, getc, kw, requests, steps, stacks):
    cfg = getc("qwen3-1.7b").reduced().replace(n_layers=8)
    off = O.DecodeOffload(cfg, channels=16, stacks=stacks,
                          placement="balanced", async_mode=True, **kw)
    return offload_record(O, R, off,
                          {"pipeline": off.pipeline(requests, steps)})


@pytest.mark.parametrize("requests,steps,stacks", [(1, 2, 4), (3, 1, 4),
                                                    (2, 1, 2)])
def test_pipeline_equal(requests, steps, stacks):
    check(pipeline_run, requests, steps, stacks)


def test_validation_matches_the_reference():
    cfg, jcfg = get("qwen3-1.7b").reduced(), jget("qwen3-1.7b").reduced()
    mcfg, jmcfg = get("mixtral-8x22b").reduced(), \
        jget("mixtral-8x22b").reduced()
    cases = [
        lambda O, c, m, T, kw: O.DecodeOffload(c, channels=4, **kw)
        .kv_prefill(0, 10),
        lambda O, c, m, T, kw: O.DecodeOffload(
            c, channels=4, kv_offload=True, **kw).kv_prefill(0, 0),
        lambda O, c, m, T, kw: O.DecodeOffload(
            c.replace(head_dim=256), channels=4, kv_offload=True, **kw),
        lambda O, c, m, T, kw: O.DecodeOffload(c, channels=4, **kw)
        .pipeline(1, 1),
        lambda O, c, m, T, kw: O.DecodeOffload(
            c, channels=4, async_mode=True, numeric=True, **kw)
        .pipeline(1, 1),
        lambda O, c, m, T, kw: O.DecodeOffload(
            c, channels=4, routing=T.zipf_routing(2, 4, 64), **kw),
        lambda O, c, m, T, kw: O.DecodeOffload(
            m, channels=4, stacks=2, async_mode=True,
            routing=T.zipf_routing(3, 4, 64), **kw),
        lambda O, c, m, T, kw: O.DecodeOffload(
            m, channels=4, stacks=2, routing=T.zipf_routing(2, 2, 64),
            **kw),
        lambda O, c, m, T, kw: O.DecodeOffload(
            m, channels=4, stacks=2, link_topology="mesh", **kw),
        lambda O, c, m, T, kw: O.DecodeOffload(
            get("qwen3-1.7b") if O is TO else jget("qwen3-1.7b"),
            numeric=True, **kw),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case(JO, jcfg, jmcfg, JT, {})
        with pytest.raises(ValueError):
            case(TO, cfg, mcfg, TT, PORT_KW)


def test_host_roofline_defaults_to_h100():
    off = TO.DecodeOffload(get("qwen3-1.7b").reduced(), channels=4,
                           device="cpu")
    assert (off.peak_flops, off.hbm_bw) == (989e12, 3.35e12)
    rec = off.step(1)
    host_bytes = off.weight_bytes + sum(m.in_dim * m.count * 2
                                        for m in off.matmuls)
    assert rec.host_s == max(rec.flops / 989e12, host_bytes / 3.35e12)


# ---------------------------------------------------------------------------
# numeric sidecars: outputs bit for bit
# ---------------------------------------------------------------------------


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, np.float16).view(np.int16)


#: name -> (offload arguments, batch of each step, prompt lengths of the
#: KV-offloaded requests; a page is 128 tokens, and only pages before a
#: request's last can be evicted)
NUMERIC = {
    "serialized": (dict(channels=4), [2, 1], []),
    "async 2 stacks": (dict(channels=4, stacks=2, async_mode=True), [2, 2],
                       []),
    "kv": (dict(channels=4, kv_offload=True), [1, 1], [40]),
    "kv async": (dict(channels=4, async_mode=True, kv_offload=True), [2, 2],
                 [40, 70]),
    "kv capacity": (dict(channels=4, kv_offload=True,
                         kv_capacity_bytes=200_000), [2, 2], [140, 150]),
    "kv fault": (dict(channels=4, stacks=2, kv_offload=True,
                      faults="kill channel 1 @ 1000"), [1, 1, 1], [40]),
}


def numeric_run(O, R, F, T, getc, kw, name):
    args, steps, prompts = NUMERIC[name]
    off = O.DecodeOffload(getc("qwen3-1.7b").reduced(), numeric=True,
                          **args, **kw)
    rids = ["a", "b"][:len(prompts)]
    for rid, n in zip(rids, prompts):
        off.kv_prefill(rid, n)
    for b in steps:
        off.step(b, request_ids=rids[:b] if rids else None)
    extra = {"logits": off.last_logits}
    if off.kv is not None:
        extra["kv"] = off.kv.summary()
        extra["pages"] = [off.kv.tensors(rid, ell, 0)[0].values
                          for rid in rids for ell in (0, 3)]
    if off.rt.faults is not None:
        extra["counters"] = off.rt.faults.counters
    return offload_record(O, R, off, extra, trace=True)


@pytest.mark.parametrize("name", list(NUMERIC))
def test_numeric_outputs_bit_for_bit(name):
    ref, port = run_both(numeric_run, name)
    assert_offloads_equal(ref, port)
    assert port["logits"].dtype == torch.float16
    assert np.array_equal(_bits(port["logits"]), _bits(ref["logits"]))
    for s in port["steps"]:
        assert s["numeric"] and s["numeric_max_err"] < TO.NUMERIC_ATOL
        assert s["logits_max_err"] < TO.NUMERIC_ATOL
    if "kv" in name:
        assert max(s["attn_max_err"] for s in port["steps"]) < 2e-4
    if name == "kv capacity":
        assert port["kv"]["evictions"] > 0


def test_numeric_tensors_live_on_the_runtime_device():
    off = TO.DecodeOffload(get("qwen3-1.7b").reduced(), numeric=True,
                           kv_offload=True, channels=2, device="cpu")
    off.kv_prefill(0, 20)
    off.step(1, request_ids=[0])
    assert off.last_logits.device == off.rt.device
    assert all(x.device == off.rt.device for x in off._act_cache.values())
    assert all(r.device == off.rt.device for r in TO._REF_CACHE.values()
               if r.device.type == "cpu")
    with pytest.raises(RuntimeError, match="runtime on"):
        off._on_device(torch.zeros(1, device="meta"))


def test_fp32_reference_runs_with_tf32_off():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        seen = []
        real = torch.matmul

        def spy(a, b):
            seen.append(torch.backends.cuda.matmul.allow_tf32)
            return real(a, b)
        torch.matmul = spy
        try:
            TO._fp32_matmul(torch.ones(2, 3, dtype=torch.float16),
                            torch.ones(3, 1, dtype=torch.float16))
        finally:
            torch.matmul = real
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------------------
# stack failover
# ---------------------------------------------------------------------------


def failover_run(O, R, F, T, getc, kw, async_mode):
    plan = F.FaultPlan(stack_faults=(F.StackFault(at_cycle=28529.0,
                                                  stack=3),))
    off = O.DecodeOffload(getc("qwen3-1.7b").reduced(), channels=4,
                          stacks=4, numeric=True, async_mode=async_mode,
                          faults=plan, **kw)
    fractions = [off.surviving_fraction]
    for _ in range(3):
        off.step(2)
        fractions.append(off.surviving_fraction)
    inj = off.rt.faults
    return offload_record(O, R, off, {
        "fractions": fractions, "counters": inj.counters,
        "instants": inj.instants, "logits": off.last_logits}, trace=True)


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["serialized", "async"])
def test_stack_failover_equal(async_mode):
    ref, port = run_both(failover_run, async_mode)
    assert_offloads_equal(ref, port)
    assert port["counters"]["stack_failovers"] == 1
    assert 3 not in port["stack_map"]
    assert port["fractions"][-1] == 0.75


def test_unrecoverable_when_no_survivor():
    for O, F, getc, kw in ((JO, JF, jget, {}), (TO, TF, get, PORT_KW)):
        plan = F.FaultPlan(stack_faults=(F.StackFault(at_cycle=1.0,
                                                      stack=0),))
        with pytest.raises(F.NoHealthyChannelsError):
            off = O.DecodeOffload(getc("qwen3-1.7b").reduced(), channels=2,
                                  stacks=1, faults=plan, **kw)
            off.step(1)
            off.step(1)


# ---------------------------------------------------------------------------
# routed MoE: routes, placement, migrations
# ---------------------------------------------------------------------------

MOE = {
    "greedy rep1": dict(replicate_experts=1),
    "roundrobin": dict(replicate_experts=0, expert_placement="roundrobin"),
    "migrate switched": dict(replicate_experts=1, migrate_threshold=0.05,
                             migrate_min_tokens=16,
                             link_topology="switched"),
}


def moe_run(O, R, F, T, getc, kw, name):
    cfg = getc("mixtral-8x22b").reduced()
    n_moe = cfg.n_layers - cfg.moe.first_dense_layers
    prof = T.zipf_routing(n_moe, cfg.moe.num_experts, 512, alpha=1.0,
                          seed=3)
    off = O.DecodeOffload(cfg, channels=4, stacks=2, routing=prof, **MOE[name],
                          **kw)
    off.step(4)
    off.set_routing(T.zipf_routing(n_moe, cfg.moe.num_experts, 512,
                                   alpha=1.0, seed=43))
    for _ in range(3):
        off.step(4)
    return offload_record(O, R, off, extra={
        "summary": off.moe_summary(), "counters": off.moe_counters,
        "tokens": off.tokens_per_stack, "observed": off.observed.counts,
        "placement": off._placement,
        "homes": [[[h for h, _ in bank] for bank in layer]
                  for layer in off.expert_bank],
        "migrate": [e for d in off.rt.stack for k, e in d.events
                    if k == "migrate"],
        "links": off.rt.stack.all_links()})


@pytest.mark.parametrize("name", list(MOE))
def test_moe_routes_placement_migrations_equal(name):
    _, port = check(moe_run, name)
    assert port["counters"]["routed_tokens"] > 0
    if name == "migrate switched":
        assert port["counters"]["migrations"] >= 1 and port["migrate"]


# ---------------------------------------------------------------------------
# the reference's values, from the port alone
# ---------------------------------------------------------------------------


def test_dump_equals_the_committed_artifact(tmp_path):
    """benchmarks/paper_figures.py residency_sweep: reduced qwen3-1.7b,
    16 channels, balanced, three steps of batch 4, dumped with the
    reference's host constants."""
    off = TO.DecodeOffload(get("qwen3-1.7b").reduced(), channels=16,
                           placement="balanced", **PORT_KW)
    for _ in range(3):
        rec = off.step(4)
    assert rec.reuse_bytes == off.weight_bytes
    out = tmp_path / DUMP.name
    roof = off.dump(str(out))
    assert out.read_bytes() == DUMP.read_bytes()
    assert roof == json.loads(DUMP.read_text())


def test_bench_decode_values():
    """decode_async_sweep: serialized vs async step at 4 stacks, and the
    4-request pipeline over an 8-layer variant."""
    want = json.loads(BENCH.read_text())["decode"]
    cfg = get("qwen3-1.7b").reduced()
    sync = TO.DecodeOffload(cfg, channels=16, stacks=4, placement="balanced",
                            device="cpu")
    asy = TO.DecodeOffload(cfg, channels=16, stacks=4, placement="balanced",
                           async_mode=True, device="cpu")
    sync.step(1), asy.step(1)
    rec_s, rec_a = sync.step(1), asy.step(1)
    assert (rec_s.pim_cycles, rec_a.pim_cycles) == \
        (want["serial_step_cycles"], want["async_step_cycles"])
    assert round(rec_s.pim_cycles / rec_a.pim_cycles, 6) == \
        want["decode_overlap_speedup"]
    cfg8 = cfg.replace(n_layers=8)
    p1, p4 = (TO.DecodeOffload(cfg8, channels=16, stacks=4,
                               placement="balanced", async_mode=True,
                               device="cpu").pipeline(r, 8) for r in (1, 4))
    assert (p1["makespan_cycles"], p4["makespan_cycles"]) == \
        (want["pipeline_t1_cycles"], want["pipeline_t4_cycles"])
    assert round(p1["makespan_cycles"] / p4["makespan_cycles"], 6) == \
        want["pipeline_eff_4stack"]


def test_bench_kv_values():
    """kv_sweep: an 8k-token attention step paged-resident vs streamed,
    the flat steady h2d, and the seeded eviction count."""
    want = json.loads(BENCH.read_text())["kv"]
    ctx, hd, group, nchan = 8192, 64, 4, 16
    rt = TR.PIMRuntime(channels=nchan, device="cpu")
    kv = TR.KVCacheManager(rt, n_layers=1, n_kv_heads=1, head_dim=hd,
                           channels_for_layer=lambda ell: range(nchan))
    kv.request("r")
    kv.append_tokens("r", 0, ctx)
    q = np.zeros((hd, group), np.float16)
    K, VT = kv.tensors("r", 0, 0)
    scores, r1 = rt.gemm(K, q, placement="paged", keep_output=True,
                         execute=False)
    _, r2 = rt.softmax(scores, placement="paged", execute=False)
    _, r3 = rt.gemm(VT, scores, placement="paged", execute=False)
    paged = r1.makespan_cycles + r2.makespan_cycles + r3.makespan_cycles
    rt_str = TR.PIMRuntime(channels=nchan, device="cpu")
    z = lambda *s: np.broadcast_to(np.float16(0), s)        # noqa: E731
    streamed = sum(rt_str.gemm(a, b, placement="row-striped",
                               execute=False)[1].makespan_cycles
                   for a, b in ((z(ctx, hd), q), (z(hd, ctx),
                                                  z(ctx, group))))
    assert (paged, streamed) == (want["paged_step_cycles"],
                                 want["streamed_step_cycles"])
    cfg = get("qwen3-1.7b").reduced()

    def steady_h2d(prefill):
        off = TO.DecodeOffload(cfg, channels=4, kv_offload=True,
                               device="cpu")
        off.kv_prefill(0, prefill)
        recs = [off.step(1, request_ids=[0]) for _ in range(3)]
        assert len({r.h2d_bytes for r in recs[1:]}) == 1
        return recs[-1].h2d_bytes
    assert steady_h2d(640) == steady_h2d(1280) == \
        want["steady_step_h2d_bytes"]

    def evict_run():
        off = TO.DecodeOffload(cfg, channels=4, numeric=True,
                               kv_offload=True, kv_capacity_bytes=200_000,
                               device="cpu")
        for rid in ("a", "b"):
            off.kv_prefill(rid, 260)
        for _ in range(3):
            off.step(2, request_ids=["a", "b"])
        return off.kv.summary(), [s.h2d_bytes for s in off.steps]
    ea, eb = evict_run(), evict_run()
    assert ea == eb and ea[0]["evictions"] == want["evictions"]


def test_bench_obs_values(tmp_path):
    """obs_sweep: an async 2-stack step pair exported as a Chrome trace
    and walked for its critical path."""
    want = json.loads(BENCH.read_text())["obs"]
    off = TO.DecodeOffload(get("qwen3-1.7b").reduced(), channels=16,
                           stacks=2, placement="balanced", async_mode=True,
                           device="cpu")
    off.step(1)
    off.step(1)
    trace = export_chrome_trace(off.rt, str(tmp_path / "obs.json"))
    events = trace["traceEvents"]
    tracks = {(e["pid"], e["tid"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "op"}
    s_ids = sorted(e["id"] for e in events if e.get("ph") == "s")
    assert s_ids == sorted(e["id"] for e in events if e.get("ph") == "f")
    rep = profile_report(off.rt)
    assert (rep.makespan_cycles, rep.coverage_cycles, rep.slack_cycles,
            len(events), len(tracks), len(s_ids)) == \
        (want["obs_makespan_cycles"], want["obs_coverage_cycles"],
         want["obs_slack_cycles"], want["obs_trace_events"],
         want["obs_tracks"], want["obs_flow_pairs"])
