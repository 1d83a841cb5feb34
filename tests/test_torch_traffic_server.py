"""The port's ``TrafficServer`` against the reference on the CPU.

Mirrors the ``TrafficServer`` half of tests/test_serve_traffic.py: each
scenario runs once per package on the same seeded trace, the port's
offload and host cost model priced with the reference's hardware
constants, and the port's ``latency_summary`` must be ``==`` the
reference's (every percentile, byte count and iteration count) besides
holding the reference test's own assertions.  Last, ``serve_sweep``'s
logic (benchmarks/paper_figures.py) recomputed with the port alone
reproduces the ``serve`` section of results/BENCH_runtime.json.
"""
import dataclasses
import json
import types
from pathlib import Path

import pytest

import repro.serve.traffic as JT
import repro_torch.serve.traffic as TT
from repro.configs import get as jget
from repro.launch import hw as jhw
from repro.obs import MetricsRegistry as JMetrics
from repro.runtime.trace import emit_trace as jemit_trace
from repro.serve.loop import TrafficServer as JTrafficServer
from repro.serve.offload import DecodeOffload as JDecodeOffload
from repro_torch.configs import get
from repro_torch.obs import MetricsRegistry
from repro_torch.runtime.trace import emit_trace, parse_trace
from repro_torch.serve.loop import TrafficServer
from repro_torch.serve.offload import DecodeOffload

BENCH = Path(__file__).resolve().parents[1] / "results" / "BENCH_runtime.json"
REF_HW = {"peak_flops": jhw.PEAK_FLOPS, "hbm_bw": jhw.HBM_BW}

JAX = types.SimpleNamespace(
    name="reference", get=jget, T=JT, TrafficServer=JTrafficServer,
    Metrics=JMetrics, emit_trace=jemit_trace,
    offload=lambda cfg, **kw: JDecodeOffload(cfg, **kw),
    cost=lambda cfg: JT.HostCostModel(cfg))
PORT = types.SimpleNamespace(
    name="port", get=get, T=TT, TrafficServer=TrafficServer,
    Metrics=MetricsRegistry, emit_trace=emit_trace,
    offload=lambda cfg, **kw: DecodeOffload(cfg, device="cpu", **REF_HW,
                                            **kw),
    cost=lambda cfg: TT.HostCostModel(cfg, **REF_HW))


def both(scenario):
    """``scenario(P)`` for the reference and the port; the port's result
    (a latency summary, or a tuple led by one) must equal the
    reference's.  Returns the port's."""
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    return got


def _small(P):
    return P.get("qwen3-1.7b").reduced()


def _server(P, off, **kw):
    return P.TrafficServer(off, cost=P.cost(off.cfg), **kw)


def _run(P, off, trace, **kw):
    srv = _server(P, off, **kw)
    srv.run(trace)
    return srv


def test_traffic_server_drains_and_counts():
    def scenario(P):
        reg = P.Metrics()
        tr = P.T.poisson_trace(50.0, 40, seed=2, prompt_len=64, max_new=4)
        srv = _run(P, P.offload(_small(P), channels=4), tr, slots=4,
                   chunk_tokens=32, metrics=reg)
        return srv.latency_summary(), reg.snapshot(), \
            [r.finished_at for r in srv.completed]

    s, snap, ts = both(scenario)
    assert s["requests"] == 40 and s["shed"] == 0
    assert s["tokens"] == 40 * 4
    assert s["throughput_rps"] > 0
    assert s["link_prefill_bytes"] > 0       # KV handoffs crossed the link
    assert s["link_acts_bytes"] > 0          # decode activations too
    assert all(t > 0 for t in ts)
    assert snap["serve.requests"]["value"] == 40


def test_traffic_server_seed_deterministic():
    def one(P):
        srv = _run(P, P.offload(_small(P), channels=4),
                   P.T.poisson_trace(30.0, 60, seed=6, prompt_len=64,
                                     max_new=4),
                   slots=4, chunk_tokens=32,
                   slo=P.T.SLO(ttft_s=1.0, tpot_s=0.5))
        return srv.latency_summary()

    assert one(PORT) == one(PORT)
    both(one)


@pytest.fixture(scope="module")
def balanced():
    """The benchmark's regime at full width, per package: prompts sized so
    one request's prefill work matches its decode work, the SLO and the
    capacity from one probed step of 8 slots.  The analytic step costs
    are pure functions of the batch, so the two tests share the offload
    and its probes."""
    out = {}
    for P in (JAX, PORT):
        off = P.offload(P.get("qwen3-1.7b"), channels=16)
        cost = P.cost(off.cfg)
        slots, max_new = 8, 16
        probe = off.step(slots)
        step_s = probe.pim_s
        per_tok = cost.flops_per_token / cost.peak_flops
        prompt = max(512, int(max_new * step_s / slots / per_tok))
        out[P.name] = dict(
            off=off, slots=slots, max_new=max_new, prompt=prompt,
            costs={slots: (probe.pim_s, probe.h2d_bytes)},
            slo=P.T.SLO(ttft_s=4 * cost.prefill_s(prompt),
                        tpot_s=1.3 * step_s),
            cap=1.0 / max(cost.prefill_s(prompt), max_new * step_s / slots))
    return out


def _balanced_run(P, b, trace, dis):
    return _run(P, b["off"], trace, slots=b["slots"], disaggregate=dis,
                chunk_tokens=2048, slo=b["slo"],
                step_costs=b["costs"]).latency_summary()


def test_disaggregated_beats_colocated(balanced):
    def scenario(P):
        b = balanced[P.name]
        tr = P.T.poisson_trace(0.5 * b["cap"], 80, seed=7,
                               prompt_len=b["prompt"], max_new=b["max_new"])
        return {label: _balanced_run(P, b, tr, dis)
                for label, dis in (("disagg", True), ("colo", False))}

    res = both(scenario)
    assert res["disagg"]["goodput_rps"] > res["colo"]["goodput_rps"]
    assert res["disagg"]["max_decode_gap_s"] \
        < res["colo"]["max_decode_gap_s"]


def test_bursty_goodput_no_better_than_poisson(balanced):
    def scenario(P):
        b = balanced[P.name]
        res = {}
        for label, mk in (("poisson", P.T.poisson_trace),
                          ("bursty", lambda *a, **kw: P.T.bursty_trace(
                              *a, cv=2.0, **kw))):
            tr = mk(0.55 * b["cap"], 80, seed=7, prompt_len=b["prompt"],
                    max_new=b["max_new"])
            res[label] = _balanced_run(P, b, tr, True)
        return res

    res = both(scenario)
    assert res["bursty"]["goodput_rps"] \
        <= res["poisson"]["goodput_rps"] + 1e-9
    assert res["bursty"]["slo_attainment"] \
        <= res["poisson"]["slo_attainment"] + 1e-9


def test_traffic_server_routing_observed():
    def scenario(P):
        cfg = P.get("mixtral-8x22b").reduced()
        n_moe = cfg.n_layers - cfg.moe.first_dense_layers
        prof = P.T.zipf_routing(n_moe, cfg.moe.num_experts, 256, seed=4)
        off = P.offload(cfg, channels=4, stacks=2, routing=prof,
                        replicate_experts=1)
        srv = _run(P, off, P.T.poisson_trace(20.0, 12, seed=3,
                                             prompt_len=32, max_new=3),
                   slots=2, chunk_tokens=32)
        assert srv.routing_observed is off.observed
        dense = _server(P, P.offload(_small(P), channels=4), slots=2)
        assert dense.routing_observed is None
        obs = srv.routing_observed
        return srv.latency_summary(), obs.total_tokens, \
            [list(map(int, row)) for row in obs.counts]

    _, total, _ = both(scenario)
    assert total > 0


def test_colocated_chunking_bounds_decode_stall():
    def scenario(P):
        off = P.offload(_small(P), channels=4)
        tr = P.T.poisson_trace(8.0, 40, seed=8, prompt_len=512, max_new=6)
        return {chunk: _run(P, off, tr, slots=4, disaggregate=False,
                            chunk_tokens=chunk).latency_summary()
                for chunk in (512, 64)}

    res = both(scenario)
    assert res[64]["max_decode_gap_s"] < res[512]["max_decode_gap_s"]


def test_admission_control_sheds_under_overload():
    def scenario(P):
        tr = P.T.poisson_trace(10_000.0, 80, seed=4, prompt_len=256,
                               max_new=4)
        srv = _run(P, P.offload(_small(P), channels=4), tr, slots=2,
                   max_queue=8, slo=P.T.SLO(ttft_s=1e-6, tpot_s=1e-6))
        return srv.latency_summary(), [r.uid for r in srv.shed_requests]

    s, shed = both(scenario)
    assert s["shed"] > 0
    assert s["requests"] + s["shed"] == 80
    assert len(shed) == s["shed"]
    # shed arrivals count as SLO misses from the client's side
    assert s["slo_attainment"] <= s["requests"] / 80


def test_autoscaler_grows_slots_under_queue_pressure():
    def scenario(P):
        tr = P.T.poisson_trace(5000.0, 60, seed=5, prompt_len=128,
                               max_new=4)
        srv = _run(P, P.offload(_small(P), channels=4), tr, slots=1,
                   chunk_tokens=64, autoscale=P.T.QueueProportionalSlots(
                       min_slots=1, max_slots=6, per_queue=4))
        return srv.latency_summary(), srv.slots_max_seen

    s, seen = both(scenario)
    assert 1 < seen <= 6                 # pressure grew the fleet
    assert s["requests"] == 60


def test_slo_feedback_autoscaler_reacts():
    def scenario(P):
        off = P.offload(_small(P), channels=4)
        slo = P.T.SLO(ttft_s=2 * P.cost(off.cfg).prefill_s(128), tpot_s=1.0)
        tr = P.T.poisson_trace(100.0, 50, seed=3, prompt_len=128, max_new=4)
        srv = _run(P, off, tr, slots=1, chunk_tokens=64, slo=slo,
                   autoscale=P.T.SLOFeedbackSlots(slo, min_slots=1,
                                                  max_slots=8))
        return srv.latency_summary(), srv.slots_max_seen

    s, seen = both(scenario)
    assert seen > 1
    assert s["requests"] == 50


def test_zero_traffic_additivity():
    """The traffic layer off must be byte-free: ``==`` link ledgers, h2d
    ledgers and step records, and byte-identical traces (which equal the
    reference's)."""
    def run(P, wrap: bool):
        off = P.offload(_small(P), channels=4, stacks=2)
        if wrap:
            _run(P, off, P.T.poisson_trace(1.0, 0, seed=0), slots=2)
        for _ in range(3):
            off.step(2)
        link = off.rt.stack.link
        return ((link.bytes, link.cycles, link.events, link.tl_free),
                [d.xfer.h2d_bytes for d in off.rt.stack],
                [dataclasses.asdict(s) for s in off.steps],
                P.emit_trace(off.rt.stack))

    bare, wrapped = run(PORT, False), run(PORT, True)
    assert bare == wrapped
    assert wrapped[3] == run(JAX, True)[3]


def test_traffic_link_events_land_in_cluster_trace():
    """On a multi-stack offload the handoff windows charge the cluster's
    own ledger, so they serialize into its trace and parse back."""
    def scenario(P):
        off = P.offload(_small(P), channels=4, stacks=2)
        srv = _run(P, off, P.T.poisson_trace(20.0, 8, seed=1, prompt_len=64,
                                             max_new=3),
                   slots=2, chunk_tokens=32)
        return srv.latency_summary(), list(off.rt.stack.link.events), \
            P.emit_trace(off.rt.stack)

    _, events, text = both(scenario)
    assert {"prefill", "acts"} <= {k for k, _ in events}
    assert "# HOSTLINK prefill" in text and "# HOSTLINK acts" in text
    parse_trace(text)                    # round-trips without error


def test_traffic_server_kv_lifecycle():
    """With a kv_offload sidecar the handoff/release hooks run for real:
    exact stepping is forced and resident KV returns to zero."""
    def scenario(P):
        off = P.offload(_small(P), channels=4, kv_offload=True)
        srv = _server(P, off, slots=2, chunk_tokens=32)
        assert not srv.cache_steps       # stateful KV -> exact stepping
        srv.run(P.T.poisson_trace(20.0, 6, seed=2, prompt_len=16,
                                  max_new=3))
        assert off.kv.resident_kv_bytes == 0
        assert len(off.kv._reqs) == 0
        return srv.latency_summary(), off.kv.append_bytes

    s, appended = both(scenario)
    assert s["requests"] == 6
    assert appended > 0


def test_traffic_server_rejects_async_offload():
    for P in (JAX, PORT):
        off = P.offload(_small(P), channels=4, stacks=2, async_mode=True)
        with pytest.raises(ValueError, match="async_mode=False"):
            P.TrafficServer(off)


# ---------------------------------------------------------------------------
# results/BENCH_runtime.json -> serve, from the port alone
# ---------------------------------------------------------------------------

SLOTS, MAX_NEW, CHUNK, N_REQ, SEED = 8, 16, 2048, 250, 7
MULTS = (0.25, 0.4, 0.55, 0.7, 0.85, 1.0)


def _knee(points, label):
    """Highest-goodput point with >= 0.9 attainment, else the
    best-goodput point (benchmarks/paper_figures.py:serve_sweep)."""
    ok = [p for p in points if p[label]["slo_attainment"] >= 0.9]
    return max(ok or points, key=lambda p: p[label]["goodput_rps"])


def _frontier(name):
    """One model's SLO frontier, disaggregated vs colocated, as
    ``serve_sweep`` builds it: six Poisson loads at 0.25..1.0 x the
    analytic capacity, the prompt balanced against the decode work."""
    cfg = get(name)
    off = PORT.offload(cfg, channels=16)
    cost = PORT.cost(cfg)
    probe = off.step(SLOTS)
    step_costs = {SLOTS: (probe.pim_s, probe.h2d_bytes)}
    step_s = probe.pim_s
    d_req = MAX_NEW * step_s / SLOTS
    per_tok = cost.flops_per_token / cost.peak_flops
    prompt = max(512, int(round(d_req / per_tok / 256)) * 256)
    p_req = cost.prefill_s(prompt)
    cap = 1.0 / max(p_req, d_req)
    slo = TT.SLO(ttft_s=4 * p_req, tpot_s=1.3 * step_s)
    points = []
    for mult in MULTS:
        rate = mult * cap
        tr = TT.poisson_trace(rate, N_REQ, seed=SEED, prompt_len=prompt,
                              max_new=MAX_NEW)
        pt = {"load": mult, "rate_rps": round(rate, 4)}
        for label, dis in (("disagg", True), ("colocated", False)):
            s = _run(PORT, off, tr, slots=SLOTS, disaggregate=dis,
                     chunk_tokens=CHUNK, slo=slo,
                     step_costs=step_costs).latency_summary()
            pt[label] = {
                "goodput_rps": round(s["goodput_rps"], 4),
                "throughput_rps": round(s["throughput_rps"], 4),
                "slo_attainment": round(s["slo_attainment"], 4),
                **{f"{m}_{p}_s": round(s[f"{m}_s"][p], 4)
                   for m in ("ttft", "tpot") for p in ("p50", "p99")},
            }
        points.append(pt)
    kd, kc = _knee(points, "disagg"), _knee(points, "colocated")
    gp_d = kd["disagg"]["goodput_rps"]
    gp_c = kc["colocated"]["goodput_rps"]
    return {
        "prompt_len": prompt, "max_new": MAX_NEW, "slots": SLOTS,
        "capacity_rps": round(cap, 4),
        "slo": {"ttft_s": round(slo.ttft_s, 4),
                "tpot_s": round(slo.tpot_s, 4)},
        "points": points,
        "knee": {"disagg_load": kd["load"], "colocated_load": kc["load"],
                 "disagg_goodput_rps": gp_d, "colocated_goodput_rps": gp_c,
                 "goodput_ratio": round(gp_d / max(gp_c, 1e-12), 4)},
    }, off, slo, cap, prompt


def test_serve_sweep_reproduces_bench_runtime():
    want = json.loads(BENCH.read_text())["serve"]
    frontier, ratios = {}, {}
    for name in ("qwen3-1.7b", "mixtral-8x22b"):
        frontier[name], off, slo, cap, prompt = _frontier(name)
        ratios[name] = frontier[name]["knee"]["goodput_ratio"]
        if name == "qwen3-1.7b":
            q = (off, slo, cap, prompt)
    assert frontier == want["frontier"]
    assert (ratios["qwen3-1.7b"], ratios["mixtral-8x22b"]) \
        == (1.9654, 1.8884)
    assert min(ratios.values()) == want["disagg_vs_colo_goodput"]

    # bursty cv=2 at 0.55x the qwen3 capacity, beside the Poisson point
    off, slo, cap, prompt = q
    summary = {}
    for kind, mk in (("poisson", TT.poisson_trace),
                     ("bursty", lambda *a, **kw: TT.bursty_trace(
                         *a, cv=2.0, **kw))):
        tr = mk(0.55 * cap, N_REQ, seed=SEED, prompt_len=prompt,
                max_new=MAX_NEW)
        summary[kind] = _run(PORT, off, tr, slots=SLOTS, disaggregate=True,
                             chunk_tokens=CHUNK, slo=slo).latency_summary()
    bs = summary["bursty"]
    assert {"load": 0.55, "cv": 2.0,
            "goodput_rps": round(bs["goodput_rps"], 4),
            "poisson_goodput_rps": round(summary["poisson"]["goodput_rps"],
                                         4),
            "slo_attainment": round(bs["slo_attainment"], 4),
            "ttft_p99_s": round(bs["ttft_s"]["p99"], 4)} == want["bursty"]
    assert bs["goodput_rps"] <= summary["poisson"]["goodput_rps"] + 1e-9
