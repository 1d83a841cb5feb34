"""The port's fault injection against the reference on the CPU.

Mirrors tests/test_faults.py (the runtime half; the offload's stack
failover is in test_torch_offload.py and the serve faults in
test_torch_serve.py).  Each scenario is one op sequence under one fault
plan, written once against a pair of packages (runtime, faults) and run
on the reference and on the port (``device="cpu"``); the reports,
per-channel and host-link ledgers, command traces, Chrome traces, the
injector's counters, failed set and instants must be ``==`` (outputs bit
for bit), with the harness of test_torch_runtime.py.
"""
import dataclasses
import json

import numpy as np
import pytest

import repro.faults as JF
import repro.obs as JO
import repro.runtime as JR
import repro_torch.faults as TF
import repro_torch.obs as TO
import repro_torch.runtime as TR
from test_torch_runtime import assert_records_equal, fresh_uids, norm, rand

#: (runtime package, faults package, obs package, runtime keywords)
PACKAGES = {"reference": (JR, JF, JO, {}),
            "port": (TR, TF, TO, {"device": "cpu"})}


def run_both(scenario, *args):
    """``scenario`` on each package, each run from uid 1 (fault instants
    and lost sets name tensor uids)."""
    out = []
    for pkg in PACKAGES.values():
        fresh_uids()
        out.append(scenario(*pkg, *args))
    return tuple(out)


def check(scenario, *args):
    assert_records_equal(*run_both(scenario, *args))


def injector_record(rt):
    inj = rt.faults
    return {"counters": inj.counters, "failed": sorted(inj.failed),
            "instants": inj.instants, "summary": inj.summary(),
            "lost": sorted(inj.lost_uids)}


# ---------------------------------------------------------------------------
# the plan DSL
# ---------------------------------------------------------------------------

DSL = [
    "",
    "kill channel 3 @ 1000",
    "kill ch 0 @ 1; kill stack 1 @ 2e6",
    "flaky link p=0.01 backoff=32 retries=4 cap=1024",
    "flaky link p=0.7",
    "slow link x2.5 @ 100:900",
    "fail slot 0 @ iter 5",
    """
        # a full scenario
        kill channel 3 @ 1000
        kill stack 1 @ 2e6
        flaky link p=0.01 backoff=32 retries=4 cap=1024
        slow link x2.5 @ 100:900
        slow link x3 @ 1000:2000
        fail slot 0 @ iter 5
        fail slot 1 @ iter 2
    """,
]


def _plan_fields(plan):
    return (type(plan).__name__, dataclasses.asdict(plan), plan.empty)


@pytest.mark.parametrize("text", DSL)
@pytest.mark.parametrize("seed", [0, 42])
def test_dsl_parses_field_by_field(text, seed):
    want = JF.FaultPlan.parse(text, seed=seed)
    got = TF.FaultPlan.parse(text, seed=seed)
    assert _plan_fields(got) == _plan_fields(want)
    assert _plan_fields(TF.as_plan(text)) == _plan_fields(JF.as_plan(text))


@pytest.mark.parametrize("text", [
    "explode everything @ 5",
    "flaky link p=0.5; flaky link p=0.6",
    "kill channel @ 3",
    "slow link x2 @ 5",
])
def test_dsl_rejects_what_the_reference_rejects(text):
    with pytest.raises(ValueError):
        JF.FaultPlan.parse(text)
    with pytest.raises(ValueError):
        TF.FaultPlan.parse(text)


def test_as_plan_coerces_and_rejects():
    p = TF.FaultPlan()
    assert TF.as_plan(p) is p
    with pytest.raises(TypeError):
        TF.as_plan(123)


# ---------------------------------------------------------------------------
# same-seed ledgers under every kind of plan
# ---------------------------------------------------------------------------

PLANS = {
    "empty": "",
    "kill channel": "kill channel 1 @ 0",
    "kill channel mid-run": "kill channel 5 @ 3000",
    "kill stack": "kill stack 1 @ 10",
    "flaky link": "flaky link p=0.7 backoff=64 retries=6 cap=512",
    "slow link": "slow link x2 @ 0:1e12",
    "slow link window": "slow link x4 @ 200:1500",
    "everything": ("kill channel 2 @ 500; flaky link p=0.5; "
                   "slow link x1.5 @ 0:4000"),
}


def plan_workload(R, F, O, kw, text, async_mode):
    """Place, GEMV, GEMM (kept output) and element-wise on a 2 x 4
    cluster under one plan, numeric, with a profiler or the timeline as
    the op log."""
    rng = np.random.default_rng(5)
    plan = F.FaultPlan.parse(text, seed=11)
    rt = R.PIMRuntime(channels=4, stacks=2, faults=plan,
                      async_mode=async_mode, profile=not async_mode, **kw)
    rec = {}
    w = rt.place(rand(rng, 1024, 64), placement="row-striped", other_dim=1)
    for i in range(3):
        rec[f"gemv{i}"] = rt.gemv(w, rand(rng, 64),
                                  placement="row-striped")
    res = rt.gemm(rand(rng, 1024, 32), rand(rng, 32, 8),
                  placement="row-striped", keep_output=True)
    kept = res.result if async_mode else res[0]
    rec["kept"] = (kept, kept.pending_d2h)
    rec["ew"] = rt.elementwise("add", rand(rng, 256, 8), rand(rng, 256, 8),
                               placement="balanced")
    rec["to_host"] = kept.to_host()
    rec["ledgers"] = rt.stack
    rec["trace"] = R.emit_trace(rt.stack)
    rec["chrome"] = json.dumps(O.chrome_trace(rt), sort_keys=True)
    rec["injector"] = injector_record(rt)
    return rec


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["serialized", "async"])
@pytest.mark.parametrize("name", list(PLANS))
def test_same_seed_ledgers_under_each_plan(name, async_mode):
    check(plan_workload, PLANS[name], async_mode)


def replay_scenario(R, F, O, kw):
    """A kept output whose home stack dies before it is drained: its
    shards replay onto survivors and to_host still returns it."""
    rng = np.random.default_rng(3)
    plan = F.FaultPlan(stack_faults=(F.StackFault(at_cycle=5000.0,
                                                  stack=1),))
    rt = R.PIMRuntime(channels=4, stacks=2, faults=plan, **kw)
    a, b = rand(rng, 2048, 64, scale=0.1), rand(rng, 64, 8, scale=0.1)
    oh = rt.gemm(a, b, placement="row-striped", keep_output=True)[0]
    rt.gemm(a, b, placement="row-striped", execute=False)   # fires fault
    return {"pending": oh.pending_d2h, "out": oh.to_host(),
            "ledgers": rt.stack, "trace": R.emit_trace(rt.stack),
            "injector": injector_record(rt)}


def test_pinned_output_replays_onto_survivor():
    ref, port = run_both(replay_scenario)
    assert_records_equal(ref, port)
    assert {c for c, _ in port["pending"]} <= {0, 1, 2, 3}
    assert port["injector"]["counters"]["replayed_outputs"] == 4


def reship_scenario(R, F, O, kw):
    """A stack fault wipes residency; the next use re-ships it as
    ``reupload`` link traffic with ``# RECOVER`` markers."""
    plan = F.FaultPlan(stack_faults=(F.StackFault(at_cycle=10.0, stack=1),))
    rt = R.PIMRuntime(channels=4, stacks=2, faults=plan, **kw)
    h = rt.place((2048, 128), placement="row-striped", other_dim=1)
    x = np.zeros(128, np.float16)
    reps = [rt.gemv(h, x, placement="row-striped", execute=False)[1]
            for _ in range(2)]
    trace = R.emit_trace(rt.stack)
    st = R.parse_trace(trace)
    return {"reports": reps, "ledgers": rt.stack, "trace": trace,
            "fault_channels": st.fault_channels,
            "recover_bytes": dict(st.recover_bytes),
            "injector": injector_record(rt)}


def test_lost_residency_reships_as_reupload():
    ref, port = run_both(reship_scenario)
    assert_records_equal(ref, port)
    assert set(port["fault_channels"]) == {4, 5, 6, 7}
    assert sum(port["recover_bytes"].values()) == \
        port["injector"]["counters"]["reupload_bytes"]


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["serialized", "async"])
def test_empty_plan_is_strictly_additive(async_mode):
    """An attached empty plan leaves ledgers ``==`` and traces
    byte-identical to a run without one, in the port as in the
    reference."""
    def run(faults):
        rt = TR.PIMRuntime(channels=4, stacks=2, faults=faults,
                           async_mode=async_mode, device="cpu")
        rng = np.random.default_rng(1)
        w = rt.place(rand(rng, 512, 64), placement="balanced")
        for _ in range(2):
            rt.gemv(w, rand(rng, 64), placement="balanced")
        return norm(rt.stack), TR.emit_trace(rt.stack)
    assert run(TF.FaultPlan()) == run(None) == run("")


# ---------------------------------------------------------------------------
# unrecoverable conditions
# ---------------------------------------------------------------------------

RAISES = [
    # every channel of a single stack, during the op
    lambda R, kw: R.PIMRuntime(channels=2, faults="kill stack 0 @ 0",
                               **kw).gemm(np.zeros((64, 32), np.float16),
                                          np.zeros((32, 8), np.float16)),
    # an explicit subset whose channels all failed
    lambda R, kw: R.PIMRuntime(channels=4, faults="kill ch 1 @ 0; "
                               "kill ch 2 @ 0", **kw).gemm(
        np.zeros((64, 32), np.float16), np.zeros((32, 8), np.float16),
        channels=(1, 2)),
]


@pytest.mark.parametrize("case", range(len(RAISES)))
def test_no_healthy_channels_where_the_reference_raises(case):
    with pytest.raises(JF.NoHealthyChannelsError):
        RAISES[case](JR, {})
    with pytest.raises(TF.NoHealthyChannelsError):
        RAISES[case](TR, {"device": "cpu"})


def test_out_of_range_faults_rejected_at_construction():
    for text in ("kill channel 8 @ 0", "kill stack 2 @ 0"):
        with pytest.raises(ValueError):
            JR.PIMRuntime(channels=4, stacks=2, faults=text)
        with pytest.raises(ValueError):
            TR.PIMRuntime(channels=4, stacks=2, faults=text, device="cpu")


def test_explicit_subset_remaps_to_survivors():
    def run(R, F, O, kw):
        rt = R.PIMRuntime(channels=4, faults="kill channel 1 @ 0", **kw)
        _, rep = rt.gemm(np.zeros((256, 64), np.float16),
                         np.zeros((64, 8), np.float16), channels=(0, 1, 2),
                         execute=False)
        return {"report": rep, "channels": [c.channel
                                            for c in rep.per_channel]}
    ref, port = run_both(run)
    assert_records_equal(ref, port)
    assert port["channels"] == [0, 2] and \
        port["report"].failed_channels == (1,)


# ---------------------------------------------------------------------------
# observability of faults
# ---------------------------------------------------------------------------


def test_fault_counters_mirror_into_metrics_registry():
    def run(R, F, O, kw):
        reg = O.MetricsRegistry()
        rt = R.PIMRuntime(channels=4, stacks=2, metrics=reg,
                          faults="kill channel 0 @ 0; flaky link p=0.8",
                          **kw)
        h = rt.place((1024, 256), placement="row-striped", other_dim=1)
        rt.gemv(h, np.zeros(256, np.float16), placement="row-striped",
                execute=False)
        return {"snapshot": reg.snapshot(), "catalog": reg.catalog(),
                "injector": injector_record(rt)}
    ref, port = run_both(run)
    assert_records_equal(ref, port)
    assert port["snapshot"]["faults.channel_failures"]["value"] == 1


def test_degradation_ratio_matches_bench():
    """results/BENCH_runtime.json ``faults.degradation_ratio``: one of 16
    channels dead before a 30720 x 256 x 256 row-striped GEMM (the
    reference's faults_sweep)."""
    from test_torch_runtime import BENCH
    want = json.loads(BENCH.read_text())["faults"]
    m, k, n = 30720, 256, 256
    a = np.broadcast_to(np.float16(0), (m, k))
    b = np.broadcast_to(np.float16(0), (k, n))
    _, ideal = TR.PIMRuntime(channels=16, device="cpu").gemm(
        a, b, placement="row-striped", execute=False)
    rt = TR.PIMRuntime(channels=16, faults="kill channel 0 @ 0",
                       device="cpu")
    _, deg = rt.gemm(a, b, placement="row-striped", execute=False)
    ratio = deg.cluster_makespan_cycles / ideal.cluster_makespan_cycles
    assert round(ratio, 6) == want["degradation_ratio"]
    assert deg.failed_channels == (0,)
