"""The port's traffic layer against the reference on the CPU.

Mirrors the traffic half of tests/test_serve_traffic.py and the routing
and placement half of tests/test_moe.py: the same seeds give ``==``
arrival traces (and the same JSON bytes), routing profiles, drifts and
expert placements, and the SLO and the three slot autoscalers take the
same decisions in both packages.
"""
import dataclasses
import itertools

import numpy as np
import pytest

import repro.serve.traffic as JT
import repro.sharding.rules as JRules
import repro_torch.serve.traffic as TT
import repro_torch.sharding.rules as TRules
from repro.configs import get as jget
from repro_torch.configs import get


def trace_fields(tr):
    return ([dataclasses.asdict(r) for r in tr.requests], tr.meta,
            tr.duration_s, tr.arrival_rate_rps, len(tr))


TRACES = [
    ("poisson", dict(rate_rps=10.0, n=200, seed=3)),
    ("poisson", dict(rate_rps=2.0, n=64, seed=5, prompt_len=(16, 64),
                     max_new=(4, 8))),
    ("poisson", dict(rate_rps=0.5, n=1, seed=0)),
    ("bursty", dict(rate_rps=5.0, n=500, cv=3.0, seed=1)),
    ("bursty", dict(rate_rps=3.0, n=32, cv=2.0, seed=9,
                    prompt_len=(8, 16))),
    ("bursty", dict(rate_rps=1.0, n=16, cv=0.5, seed=2, max_new=(1, 64))),
]


@pytest.mark.parametrize("kind,kw", TRACES)
def test_seeded_traces_equal(kind, kw, tmp_path):
    kw = dict(kw)
    rate, n = kw.pop("rate_rps"), kw.pop("n")
    want = getattr(JT, f"{kind}_trace")(rate, n, **kw)
    got = getattr(TT, f"{kind}_trace")(rate, n, **kw)
    assert trace_fields(got) == trace_fields(want)
    paths = [tmp_path / "ref.json", tmp_path / "port.json"]
    want.save(str(paths[0]))
    got.save(str(paths[1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert TT.Trace.load(str(paths[0])) == got


@pytest.mark.parametrize("call", [
    lambda T: T.poisson_trace(0.0, 4),
    lambda T: T.bursty_trace(1.0, 4, cv=-1.0),
    lambda T: T.bursty_trace(-1.0, 4),
])
def test_trace_validation_matches(call):
    with pytest.raises(ValueError):
        call(JT)
    with pytest.raises(ValueError):
        call(TT)


def profile_fields(p):
    return (p.n_layers, p.n_experts, p.counts, p.meta, p.total_tokens,
            [p.probs(i) for i in range(p.n_layers)], p.expert_mass())


ROUTINGS = [
    ("zipf", (4, 8, 1000), dict(alpha=1.0, seed=5)),
    ("zipf", (6, 8, 4000), dict(alpha=1.0, seed=1)),
    ("zipf", (3, 4, 256), dict(alpha=0.0, seed=9)),
    ("zipf", (55, 8, 4096), dict(alpha=1.0, seed=3)),
    ("uniform", (4, 8, 1000), dict(seed=5)),
    ("uniform", (6, 8, 4000), dict(seed=1)),
]


@pytest.mark.parametrize("kind,args,kw", ROUTINGS)
def test_routing_profiles_equal(kind, args, kw, tmp_path):
    want = getattr(JT, f"{kind}_routing")(*args, **kw)
    got = getattr(TT, f"{kind}_routing")(*args, **kw)
    assert profile_fields(got) == profile_fields(want)
    paths = [tmp_path / "ref.json", tmp_path / "port.json"]
    want.save(str(paths[0]))
    got.save(str(paths[1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert profile_fields(TT.RoutingProfile.load(str(paths[0]))) == \
        profile_fields(got)


def test_routing_drift_equal():
    profiles = {}
    for T in (JT, TT):
        ps = [T.zipf_routing(4, 8, 512, alpha=a, seed=s)
              for a, s in ((1.0, 3), (1.0, 43), (0.5, 3))]
        ps += [T.uniform_routing(4, 8, 512, seed=3),
               T.RoutingProfile.empty(4, 8),
               T.RoutingProfile(4, 8, [[8] + [0] * 7] * 4)]
        rec = ps[-2].copy()
        rec.record(0, 1, 3)
        rec.record_counts(2, {1: 1, 5: 4})
        ps.append(rec)
        profiles[T] = ([a.drift(b) for a, b in itertools.product(ps, ps)],
                       profile_fields(rec))
    assert profiles[TT] == profiles[JT]
    with pytest.raises(ValueError):
        TT.RoutingProfile(2, 2, [[1, 2]])
    with pytest.raises(ValueError):
        TT.RoutingProfile.empty(1, 2).drift(TT.RoutingProfile.empty(1, 3))


@pytest.mark.parametrize("policy", ["greedy", "roundrobin"])
@pytest.mark.parametrize("replicate", [0, 2, 4])
@pytest.mark.parametrize("stacks", [1, 2, 4])
def test_expert_placement_equal(policy, replicate, stacks):
    want = JRules.ame_pim_expert_placement(
        JT.zipf_routing(55, 8, 4096, seed=3), stacks, replicate=replicate,
        policy=policy)
    got = TRules.ame_pim_expert_placement(
        TT.zipf_routing(55, 8, 4096, seed=3), stacks, replicate=replicate,
        policy=policy)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.max_over_mean, got.worst_layer_max_over_mean) == \
        (want.max_over_mean, want.worst_layer_max_over_mean)


@pytest.mark.parametrize("name,profiled", [
    ("qwen3-1.7b", False), ("mixtral-8x22b", False),
    ("mixtral-8x22b", True)])
@pytest.mark.parametrize("stacks", [1, 3, 4])
def test_stack_map_equal(name, stacks, profiled):
    cfg, jcfg = get(name), jget(name)
    if profiled:
        n_moe = cfg.n_layers - cfg.moe.first_dense_layers
        want = JRules.ame_pim_stack_map(
            jcfg, stacks, profile=JT.zipf_routing(n_moe, 8, 512, seed=1),
            replicate=2)
        got = TRules.ame_pim_stack_map(
            cfg, stacks, profile=TT.zipf_routing(n_moe, 8, 512, seed=1),
            replicate=2)
    else:
        want = JRules.ame_pim_stack_map(jcfg, stacks)
        got = TRules.ame_pim_stack_map(cfg, stacks)
    conv = lambda m: {k: dataclasses.asdict(v)               # noqa: E731
                      if dataclasses.is_dataclass(v) else v
                      for k, v in m.items()}
    assert conv(got) == conv(want)
    assert TRules.ame_pim_layer_stacks(7, stacks) == \
        JRules.ame_pim_layer_stacks(7, stacks)


def test_placement_validation_matches():
    p = TT.zipf_routing(2, 4, 64, seed=0)
    for call in (lambda: TRules.ame_pim_expert_placement(p, 0),
                 lambda: TRules.ame_pim_expert_placement(p, 2,
                                                         policy="nope"),
                 lambda: TRules.ame_pim_layer_stacks(4, 0)):
        with pytest.raises(ValueError):
            call()


# ---------------------------------------------------------------------------
# SLO and autoscalers
# ---------------------------------------------------------------------------

TTFTS = [[], [0.2], [0.8], [2.0], [0.1, 0.3, 1.5], [0.4] * 20 + [3.0],
         [3.0] + [0.1] * 20]


def decisions(T):
    slo = T.SLO(ttft_s=1.0, tpot_s=0.1)
    met = [slo.met(ttft, tpot) for ttft in (0.5, 1.0, 1.5)
           for tpot in (None, 0.05, 0.1, 0.2)]
    policies = [T.StaticSlots(slots=6),
                T.QueueProportionalSlots(min_slots=2, max_slots=8,
                                         per_queue=4),
                T.QueueProportionalSlots(),
                T.SLOFeedbackSlots(slo, min_slots=1, max_slots=4),
                T.SLOFeedbackSlots(slo, window=4, shrink_frac=0.25)]
    out = [p.target(queue_len=q, slots=s, live=live, recent_ttft=r)
           for p in policies for q in (0, 1, 8, 999) for s in (1, 2, 16)
           for live in (0, 2) for r in TTFTS]
    return met, out, [dataclasses.asdict(p) for p in policies]


def test_slo_and_autoscaler_decisions_equal():
    assert decisions(TT) == decisions(JT)


def test_clocks_equal():
    for T in (JT, TT):
        c = T.SimClock(1.0)
        assert [c.advance(1.5), c.advance_to(1.0), c.advance_to(3.0)] == \
            [2.5, 2.5, 3.0]
        with pytest.raises(ValueError):
            c.advance(-0.1)
    assert abs(TT.WallClock().advance(1e6) - TT.WallClock().now) < 5.0


def test_decode_matmuls_equal_and_reexported():
    from repro.serve.offload import decode_matmuls as jdm
    from repro_torch.serve import offload
    assert offload.decode_matmuls is TT.decode_matmuls
    assert offload.DecodeMatmul is TT.DecodeMatmul
    for name in ("qwen3-1.7b", "mixtral-8x22b"):
        for red in (False, True):
            cfg, jcfg = get(name), jget(name)
            if red:
                cfg, jcfg = cfg.reduced(), jcfg.reduced()
            assert [dataclasses.asdict(m) for m in TT.decode_matmuls(cfg)] \
                == [dataclasses.asdict(m) for m in jdm(jcfg)]
    with pytest.raises(ValueError):
        TT.decode_matmuls(get("mamba2-370m").reduced())


def test_numpy_streams_are_the_references():
    """The port keeps the reference's domain-separated generators: the
    first gap of each trace kind is the generator's first draw."""
    tr = TT.poisson_trace(4.0, 3, seed=7)
    assert tr.requests[0].at_s == float(
        np.random.default_rng((7919, 7)).exponential(0.25, size=3)[0])
