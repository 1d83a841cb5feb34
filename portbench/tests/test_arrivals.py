"""The traffic generator: seeded, replayable, the same work for every
seed, every traffic file fits its cache, and the processes and length
distributions that traffic files name."""
import json

import numpy as np
import pytest

from portbench import arrivals, bench

MIX = dict(arrival=dict(process="poisson"), prompt_len=[32, 1024],
           output_len=[16, 256], lengths="log-uniform", slots=32,
           cache_len=1312, base_seed=0)
BIG = 2 ** 33 + 17          # seeds beyond 32 bits


def _key(sched):
    return [(a.uid, a.due_s, a.max_new, a.prompt.tolist()) for a in sched]


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_a_seed_repeats_its_schedule(seed):
    a = arrivals.schedule(MIX, 3.0, 40.0, seed, 151936)
    b = arrivals.schedule(MIX, 3.0, 40.0, seed, 151936)
    assert _key(a) == _key(b)


def test_seeds_differ_in_tokens_not_in_work():
    a = arrivals.schedule(MIX, 3.0, 40.0, 1, 151936)
    b = arrivals.schedule(MIX, 3.0, 40.0, BIG, 151936)
    assert [(x.due_s, len(x.prompt), x.max_new) for x in a] \
        == [(x.due_s, len(x.prompt), x.max_new) for x in b]
    assert all(not np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


def test_all_due_inside_the_window_at_the_rate():
    s = arrivals.schedule(MIX, 3.0, 40.0, 5, 151936)
    assert len(s) == 120
    due = [a.due_s for a in s]
    assert due == sorted(due) and 0.0 <= due[0] and due[-1] < 40.0
    for a in s:
        assert 32 <= len(a.prompt) <= 1024 and 16 <= a.max_new <= 256
        assert a.prompt.dtype == np.int32
        assert 0 <= a.prompt.min() and a.prompt.max() < 151936


def test_the_chat_schedule_is_the_one_its_cell_was_measured_on():
    mix = arrivals.load(bench.PKG / "traffic" / "chat.json")
    s = arrivals.schedule(mix, 2.4, 51.0, 12345, 151936)
    assert len(s) == 122
    assert [(round(a.due_s, 6), len(a.prompt), a.max_new) for a in s[:3]] \
        == [(0.088508, 113, 233), (0.309443, 645, 123), (1.108914, 905, 133)]


def test_lengths_are_log_uniform():
    rng = np.random.default_rng(0)
    x = arrivals.module("lengths", "log-uniform").draw(rng, 16, 256, 200_000)
    assert x.min() == 16 and x.max() == 256
    # half the mass below the geometric middle of [16, 257)
    assert abs(np.mean(x < np.sqrt(16 * 257)) - 0.5) < 0.01


def test_uniform_lengths_cover_the_range_evenly():
    x = arrivals.module("lengths", "uniform").draw(
        np.random.default_rng(0), 16, 256, 200_000)
    assert x.min() == 16 and x.max() == 256
    assert abs(x.mean() - 136) < 1.0


@pytest.mark.parametrize("cv", [1.0, 3.0])
def test_gamma_arrivals_fill_the_window_with_the_burstiness_asked(cv):
    mix = dict(MIX, arrival=dict(process="gamma", cv=cv))
    s = arrivals.schedule(mix, 50.0, 400.0, 3, 1000)
    due = np.array([a.due_s for a in s])
    assert len(s) == 20_000 and np.all(np.diff(due) >= 0)
    assert 0.0 <= due[0] and due[-1] < 400.0
    gaps = np.diff(due)
    assert gaps.std() / gaps.mean() == pytest.approx(cv, rel=0.05)


@pytest.mark.parametrize("bad", [dict(prompt_len=[32, 1300]),
                                 dict(arrival=dict(process="zipf")),
                                 dict(arrival=dict(rate=2.0)),
                                 dict(lengths="normal"),
                                 dict(output_len=[0, 4])])
def test_a_traffic_file_that_cannot_run_is_refused(tmp_path, bad):
    p = tmp_path / "t.json"
    p.write_text(json.dumps(dict(MIX, **bad)))
    with pytest.raises(ValueError):
        arrivals.load(p)


def test_a_rate_that_cannot_run_is_refused():
    with pytest.raises(ValueError):
        arrivals.schedule(MIX, 0.0, 10.0, 1, 1000)


def test_every_cell_has_its_traffic_and_its_own_file():
    spec = bench.load_spec()
    for w in spec["workloads"]:
        cell = bench.cell_of(spec, w["name"], False)
        assert cell["rate"] > 0 and cell["wait_share"] >= 0
        assert cell["limits"]["at_most"]


def test_warm_prompts_reach_the_mix_extremes():
    lens = [len(p) for p in arrivals.warm_prompts(MIX, BIG, 1000)]
    assert lens == [32, 181, 1024]
