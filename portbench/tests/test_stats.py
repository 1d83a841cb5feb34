"""Percentiles, rates and the end-to-end readers on hand-made stamps."""
import math
from types import SimpleNamespace

import pytest

from portbench import bench, stats


def _req(due, stamps, admitted=None):
    return dict(due=due, stamps=stamps, admitted_at=admitted,
                first_token_at=stamps[0] if stamps else None)


def test_percentile_interpolates_between_order_statistics():
    xs = [4.0, 1.0, 3.0, 2.0]
    assert stats.percentile(xs, 0) == 1.0
    assert stats.percentile(xs, 100) == 4.0
    assert stats.percentile(xs, 50) == 2.5
    assert stats.percentile(xs, 90) == pytest.approx(3.7)
    assert math.isnan(stats.percentile([], 50))


def test_a_request_without_a_first_token_counts_as_missing():
    reqs = [_req(0.0, [0.1 * (i + 1)]) for i in range(9)] + [_req(0.0, [])]
    ttft = stats.ttft_s(reqs)
    assert ttft[-1] == math.inf
    # rank 8.1 of 0..9 lies between 0.9 and the missing request
    assert stats.percentile(ttft, 90) == math.inf
    assert stats.percentile(ttft, 50) == pytest.approx(0.55)


def test_gaps_and_tokens_stop_at_the_window():
    reqs = [_req(0.0, [1.0, 1.5, 2.5, 4.0]), _req(1.0, [3.0, 3.2])]
    assert sorted(stats.itl_s(reqs, 3.0)) == pytest.approx([0.5, 1.0])
    assert sorted(stats.itl_s(reqs, 3.2)) == pytest.approx([0.2, 0.5, 1.0])
    assert stats.tokens_in(reqs, 1.0, 3.0) == 4


def _run(reqs, t0=0.0, seconds=10.0, t_last=15.0):
    return SimpleNamespace(requests=reqs, t0=t0, t_end=t0 + seconds,
                           seconds=seconds, t_last=t_last, setup_s=12.5)


def test_end_to_end_readers():
    reqs = [_req(i * 1.0, [i + 0.2, i + 0.3, i + 0.5], admitted=i + 0.1)
            for i in range(10)]
    run = _run(reqs)
    ttft = bench.reader("ttft_p90_ms")(run)
    assert ttft == pytest.approx(200.0)
    assert bench.reader("itl_p95_ms")(run) == pytest.approx(200.0)
    # 30 tokens, all stamped by t=9.5, in a 10 s window
    assert bench.reader("output_tok_s")(run) == pytest.approx(3.0)
    assert bench.reader("setup_s")(run) == 12.5
    assert bench.reader("queue_wait_p50_ms")(run) == pytest.approx(100.0)


def test_ttft_where_the_tail_is_missing_reads_the_longest_wait():
    reqs = [_req(0.0, [0.2])] * 5 + [_req(2.0, []), _req(4.0, [])]
    v = bench.reader("ttft_p90_ms")(_run(reqs, t_last=15.0))
    assert v == pytest.approx(13000.0)


def test_every_metric_has_its_reader():
    spec = bench.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(bench.reader(m["name"]))
