"""A whole run rehearsed on the CPU at a tiny size (every kernel on its
plain version), the result line parsed; and ``run.py`` refusing to run
without a card or without the program."""
import json
import shutil
import subprocess
import sys

import pytest

from portbench import arrivals, bench
from portbench.tests.conftest import rehearse, tiny_cell

BIG = 2 ** 33 + 3


@pytest.mark.parametrize("traced", [False, True])
def test_a_rehearsed_run_prints_its_line(traced, capsys):
    cell = tiny_cell(traced)
    logged = []
    assert bench.emit(rehearse(cell, BIG, traced), "cpu", logged.append) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == 8           # 4 requests/s for 2 s
    if traced:       # what a CPU run can read: no device trace here
        assert set(line["metrics"]) == {"queue_wait_p50_ms", "decode_mfu"}
    else:
        assert set(line["metrics"]) == {"ttft_p90_ms", "itl_p95_ms",
                                        "output_tok_s", "setup_s"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    assert logged[-2:] == [f"check {k}: {c['value']} ({c['rule']} "
                           f"{c['limit']})" for k, c in
                           line["checks"].items()]


def test_a_run_that_waits_for_none_stops_at_the_window():
    # offered far beyond what the tiny server completes, as the queued
    # long-prefill cell is (PERF.md, section 7): the requests still
    # queued at the close are neither waited for nor failed, and that
    # cell's readers read the run
    names = ["output_tok_s.saturated", "ttft_p90_ms.saturated",
             "itl_p95_ms.saturated"]
    cell = tiny_cell(rate=400.0, wait_share=0.0, metrics=names)
    res = rehearse(cell, 3, seconds=1.0)
    assert res["attempted"] == 400 and res["failed"] == 0
    assert res["correct"] is True
    assert set(res["metrics"]) == set(names)
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_the_queued_long_prefill_cell_has_what_a_run_reads():
    own = json.loads((bench.PKG / "cells" / "qwen3-1.7b.long-prefill.json")
                     .read_text())
    assert own["rate_rps"] > 0 and own["wait_share"] == 0.0
    assert arrivals.load(bench.PKG / "traffic" / "long-prefill.json")
    for name in ("prefill_mfu", "k1_roofline.prefill",
                 "device_idle.long_prefill"):
        assert callable(bench.reader(name))


def test_the_same_seed_serves_the_same_tokens():
    cell = tiny_cell()
    a, b = rehearse(cell, 5), rehearse(cell, 5)
    assert a["checks"] == b["checks"]


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "qwen3-1.7b.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=cwd)


def test_run_refuses_without_a_card():
    out = _run(bench.ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_run_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
