"""On the card: a run of each cell through ``run.py``, at the
benchmark's own length, prints a correct line with every metric its cell
reports.  Skips here."""
import json
import subprocess
import sys

import pytest

from portbench import bench


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [0, 1])
def test_each_cell_runs_correct_on_the_card(cuda, traced):
    spec = bench.load_spec()
    for w in spec["workloads"]:
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", w["name"],
             "--seed", "2718281828459", "--seconds",
             str(spec["run_seconds"]), "--trace",
             str(traced)], capture_output=True, text=True, timeout=360,
            cwd=bench.ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        want = {m["name"] for m in bench.metric_entries(spec, w["name"],
                                                        bool(traced))}
        assert set(line["metrics"]) == want
