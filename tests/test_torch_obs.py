"""The port's observability layer against the reference on the CPU.

Mirrors tests/test_obs.py.  The same op logs go through ``repro.obs``
and ``repro_torch.obs``: Chrome traces (``json.dumps(...,
sort_keys=True)``), critical-path segments, ``ProfileReport`` fields,
``MetricsRegistry`` snapshots and the ``python -m ... obs`` summaries
must be ``==``; an attached profiler leaves ledgers and traces ``==`` to
a run without one.  Runtime scenarios use the harness of
test_torch_runtime.py.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.obs as JO
import repro.obs.__main__ as JCLI
import repro.runtime as JR
import repro_torch.obs as TO
import repro_torch.obs.__main__ as TCLI
import repro_torch.runtime as TR
from test_torch_runtime import assert_records_equal, norm, rand

ROOT = Path(__file__).resolve().parents[1]
#: (runtime package, obs package, runtime keywords)
PACKAGES = {"reference": (JR, JO, {}), "port": (TR, TO, {"device": "cpu"})}


def run_both(scenario, *args):
    return tuple(scenario(*pkg, *args) for pkg in PACKAGES.values())


def report_fields(rep):
    """Every field of a ProfileReport, plus its derived views."""
    d = {f.name: getattr(rep, f.name) for f in dataclasses.fields(rep)}
    d["segments"] = [dataclasses.asdict(s) for s in rep.segments]
    d.update(coverage=rep.coverage_cycles, top=rep.top(3),
             summary=rep.summary(top_k=3), json=rep.to_json())
    return d


# ---------------------------------------------------------------------------
# critical path over hand-built op logs
# ---------------------------------------------------------------------------


def _op(R, op_id, name, spans, deps=(), link=None):
    ends = [s + b for s, b in spans.values()]
    if link:
        ends.append(link[1])
    start = min((s for s, _ in spans.values()),
                default=link[0] if link else 0.0)
    return R.OpHandle(op_id=op_id, name=name, deps=tuple(deps), start=start,
                      retire=max(ends, default=start), spans=dict(spans),
                      link_window=link)


LOGS = {
    "chain": lambda R: [_op(R, 1, "a", {0: (0.0, 100.0)}),
                        _op(R, 2, "b", {0: (100.0, 50.0)}, deps=(1,))],
    "independent": lambda R: [_op(R, 1, "short", {0: (0.0, 40.0)}),
                              _op(R, 2, "long", {1: (0.0, 100.0)})],
    "slack": lambda R: [_op(R, 1, "a", {0: (0.0, 50.0)}),
                        _op(R, 2, "b", {1: (80.0, 20.0)})],
    "link": lambda R: [_op(R, 1, "xfer", {0: (0.0, 10.0)},
                           link=(0.0, 60.0)),
                       _op(R, 2, "use", {1: (60.0, 40.0)}, deps=(1,))],
    "degenerate": lambda R: [
        _op(R, 1, "a", {0: (0.0, 50.0)}),
        R.OpHandle(op_id=2, name="noop", deps=(1,), start=50.0,
                   retire=50.0, spans={}),
        _op(R, 3, "b", {0: (50.0, 25.0)}, deps=(2,))],
    "empty": lambda R: [],
}


@pytest.mark.parametrize("log", list(LOGS))
def test_critical_path_segments_equal(log):
    want = report_fields(JO.critical_path(LOGS[log](JR)))
    got = report_fields(TO.critical_path(LOGS[log](TR)))
    assert got == want
    assert got["coverage"] == got["makespan_cycles"]


def test_profile_report_dump_is_byte_identical(tmp_path):
    paths = []
    for R, O, _ in PACKAGES.values():
        p = tmp_path / f"{O.__name__}.json"
        O.critical_path(LOGS["link"](R)).dump(str(p))
        paths.append(p.read_bytes())
    assert paths[0] == paths[1]


# ---------------------------------------------------------------------------
# Chrome traces and reports of live runtimes
# ---------------------------------------------------------------------------


def async_cluster(R, O, kw, placement, topology):
    """Two dependent GEMMs across a 2 x 2 cluster (async), then a GEMV on
    a placed weight and an element-wise op with its kept output; analytic
    (a trace holds cycles, not values)."""
    rt = R.PIMRuntime(channels=2, stacks=2, async_mode=True,
                      link_topology=topology, **kw)
    a, b = np.zeros((128, 64), np.float16), np.zeros((64, 32), np.float16)
    h1 = rt.gemm(a, b, placement=placement, execute=False)
    rt.gemm(a, b, placement=placement, after=[h1], execute=False)
    w = rt.place((256, 64), placement="balanced")
    rt.gemv(w, np.zeros(64, np.float16), placement="balanced",
            execute=False)
    rt.elementwise("mul", a[:, :32], a[:, :32], placement="row-striped",
                   keep_output=True, execute=False)
    return rt


def serialized_profiled(R, O, kw, placement, topology):
    """The same kinds of op on a serialized runtime with the shadow
    profiler: place, GEMV (renamed from its GEMM), GEMM, element-wise,
    and a paged softmax; numeric on one stack, analytic on two."""
    rng = np.random.default_rng(4)
    execute = topology == "shared"
    rt = R.PIMRuntime(channels=4, stacks=1 if execute else 2,
                      link_topology=topology, profile=True, **kw)
    a, x = rand(rng, 128, 64, scale=0.1), rand(rng, 64, scale=0.1)
    w = rt.place(a if execute else a.shape, placement=placement)
    rt.gemv(w, x, placement=placement, execute=execute)
    rt.gemm(a, rand(rng, 64, 16, scale=0.1), placement=placement,
            execute=execute)
    rt.elementwise("add", a, a, placement=placement, execute=execute)
    s, _ = rt.gemm(rand(rng, 96, 32, scale=0.1), rand(rng, 32, 4, scale=0.1),
                   placement="paged", keep_output=True, execute=execute)
    rt.softmax(s, placement="paged", execute=execute)
    return rt


def obs_record(rt, R, O):
    trace = O.chrome_trace(rt)
    return {"chrome": json.dumps(trace, sort_keys=True),
            "report": report_fields(O.profile_report(rt)),
            "ledgers": rt.stack, "trace": R.emit_trace(rt.stack)}


@pytest.mark.parametrize("topology", ["shared", "switched"])
@pytest.mark.parametrize("placement", ["2d-block", "balanced",
                                       "row-striped"])
@pytest.mark.parametrize("make", [async_cluster, serialized_profiled],
                         ids=["async", "profiled"])
def test_chrome_trace_and_report_equal(make, placement, topology):
    def scenario(R, O, kw):
        return obs_record(make(R, O, kw, placement, topology), R, O)
    ref, port = run_both(scenario)
    assert_records_equal(ref, port)
    trace = json.loads(port["chrome"])
    s = sorted(e["id"] for e in trace["traceEvents"] if e.get("ph") == "s")
    f = sorted(e["id"] for e in trace["traceEvents"] if e.get("ph") == "f")
    assert s == f
    assert port["report"]["coverage"] == port["report"]["makespan_cycles"]


def test_export_writes_the_reference_bytes(tmp_path):
    out = []
    for R, O, kw in PACKAGES.values():
        p = tmp_path / f"{O.__name__}.json"
        O.export_chrome_trace(async_cluster(R, O, kw, "2d-block", "shared"),
                              str(p))
        out.append(p.read_bytes())
    assert out[0] == out[1]


def test_profiler_is_strictly_additive():
    """The shadow profiler only reads finished reports: ledgers, reports
    and traces of a profiled runtime are ``==`` to a bare one's."""
    def run(profile):
        rng = np.random.default_rng(9)
        rt = TR.PIMRuntime(channels=4, stacks=2, profile=profile,
                           device="cpu")
        a = rand(rng, 256, 128)
        w = rt.place(a, placement="balanced")
        reps = [rt.gemv(w, rand(rng, 128), placement="balanced"),
                rt.gemm(a, rand(rng, 128, 8), placement="balanced"),
                rt.elementwise("add", a, a, placement="balanced")]
        return norm({"reps": reps, "ledgers": rt.stack}), \
            TR.emit_trace(rt.stack)
    assert run(True) == run(None)
    with pytest.raises(ValueError):
        TO.profile_report(TR.PIMRuntime(channels=2, device="cpu"))


def test_profiler_instance_is_attached_and_amends_gemv():
    prof = TO.Profiler()
    rt = TR.PIMRuntime(channels=2, profile=prof, device="cpu")
    assert rt.profile is prof and prof.runtime is rt
    rt.gemv(np.zeros((64, 32), np.float16), np.zeros(32, np.float16),
            execute=False)
    assert [h.name for h in prof.ops] == ["gemv"]
    assert prof.ops[0].report.op == "gemv"


# ---------------------------------------------------------------------------
# metrics snapshots
# ---------------------------------------------------------------------------


def metrics_scenario(R, O, kw):
    reg = O.MetricsRegistry()
    rng = np.random.default_rng(6)
    rt = R.PIMRuntime(channels=4, stacks=2, metrics=reg, capacity_bytes=1 << 15,
                      **kw)
    a = rand(rng, 512, 64)
    w = rt.place(a, placement="row-striped")
    for _ in range(2):
        rt.gemv(w, rand(rng, 64), placement="row-striped")
    rt.gemm(a, rand(rng, 64, 16), placement="2d-block")
    return {"snapshot": reg.snapshot(), "catalog": reg.catalog(),
            "ledgers": rt.stack}


def test_metrics_snapshots_equal():
    ref, port = run_both(metrics_scenario)
    assert_records_equal(ref, port)
    assert port["snapshot"]["runtime.ops"]["value"] == 3


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _artifacts(tmp_path, R, O, kw):
    rt = async_cluster(R, O, kw, "2d-block", "shared")
    tag = O.__name__.split(".")[0]
    chrome = tmp_path / f"{tag}.chrome.json"
    O.export_chrome_trace(rt, str(chrome))
    report = tmp_path / f"{tag}.report.json"
    O.profile_report(rt).dump(str(report))
    trace = tmp_path / f"{tag}.trace"
    trace.write_text(R.emit_trace(rt.stack))
    return chrome, report, trace


def test_cli_output_equal(tmp_path, capsys):
    outs = {}
    for (name, (R, O, kw)), cli in zip(PACKAGES.items(), (JCLI, TCLI)):
        got = []
        for path in _artifacts(tmp_path, R, O, kw):
            for argv in ([str(path)], [str(path), "--top", "2"]):
                assert cli.main(argv) == 0
                got.append(capsys.readouterr().out)
        bogus = tmp_path / "bogus.json"
        bogus.write_text('{"nope": 1}')
        assert cli.main([str(bogus)]) == 2
        capsys.readouterr()
        outs[name] = got
    assert outs["port"] == outs["reference"]
    assert "chrome trace:" in outs["port"][0]
    assert "critical path" in outs["port"][2]
    assert "command trace:" in outs["port"][4]


def test_cli_runs_as_a_module(tmp_path):
    chrome, _, _ = _artifacts(tmp_path, TR, TO, {"device": "cpu"})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                           str(chrome)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("chrome trace:")
