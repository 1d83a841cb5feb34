"""The port's multi-channel PIM runtime against the reference on the CPU.

Each scenario is one seeded op sequence written once against a runtime
package; it runs on ``repro.runtime`` and on ``repro_torch.runtime``
(``device="cpu"``) and returns a record of everything the sequence
produced: outputs, ``RuntimeReport``s, per-channel and host-link ledgers,
``OpHandle``s and command traces.  :func:`norm` turns a record into plain
values (dataclasses into field dicts, arrays of either framework into
their float16 bytes, tensor ids into their order), so a record of the port
must be ``==`` to the reference's: ledgers and reports equal, traces byte
for byte, outputs bit for bit.  Softmax outputs (an FP32 ``exp`` written
back to FP16) are held at one float16 ulp instead.

This file mirrors tests/test_runtime.py, test_residency.py and
test_async.py; test_torch_cluster.py and test_torch_kvcache.py reuse its
harness.
"""
import dataclasses
import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.runtime as JR
import repro.runtime.residency as JResidency
import repro_torch.runtime as TR
import repro_torch.runtime.residency as TResidency

#: (package, keyword arguments that put a runtime on the CPU)
PACKAGES = {"reference": (JR, {}), "port": (TR, {"device": "cpu"})}
BENCH = Path(__file__).resolve().parents[1] / "results" / "BENCH_runtime.json"


def rand(rng, *shape, scale=0.15):
    return (rng.standard_normal(shape) * scale).astype(np.float16)


def _f16_bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float16).view(np.int16)


def norm(x, uids=None):
    """Plain, comparable values of a scenario record.  ``uids`` numbers
    DeviceTensor ids by first appearance (each package counts its own)."""
    uids = {} if uids is None else uids
    if isinstance(x, (JR.DeviceTensor, TR.DeviceTensor)):
        return ("DeviceTensor", type(x).__name__, tuple(x.shape),
                uids.setdefault(x.uid, len(uids)),
                norm(x.pending_d2h, uids), x.resident_bytes,
                None if x.values is None else norm(x.values, uids))
    if isinstance(x, (JR.PIMDevice, TR.PIMDevice)):
        return ("PIMDevice", x.channel_id, norm(x.xfer, uids),
                x.compute_cycles, x.compute_flops, x.compute_commands,
                x.reuse_bytes, x.dedupe_bytes, x.spill_bytes, x.tl_free,
                [(uids.setdefault(u, len(uids)), list(b))
                 for u, b in x.resident.items()],
                sorted(uids.setdefault(u, len(uids)) for u in x.pinned),
                norm(x.events, uids))
    if isinstance(x, (JR.PIMStack, TR.PIMStack, JR.PIMCluster,
                      TR.PIMCluster)):
        links = x.all_links() if hasattr(x, "all_links") else []
        return ("stack", [norm(d, uids) for d in x],
                [norm(l, uids) for l in links])
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: norm(getattr(x, f.name), uids)
                 for f in dataclasses.fields(x) if f.compare})
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, torch.Tensor) or hasattr(x, "__array__") \
            and not isinstance(x, (str, bytes)):
        arr = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                         else x)
        if arr.dtype.kind == "f":
            return ("f16", arr.shape, _f16_bits(arr).tobytes())
        return ("array", arr.shape, arr.tolist())
    if isinstance(x, dict):
        return {k: norm(v, uids) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v, uids) for v in x)
    return x


def fresh_uids():
    """Start both packages' tensor uids at 1.  The uids count per process,
    and fault instants and lost sets name them, so a harness that compares
    those calls this before each package's run: whatever ran earlier in
    the process (another test file on the same worker) must not shift one
    package's count."""
    for residency in (JResidency, TResidency):
        residency._uid = itertools.count(1)


def run_both(scenario, *args):
    """``(reference record, port record)`` of one scenario."""
    return tuple(scenario(pkg, kw, *args) for pkg, kw in PACKAGES.values())


def assert_records_equal(ref, port):
    """``==`` key by key (so a failure names the first item that
    differs); ``ulp:`` items within one float16 ulp."""
    assert list(ref) == list(port)
    for key in ref:
        if key.startswith("ulp:"):
            a, b = _f16_bits(ref[key]), _f16_bits(port[key])
            assert a.shape == b.shape, key
            assert int(np.abs(a.astype(np.int32) - b).max()) <= 1, key
        else:
            assert norm(ref[key]) == norm(port[key]), key


def check(scenario, *args):
    assert_records_equal(*run_both(scenario, *args))


# ---------------------------------------------------------------------------
# scenarios: one op sequence each, written against a runtime package R
# ---------------------------------------------------------------------------

GEMM_SHAPES = [(256, 160, 48), (128, 1024, 8), (300, 96, 40)]


def gemm_once(R, kw, placement, channels, shape, engine):
    """One numeric GEMM on a fresh runtime (K-split partials on
    ``balanced`` when row blocks are fewer than channels)."""
    rng = np.random.default_rng(7)
    m, k, n = shape
    a, b = rand(rng, m, k), rand(rng, k, n)
    rt = R.PIMRuntime(channels=channels, engine=engine, **kw)
    out, rep = rt.gemm(a, b, placement=placement)
    return {"out": out, "report": rep, "summary": rep.summary(),
            "makespan": rep.makespan_cycles, "ledgers": rt.stack,
            "trace": R.emit_trace(rt.stack)}


def gemv_and_elementwise(R, kw, placement, channels, engine):
    """A balanced/striped GEMV (x deduped per channel) and the three
    element-wise kinds on one runtime, then its trace and ledgers."""
    rng = np.random.default_rng(3)
    rt = R.PIMRuntime(channels=channels, engine=engine, **kw)
    rec = {}
    a, x = rand(rng, 256, 512, scale=0.1), rand(rng, 512, scale=0.1)
    rec["gemv"] = rt.gemv(a, x, placement=placement)
    c, d = rand(rng, 300, 96), rand(rng, 300, 96)
    for kind in ("add", "sub", "mul"):
        rec[kind] = rt.elementwise(kind, c, d, placement=placement)
    rec["ledgers"] = rt.stack
    rec["trace"] = R.emit_trace(rt.stack)
    rec["stats"] = R.parse_trace(rec["trace"])
    return rec


def residency(R, kw, placement):
    """test_residency.py's sequence: place, resident GEMV/GEMM reuse,
    a lazy handle, host mutation after place, evict, role B, kept
    outputs, an element-wise epilogue chain, drains."""
    rng = np.random.default_rng(11)
    rt = R.PIMRuntime(channels=4, **kw)
    rec = {}
    a, x = rand(rng, 384, 192), rand(rng, 192)
    w = rt.place(a, placement=placement)
    rec["gemv 1"] = rt.gemv(w, x, placement=placement)
    rec["gemv 2"] = rt.gemv(w, x, placement=placement)
    lazy = R.DeviceTensor(rt.stack, a.shape, values=a)
    rec["lazy 1"] = rt.gemv(lazy, x, placement=placement)
    rec["lazy 2"] = rt.gemv(lazy, x, placement=placement)
    a *= 2                                    # host-side mutation
    rec["after mutation"] = rt.gemv(w, x, placement=placement)
    w.evict()
    rec["after evict"] = rt.gemv(w, x, placement=placement)
    b = rand(rng, 192, 40)
    wb = rt.place(b, placement=placement, role="B", other_dim=384)
    rec["role B"] = rt.gemm(a, wb, placement=placement)
    h, rec["kept gemm"] = rt.gemm(a, b, placement=placement,
                                  keep_output=True)
    c = rand(rng, 384, 40)
    h2, rec["epilogue"] = rt.elementwise("add", h, c, placement=placement,
                                         keep_output=True)
    rec["chain"] = rt.elementwise("mul", h2, c, placement=placement,
                                  keep_output=True)
    rec["to_host"] = rec["chain"][0].to_host()
    rec["to_host again"] = rec["chain"][0].to_host()
    rec["kept handle"] = h
    rec["ledgers"] = rt.stack
    rec["trace"] = R.emit_trace(rt.stack)
    return rec


def analytic(R, kw):
    """Analytic mode on shape-only handles and 0-strided operands at
    paper scale (nothing reads their values), both executors."""
    rec = {}
    z = lambda *s: np.broadcast_to(np.float16(0), s)     # noqa: E731
    for engine in ("batched", "tiled"):
        rt = R.PIMRuntime(channels=16, engine=engine, **kw)
        w = rt.place((1024, 2048), placement="balanced")
        rec[f"{engine} resident gemv"] = rt.gemv(
            w, z(2048), placement="balanced", execute=False)
        rec[f"{engine} gemm"] = rt.gemm(z(512, 384), z(384, 200),
                                        placement="2d-block",
                                        execute=False)
        rec[f"{engine} ew"] = rt.elementwise("sub", z(300, 5000),
                                             z(300, 5000), execute=False)
        rec[f"{engine} ledgers"] = rt.stack
    for tag, (m, k, n), placement in [
            ("gemm 8192^3", (8192, 8192, 8192), "2d-block"),
            ("gemv 151936x8192", (151936, 8192, 1), "balanced")]:
        rec[tag] = R.pim_gemm(z(m, k), z(k, n), channels=16,
                              placement=placement, execute=False, **kw)
    return rec


def sync_dma(R, kw):
    """The synchronous-DMA busy model against the overlapped one."""
    rng = np.random.default_rng(5)
    a, b = rand(rng, 512, 2048), rand(rng, 2048, 128)
    return {f"overlap={ov}": R.PIMRuntime(channels=4, overlap=ov, **kw)
            .gemm(a, b, placement="row-striped", execute=False)[1]
            for ov in (True, False)}


def capacity(R, kw):
    """LRU spill and re-ship, touch order, a kept output pinned until
    drained, a refused keep, a doomed insert and an oversized box."""
    rng = np.random.default_rng(9)
    rec = {}
    box = 128 * 256 * 2
    rt = R.PIMRuntime(channels=2, capacity_bytes=box, **kw)
    a1, a2, x = rand(rng, 256, 256), rand(rng, 256, 256), rand(rng, 256)
    w1 = rt.place(a1, placement="balanced")
    w2 = rt.place(a2, placement="balanced")
    rec["reuse w2"] = rt.gemv(w2, x, placement="balanced")
    rec["re-ship w1"] = rt.gemv(w1, x, placement="balanced")
    rec["spill ledgers"] = rt.stack
    rec["spill trace"] = R.emit_trace(rt.stack)
    one = 128 * 128 * 2
    rt = R.PIMRuntime(channels=1, capacity_bytes=2 * one, **kw)
    ws = [rt.place(rand(rng, 128, 128), placement="row-striped",
                   other_dim=128) for _ in range(2)]
    rec["touch"] = rt.gemm(ws[0], rand(rng, 128, 128),
                           placement="row-striped")
    ws.append(rt.place(rand(rng, 128, 128), placement="row-striped",
                       other_dim=128))
    rec["lru ledgers"] = rt.stack
    rt = R.PIMRuntime(channels=1, capacity_bytes=one, **kw)
    h, rec["pinned keep"] = rt.gemm(rand(rng, 128, 128),
                                    rand(rng, 128, 128),
                                    placement="row-striped",
                                    keep_output=True)
    rt.place(rand(rng, 128, 128), placement="row-striped", other_dim=128)
    rec["pinned drain"] = h.to_host()
    rt.place(rand(rng, 128, 128), placement="row-striped", other_dim=128)
    rec["pinned ledgers"] = rt.stack
    rt = R.PIMRuntime(channels=1, capacity_bytes=1024, **kw)
    rec["refused keep"] = rt.gemm(rand(rng, 128, 128), rand(rng, 128, 128),
                                  placement="row-striped", keep_output=True)
    w = rt.place(rand(rng, 128, 128), placement="row-striped", other_dim=128)
    rec["oversized"] = rt.gemm(w, rand(rng, 128, 128),
                               placement="row-striped")
    rt = R.PIMRuntime(channels=1, capacity_bytes=3 * one, **kw)
    rt.gemm(rand(rng, 256, 128), rand(rng, 128, 128),
            placement="row-striped", keep_output=True)
    rt.place(rand(rng, 128, 128), placement="row-striped", other_dim=128)
    rt.place(rand(rng, 256, 128), placement="row-striped", other_dim=128)
    rec["doomed ledgers"] = rt.stack
    return rec


def handles(h):
    """An ``OpHandle`` list, as the reference's tests read them."""
    return [(x.op_id, x.name, x.deps, x.start, x.retire, x.spans,
             x.link_window, x.busy_cycles, x.report, x.result) for x in h]


def async_timeline(R, kw):
    """test_async.py's sequences: chained DAG, disjoint subsets,
    dependencies inferred from place and keep_output, explicit after=
    edges, channel subsets, a resident GEMV, and host-link windows on a
    2-stack cluster; the handles, the clocks and the timestamped
    traces."""
    rng = np.random.default_rng(42)
    a, b, c = rand(rng, 256, 48), rand(rng, 48, 24), rand(rng, 256, 24)
    x = rand(rng, 48)
    rec = {}
    rt = R.PIMRuntime(channels=4, async_mode=True, **kw)
    h1 = rt.gemm(a, b, placement="balanced")
    h2 = rt.gemm(a, b, placement="balanced", after=[h1])
    rt.elementwise("add", a, a, placement="balanced", after=[h2])
    rt.gemm(a, b, placement="balanced", channels=(0, 1))
    h5 = rt.gemm(a, b, placement="balanced", channels=(2, 3))
    rt.gemm(a, b, placement="balanced", channels=(0, 1), after=[h5])
    w = rt.place(a, placement="row-striped")
    k1 = rt.gemm(w, b, placement="row-striped", keep_output=True)
    rt.elementwise("add", k1.result, c, placement="row-striped")
    ws = rt.place(a, placement="balanced", channels=(1, 3))
    rt.gemv(ws, x, placement="balanced", channels=(1, 3))
    rt.gemv(ws, x, placement="balanced", channels=(1, 3))
    rec["single-stack ops"] = handles(rt.timeline.ops)
    rec["now"] = rt.timeline.now
    rec["channel busy"] = [rt.timeline.channel_busy(ch) for ch in range(4)]
    rec["ledgers"] = rt.stack
    rec["trace"] = R.emit_trace(rt.stack)
    rec["stripped"] = R.strip_timestamps(rec["trace"])
    rec["stats"] = R.parse_trace(rec["trace"])
    for topology in ("shared", "switched"):
        rt = R.PIMRuntime(channels=2, stacks=2, async_mode=True,
                          link_topology=topology, **kw)
        bb = rand(rng, 48, 48)
        g1 = rt.gemm(a, bb, placement="2d-block")
        g2 = rt.gemm(a, bb, placement="2d-block")
        rt.gemm(a, bb, placement="2d-block", after=[g2])
        rt.gemm(a, bb, placement="row-striped", stack=1, after=[g1])
        rec[f"{topology} link ops"] = handles(rt.timeline.ops)
        rec[f"{topology} ledgers"] = rt.stack
        rec[f"{topology} trace"] = R.emit_trace(rt.stack)
    return rec


def serialized_vs_async(R, kw):
    """The same resident GEMV on a serialized and an async runtime: the
    async trace strips to the serialized one in each package."""
    rng = np.random.default_rng(1)
    a, x = rand(rng, 256, 128), rand(rng, 128)
    rec = {}
    for mode in (False, True):
        rt = R.PIMRuntime(channels=2, async_mode=mode, **kw)
        w = rt.place(a, placement="balanced")
        res = rt.gemv(w, x, placement="balanced")
        rec[f"async={mode}"] = handles([res]) if mode else res
        rec[f"async={mode} trace"] = R.emit_trace(rt.stack)
    assert R.strip_timestamps(rec["async=True trace"]) \
        == rec["async=False trace"]
    return rec


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("placement", sorted(JR.PLACEMENTS))
def test_gemm_matches_reference(placement, shape):
    check(gemm_once, placement, 4, shape, "batched")


@pytest.mark.parametrize("channels", [1, 2, 16])
def test_gemm_matches_reference_at_channel_counts(channels):
    check(gemm_once, "balanced", channels, GEMM_SHAPES[1], "batched")


@pytest.mark.parametrize("engine", ["batched", "tiled"])
@pytest.mark.parametrize("placement,channels", [("balanced", 16),
                                                ("row-striped", 4)])
def test_gemv_and_elementwise_match_reference(placement, channels, engine):
    check(gemv_and_elementwise, placement, channels, engine)


def test_tiled_and_batched_executors_agree_in_the_port():
    tiled = gemm_once(TR, {"device": "cpu"}, "balanced", 16,
                      GEMM_SHAPES[1], "tiled")
    batched = gemm_once(TR, {"device": "cpu"}, "balanced", 16,
                        GEMM_SHAPES[1], "batched")
    assert norm(tiled["out"]) == norm(batched["out"])
    assert norm(tiled["report"]) == norm(batched["report"])
    assert tiled["trace"] == batched["trace"]


@pytest.mark.parametrize("placement", sorted(JR.PLACEMENTS))
def test_residency_matches_reference(placement):
    check(residency, placement)


@pytest.mark.parametrize("scenario", [analytic, sync_dma, capacity,
                                      async_timeline, serialized_vs_async],
                         ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario):
    check(scenario)


def test_outputs_are_float16_tensors_on_the_runtime_device():
    rng = np.random.default_rng(0)
    a, b = rand(rng, 130, 40), rand(rng, 40, 24)
    rt = TR.PIMRuntime(channels=2, device="cpu")
    out, _ = rt.gemm(torch.from_numpy(a).float(), b)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float16
    assert out.device.type == "cpu"
    w = rt.place(torch.from_numpy(a))
    assert w.values.dtype == torch.float16 and w.values is not None
    y, _ = rt.gemv(w, torch.from_numpy(b[:, 0]))
    assert y.shape == (130,) and y.dtype == torch.float16
    # a tensor operand and its numpy twin give the same bits
    out_np, _ = TR.PIMRuntime(channels=2, device="cpu").gemm(a, b)
    assert torch.equal(out.view(torch.int16), out_np.view(torch.int16))


def test_place_snapshots_a_tensor_and_to_host_copies():
    a = torch.from_numpy(rand(np.random.default_rng(2), 128, 64))
    rt = TR.PIMRuntime(channels=1, device="cpu")
    w = rt.place(a)
    a.mul_(2)
    assert not torch.equal(w.values, a)
    h, _ = rt.gemm(w, torch.ones(64, 8, dtype=torch.float16),
                   keep_output=True)
    host = h.to_host()
    host.zero_()
    assert not torch.equal(h.values, host)


def test_cpu_runtime_without_a_card_needs_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TR.PIMRuntime(channels=1),
                 lambda: TR.PIMStack(2), lambda: TR.PIMCluster(2, 2),
                 lambda: TR.pim_gemm(np.zeros((4, 4)), np.zeros((4, 4)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    rt = TR.PIMRuntime(channels=2, stacks=2, device="cpu")
    assert {d.engine.device.type for d in rt.stack} == {"cpu"}
    rt.stack.reset()
    assert rt.stack.torch_device.type == "cpu"


def test_an_explicit_stack_brings_its_own_device():
    stack = TR.PIMStack(2, device="cpu")
    assert TR.PIMRuntime(stack=stack).device == stack.torch_device
    with pytest.raises(ValueError, match="device="):
        TR.PIMRuntime(stack=stack, device="cpu")


@pytest.mark.parametrize("option", [{"profile": True},
                                    {"faults": "kill channel 0 @ 0"}])
def test_profile_and_faults_wait_for_their_slice(option):
    """``profile=`` and ``faults=`` attach the port's own profiler and
    fault injector."""
    from repro_torch.faults import FaultInjector
    from repro_torch.obs import Profiler
    rt = TR.PIMRuntime(channels=2, device="cpu", **option)
    if "profile" in option:
        assert isinstance(rt.profile, Profiler) and rt.faults is None
    else:
        assert isinstance(rt.faults, FaultInjector) and rt.profile is None
        _, rep = rt.gemm(np.zeros((64, 32), np.float16),
                         np.zeros((32, 8), np.float16), execute=False)
        assert rep.failed_channels == (0,)


@pytest.mark.parametrize("call,exc", [
    (lambda R, kw: R.PIMRuntime(channels=17, **kw), AssertionError),
    (lambda R, kw: R.PIMRuntime(channels=2, **kw).place(
        np.zeros(16, np.float16)), ValueError),
    (lambda R, kw: R.PIMRuntime(channels=2, **kw).place((2, 3, 4)),
     ValueError),
    (lambda R, kw: R.PIMRuntime(channels=1, **kw).place(np.float16(3.0)),
     ValueError),
    (lambda R, kw: R.PIMRuntime(channels=4, **kw).gemm(
        np.zeros((128, 128)), np.zeros((128, 128)), stack=0), ValueError),
    (lambda R, kw: R.PIMRuntime(channels=2, stacks=2, **kw).gemm(
        np.zeros((128, 8)), np.zeros((8, 8)), channels=(3, 4)),
     ValueError),
    (lambda R, kw: (lambda rt: rt.gemv(rt.place((128, 128)),
                                       np.zeros(128)))(
        R.PIMRuntime(channels=2, **kw)), AssertionError),
    (lambda R, kw: R.PIMRuntime(channels=2, **kw).gemv(
        R.PIMRuntime(channels=2, **kw).place((128, 128)), np.zeros(128),
        execute=False), AssertionError),
], ids=["17-channels", "place-1d", "place-3-tuple", "place-scalar",
        "stack-without-cluster", "subset-out-of-range",
        "analytic-handle-executed", "foreign-handle"])
def test_refusals_match_reference(call, exc):
    for pkg, kw in PACKAGES.values():
        with pytest.raises(exc):
            call(pkg, kw)


@pytest.mark.parametrize("name", sorted(JR.PLACEMENTS))
@pytest.mark.parametrize("m,k,n,channels", [
    (128, 64, 32, 1), (512, 4096, 512, 16), (256, 2048, 1, 16),
    (1000, 100, 7, 3), (64, 8, 1, 16), (2048, 256, 128, 3)])
def test_placements_match_reference(name, m, k, n, channels):
    want = JR.get_placement(name)(m, k, n, channels)
    got = TR.get_placement(name)(m, k, n, channels)
    TR.validate_cover(got, m, k, n)
    assert norm(got) == norm(want)
    assert [TR.shard_mac_passes(s) for s in got] == \
        [JR.shard_mac_passes(s) for s in want]


def test_bench_cluster_values():
    """``results/BENCH_runtime.json`` -> ``cluster``: makespan parity of
    16 channels as 1x16, 2x8 and 4x4 stacks, and the 4-stack scaling
    efficiencies of the paper-scale GEMM and the full-vocab GEMV
    (analytic, 0-strided operands), from the port alone."""
    want = json.loads(BENCH.read_text())["cluster"]
    z = lambda *s: np.broadcast_to(np.float16(0), s)     # noqa: E731
    for stacks, cps in [(1, 16), (2, 8), (4, 4)]:
        _, rep = TR.pim_gemm(z(512, 512), z(512, 512), channels=cps,
                             placement="2d-block", execute=False,
                             stacks=stacks, device="cpu")
        assert rep.makespan_cycles == want["parity_makespan"] == 294016

    def eff4(m, k, n, placement):
        mk = [TR.pim_gemm(z(m, k), z(k, n), channels=16,
                          placement=placement, execute=False, stacks=s,
                          device="cpu")[1].cluster_makespan_cycles
              for s in (1, 4)]
        return mk[0] / mk[1] / 4
    assert round(eff4(2048, 4096, 2048, "2d-block"), 6) \
        == want["gemm_eff_4stack"] == 0.994646
    assert round(eff4(151936, 8192, 1, "balanced"), 6) \
        == want["gemv_eff_4stack"] == 0.986539
