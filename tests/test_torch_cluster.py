"""The port's multi-stack cluster against the reference on the CPU.

Mirrors tests/test_cluster.py (the runtime half) with the harness of
test_torch_runtime.py: each op sequence runs on both packages, and the
reports, per-channel ledgers, host-link ledgers (shared and switched
topologies), traces and outputs must be ``==``.
"""
import numpy as np
import pytest

import repro.runtime as JR
import repro_torch.runtime as TR
from test_torch_runtime import check, norm, rand

#: (stacks, channels per stack, host-link topology): 1 to 4 stacks; one
#: stack has no link, so its topology is moot
CLUSTERS = [(1, 4, "shared"), (2, 2, "shared"), (2, 2, "switched"),
            (2, 4, "shared"), (3, 2, "switched"), (4, 2, "shared"),
            (4, 2, "switched")]


def cluster_ops(R, kw, stacks, cps, topology):
    """GEMMs under every placement (boxes replicated across stacks), a
    K-split GEMV whose partials drain across stacks, a place() that
    replicates, a stack-restricted op and an element-wise op on one
    cluster."""
    rng = np.random.default_rng(7)
    rt = R.PIMRuntime(channels=cps, stacks=stacks, link_topology=topology,
                      **kw)
    rec = {}
    a, b = rand(rng, 512, 32), rand(rng, 32, 16)
    for placement in sorted(R.PLACEMENTS):
        out, rep = rt.gemm(a, b, placement=placement)
        rec[placement] = (out, rep, rep.cluster_makespan_cycles,
                          rep.summary())
    rec["gemv k-split"] = rt.gemv(rand(rng, 128, 512), rand(rng, 512),
                                  placement="balanced")
    w = rt.place(rand(rng, 64, 24), placement="2d-block", role="B",
                 other_dim=256)
    rec["resident B"] = rt.gemm(rand(rng, 256, 64), w,
                                placement="2d-block")
    if stacks > 1:
        ws = rt.place(rand(rng, 256, 32), placement="balanced",
                      stack=stacks - 1)
        rec["stack-restricted"] = rt.gemv(ws, rand(rng, 32),
                                          placement="balanced",
                                          stack=stacks - 1)
    rec["ew"] = rt.elementwise("mul", rand(rng, 300, 32),
                               rand(rng, 300, 32), placement="balanced")
    rec["ledgers"] = rt.stack
    rec["trace"] = R.emit_trace(rt.stack)
    rec["stats"] = R.parse_trace(rec["trace"])
    return rec


def parity(R, kw, placement):
    """16 channels as 1x16, 2x8 and 4x4 stacks, analytic."""
    z = np.broadcast_to(np.float16(0), (512, 512))
    return {f"{s}x{c}": R.pim_gemm(z, z, channels=c, placement=placement,
                                   execute=False, stacks=s, **kw)
            for s, c in [(1, 16), (2, 8), (4, 4)]}


def scaling(R, kw):
    """BENCH_runtime.json's cluster sweep: 1/2/4 stacks of 16 channels
    for the paper-scale GEMM (2d-block) and full-vocab GEMV (balanced),
    analytic on 0-strided operands."""
    rec = {}
    for tag, (m, k, n), placement in [
            ("gemm", (2048, 4096, 2048), "2d-block"),
            ("gemv", (151936, 8192, 1), "balanced")]:
        a = np.broadcast_to(np.float16(0), (m, k))
        b = np.broadcast_to(np.float16(0), (k, n))
        for stacks in (1, 2, 4):
            rec[f"{tag} {stacks}"] = R.pim_gemm(
                a, b, channels=16, placement=placement, execute=False,
                stacks=stacks, **kw)
    return rec


def capacity_and_sync(R, kw):
    """Residency capacity and the synchronous-DMA model on a cluster."""
    rng = np.random.default_rng(3)
    rec = {}
    rt = R.PIMRuntime(channels=2, stacks=2, capacity_bytes=128 * 256 * 2,
                      overlap=False, **kw)
    w1 = rt.place(rand(rng, 512, 256), placement="balanced")
    w2 = rt.place(rand(rng, 512, 256), placement="balanced")
    x = rand(rng, 256)
    rec["w2"] = rt.gemv(w2, x, placement="balanced", execute=False)
    rec["w1"] = rt.gemv(w1, x, placement="balanced", execute=False)
    rec["ledgers"] = rt.stack
    rec["trace"] = R.emit_trace(rt.stack)
    return rec


@pytest.mark.parametrize("stacks,cps,topology", CLUSTERS,
                         ids=[f"{s}x{c}-{t}" for s, c, t in CLUSTERS])
def test_cluster_matches_reference(stacks, cps, topology):
    check(cluster_ops, stacks, cps, topology)


@pytest.mark.parametrize("placement", sorted(JR.PLACEMENTS))
def test_fixed_total_channels_parity_matches_reference(placement):
    check(parity, placement)
    reps = parity(TR, {"device": "cpu"}, placement)
    assert len({r.makespan_cycles for _, r in reps.values()}) == 1
    assert reps["1x16"][1].host_link_bytes == 0


@pytest.mark.parametrize("scenario", [scaling, capacity_and_sync],
                         ids=lambda f: f.__name__)
def test_scenario_matches_reference(scenario):
    check(scenario)


@pytest.mark.parametrize("placement", sorted(JR.PLACEMENTS))
def test_single_stack_cluster_is_the_bare_stack(placement):
    """A 1-stack cluster's ledgers and trace are the bare stack's, in the
    port as in the reference."""
    rng = np.random.default_rng(1)
    a, b = rand(rng, 300, 64), rand(rng, 64, 16)
    runs = []
    for stack in (TR.PIMStack(4, device="cpu"),
                  TR.PIMCluster(1, 4, device="cpu")):
        rt = TR.PIMRuntime(stack=stack)
        out, rep = rt.gemm(a, b, placement=placement)
        runs.append((norm(out), norm(rep), TR.emit_trace(rt.stack)))
    assert runs[0] == runs[1]


def test_stack_restricted_op_requires_a_cluster():
    for R, kw in ((JR, {}), (TR, {"device": "cpu"})):
        with pytest.raises(ValueError, match="stack="):
            R.PIMRuntime(channels=4, **kw).gemm(
                np.zeros((128, 128)), np.zeros((128, 128)), stack=0)
        with pytest.raises(ValueError, match="out of range"):
            R.PIMRuntime(channels=2, stacks=2, **kw).gemm(
                np.zeros((128, 128)), np.zeros((128, 128)), stack=5)
        with pytest.raises(ValueError, match="link_topology"):
            R.PIMCluster(2, 2, link_topology="ring", **kw)


@pytest.mark.parametrize("stacks,cps", [(2, 2), (3, 4)])
def test_cluster_device_addresses_stack_and_channel(stacks, cps):
    """``PIMCluster.device(stack, channel)`` is the reference's accessor:
    the device at those coordinates, with the reference's flat channel
    id; the torch device the engines compute on is ``torch_device``."""
    ref = JR.PIMCluster(stacks, cps)
    port = TR.PIMCluster(stacks, cps, device="cpu")
    assert port.torch_device.type == "cpu"
    for s in range(stacks):
        for c in range(cps):
            dev = port.device(s, c)
            assert dev is port.stacks[s].devices[c]
            assert dev is port[port.flat(s, c)]
            assert dev.channel_id == ref.device(s, c).channel_id
            assert dev.engine.device == port.torch_device
