"""The port's ``core`` (AME instructions on the Aquabolt-XL PIM model)
against the JAX reference ``repro.core`` on the CPU.

The same seeded numpy FP16 tiles go through both packages: the engine's
outputs must be bit-identical (to the reference engine and to the strict
interpreter), its ledgers and ``PEPCostReport``s equal, the paper's
headline numbers the same.  Mirrors the runtime-free tests of
tests/test_core_pim.py, tests/test_core_properties.py and the engine/cost
half of tests/test_fastpath.py at small shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import cost as jcost
from repro.core import engine as jengine
from repro.core import pep as jpep
from repro_torch import core as tcore
from repro_torch.core import cost as tcost
from repro_torch.core import engine as tengine
from repro_torch.core import isa as tisa
from repro_torch.core import pep as tpep

F16 = np.float16
RNG = np.random.default_rng(0)


def rand_tile(m, c, scale=1.0):
    return (RNG.standard_normal((m, c)) * scale).astype(F16)


def bits(x) -> np.ndarray:
    """FP16 bit patterns of a tensor or array (bit-exact comparisons)."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x, F16).view(np.int16)


def assert_bit_equal(got, want):
    assert np.array_equal(bits(got), bits(want))


def engine():
    return tengine.AMEEngine(device="cpu")


def report(r):
    """A PEPCostReport's fields, comparable across the two packages."""
    return dataclasses.astuple(r)


def oracle_gemm_f16(a, b):
    """Ascending-k outer products, one FP16 rounding per fused MAC."""
    acc = np.zeros((a.shape[0], b.shape[1]), F16)
    for kk in range(a.shape[1]):
        acc = (acc.astype(np.float32)
               + a[:, kk:kk + 1].astype(np.float32)
               @ b[kk:kk + 1, :].astype(np.float32)).astype(F16)
    return acc


def oracle_sub_f16(a, b):
    return (a + (b * F16(-1.0)).astype(F16)).astype(F16)


def strict_ew(pep, kind, a, b):
    ch, mm = pep.init_channel(nblocks=4096, b_region_blocks=64,
                              tile_cols=64)
    pep.tile_to_banks(ch.state.even_banks, mm.tiles[0], a)
    pep.tile_to_banks(ch.state.even_banks, mm.tiles[1], b)
    cmds = pep.run_ew_strict(ch, mm, kind, mm.tiles[0], mm.tiles[1],
                             mm.accs[0], a.shape[1])
    return pep.banks_to_tile(ch.state.odd_banks, mm.accs[0], *a.shape), cmds


def strict_mac(pep, a, b, acc0=None):
    m, k = a.shape
    n = b.shape[1]
    ch, mm = pep.init_channel(nblocks=4096, b_region_blocks=64,
                              tile_cols=64)
    pep.tile_to_banks(ch.state.even_banks, mm.tiles[0], a)
    pep.scalars_to_bank0(ch.state.even_banks, mm.b_scalars, b.T)
    pep.tile_to_banks(ch.state.odd_banks, mm.accs[0],
                      np.zeros((m, n), F16) if acc0 is None else acc0)
    cmds = pep.run_mac_strict(ch, mm, mm.tiles[0], mm.accs[0], k, n)
    return pep.banks_to_tile(ch.state.odd_banks, mm.accs[0], m, n), cmds


# ---------------------------------------------------------------------------
# strict interpreter (the numpy copy) vs the reference's and the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,m,c", [
    ("add", 128, 16), ("add", 37, 24), ("mul", 128, 8), ("mul", 16, 40),
    ("sub", 128, 16), ("sub", 64, 8),
])
def test_strict_elementwise(kind, m, c):
    a, b = rand_tile(m, c), rand_tile(m, c)
    got, cmds = strict_ew(tpep, kind, a, b)
    want, jcmds = strict_ew(jpep, kind, a, b)
    assert_bit_equal(got, want)
    assert cmds == jcmds
    oracle = {"add": lambda: (a + b).astype(F16),
              "mul": lambda: (a * b).astype(F16),
              "sub": lambda: oracle_sub_f16(a, b)}[kind]()
    assert_bit_equal(got, oracle)
    passes = sum(p for _, p in tpep.ew_invocations(c))
    per = {"add": 24, "mul": 24, "sub": 32}[kind]
    extra = 8 * len(tpep.ew_invocations(c)) if kind == "sub" else 0
    assert cmds == passes * per + extra


@pytest.mark.parametrize("m,k,n", [(128, 8, 4), (128, 16, 2), (64, 24, 3),
                                   (128, 8, 1), (16, 8, 8)])
def test_strict_mac_outer_product(m, k, n):
    a, b = rand_tile(m, k, 0.5), rand_tile(k, n, 0.5)
    got, cmds = strict_mac(tpep, a, b)
    want, jcmds = strict_mac(jpep, a, b)
    assert_bit_equal(got, want)
    assert_bit_equal(got, oracle_gemm_f16(a, b))
    passes = sum(i.passes for i in tpep.mac_invocations(k, n))
    assert cmds == jcmds == passes * 26


def test_strict_mac_accumulates_into_existing_acc():
    a, b, acc0 = rand_tile(128, 8), rand_tile(8, 4), rand_tile(128, 4)
    got, _ = strict_mac(tpep, a, b, acc0)
    ref = acc0.copy()
    for kk in range(8):
        ref = (ref.astype(np.float32)
               + a[:, kk:kk + 1].astype(np.float32)
               @ b[kk:kk + 1, :].astype(np.float32)).astype(F16)
    assert_bit_equal(got, ref)
    assert_bit_equal(got, strict_mac(jpep, a, b, acc0)[0])


# ---------------------------------------------------------------------------
# fast engine: bit-exact with the strict interpreter and the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(128, 16, 4), (96, 8, 8), (128, 40, 2)])
def test_fast_engine_bitexact_vs_strict(m, k, n):
    a, b = rand_tile(m, k, 0.5), rand_tile(k, n, 0.5)
    strict, _ = strict_mac(tpep, a, b)
    outs = []
    for eng in (engine(), jengine.AMEEngine()):
        eng.msettilem(m), eng.msettilek(k), eng.msettilen(n)
        eng.mld(0, a)
        eng.mld(1, b)
        rep = eng.mfmacc(0, 0, 1)
        outs.append((eng.mst(0), report(rep)))
    assert_bit_equal(outs[0][0], strict)
    assert_bit_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


@pytest.mark.parametrize("kind", ["add", "mul", "sub"])
def test_fast_engine_elementwise_bitexact_vs_strict(kind):
    m, c = 77, 19
    a, b = rand_tile(m, c), rand_tile(m, c)
    strict, _ = strict_ew(tpep, kind, a, b)
    outs = []
    for eng in (engine(), jengine.AMEEngine()):
        eng.msettilem(m), eng.msettilek(c)
        eng.mld(0, a)
        eng.mld(1, b)
        rep = getattr(eng, f"mf{kind}")(0, 0, 1)
        outs.append((eng.mst(0), report(rep)))
    assert_bit_equal(outs[0][0], strict)
    assert_bit_equal(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


def test_engine_holds_f16_tensors_on_its_device():
    eng = engine()
    eng.mld(0, rand_tile(8, 8).astype(np.float64))
    eng.mld(1, torch.randn(8, 8))
    eng.mfadd(2, 0, 1)
    out = eng.mst(2)
    assert isinstance(out, torch.Tensor)
    assert out.dtype == torch.float16 and out.device.type == "cpu"


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        assert tengine.AMEEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengine.AMEEngine()


def test_numpy_operands_round_once_to_f16():
    """A float64 operand rounds directly to FP16, as the reference's
    ``jnp.asarray(x, float16)`` does (no detour through f32)."""
    x = RNG.standard_normal((64, 64)) * 0.3
    eng = engine()
    eng.mld(0, x)
    assert_bit_equal(eng.tr[0].resolve(), x.astype(F16))


# ---------------------------------------------------------------------------
# AME semantics: Table-1 mapping, CSRs, pointer table
# ---------------------------------------------------------------------------


def test_table1_unsupported_ops_raise():
    eng = engine()
    eng.mld(0, rand_tile(8, 8))
    eng.mld(1, rand_tile(8, 8))
    with pytest.raises(tcore.UnsupportedOnPIM):
        eng.mfmax(0, 0, 1)
    with pytest.raises(tcore.UnsupportedOnPIM):
        eng.mfmin(0, 0, 1)
    with pytest.raises(tcore.UnsupportedOnPIM):
        eng.mfmacc(0, 0, 1, widen=True)
    with pytest.raises(tcore.UnsupportedOnPIM):
        tisa.pim_mapping(tisa.AMEOp.MFMACC_WIDEN)
    assert issubclass(tcore.UnsupportedOnPIM, NotImplementedError)


def test_table1_mapping_equals_the_reference():
    from repro.core import isa as jisa
    assert {op.value: None if seq is None else tuple(o.value for o in seq)
            for op, seq in tisa.AME_TO_PIM.items()} == \
        {op.value: None if seq is None else tuple(o.value for o in seq)
         for op, seq in jisa.AME_TO_PIM.items()}
    assert tisa.pim_mapping(tisa.AMEOp.MFSUB_MM) == (tisa.PIMOpcode.MUL,
                                                     tisa.PIMOpcode.ADD)
    for name in ("SIMD_LANES", "PIM_UNITS", "ROWNUM", "TILE_MAX_COLS",
                 "JUMP_MAX_ITERS", "AAM_BLOCKS", "PIM_FREQ_HZ",
                 "THEORETICAL_PEAK_FLOP_PER_CYCLE"):
        assert getattr(tisa, name) == getattr(jisa, name)


def test_csr_clamping():
    eng = engine()
    assert eng.msettilem(1000) == tisa.ROWNUM
    assert eng.msettilek(10 ** 6) == 4096
    assert eng.msettilen(0) == 1


def test_pointer_table_transposed_load_and_slide():
    eng = engine()
    a = rand_tile(16, 32)
    eng.mld_t(0, a)                       # zero-copy transpose
    assert eng.tr[0].shape == (32, 16)
    assert_bit_equal(eng.tr[0].resolve(), a.T)
    eng.mslide(0, rows=2, cols=1)
    assert eng.tr[0].shape == (30, 15)
    assert_bit_equal(eng.tr[0].resolve(), a.T[2:, 1:])
    eng.mmov(1, 0)
    assert eng.tr[1].shape == eng.tr[0].shape
    # a transposed, slid operand feeds mfmacc as the reference's does
    b = rand_tile(15, 4)
    outs = []
    for e in (eng, jengine.AMEEngine()):
        e.mld_t(0, a)
        e.mslide(0, rows=2, cols=1)
        e.mld(2, b)
        e.msettilem(30), e.msettilek(15), e.msettilen(4)
        e.mfmacc(0, 0, 2)
        outs.append(e.mst(0))
    assert_bit_equal(outs[0], outs[1])


def test_mv_broadcast_form():
    a, v = rand_tile(32, 16), rand_tile(1, 16)[0]
    outs = []
    for eng in (engine(), jengine.AMEEngine()):
        eng.msettilem(32), eng.msettilek(16)
        eng.mld(0, a)
        eng.mfadd(0, 0, v)                # .mv.i form
        eng.mbc_v(1, v, 32)               # mbc.v then the .mm form
        eng.mfmul(1, 0, 1)
        outs.append((eng.mst(0), eng.mst(1)))
    assert_bit_equal(outs[0][0], (a + np.broadcast_to(v, a.shape)).astype(F16))
    assert_bit_equal(outs[0][0], outs[1][0])
    assert_bit_equal(outs[0][1], outs[1][1])


def test_mrelease_clears_registers():
    eng = engine()
    eng.mld(0, rand_tile(4, 4))
    eng.mld_acc(1, rand_tile(4, 4))
    eng.mrelease()
    assert all(h is None for h in eng.tr.values())
    assert all(h is None for h in eng.acc.values())


# ---------------------------------------------------------------------------
# cost model: equal reports, the paper's headline (§4, Figs 7-9, Table 3)
# ---------------------------------------------------------------------------


def test_paper_headline_numbers():
    s = tcost.summary()
    assert s == jcost.summary()
    assert abs(s["mfmacc_flop_per_cycle_saturated"] - 59.4) < 0.1
    assert abs(s["mfmacc_flop_per_cycle_saturated"] * 250e6 / 1e9
               - 14.9) < 0.1
    assert s["mfmacc_launches_maxtile"] == 256
    assert s["setup_share_maxtile"] < 0.01
    assert s["mfmacc_flop_per_cycle_saturated"] <= 64.0
    assert report(tcore.max_tile_mfmacc()) == report(jcost.max_tile_mfmacc())
    assert tcore.max_tile_mfmacc().launches == 256


#: the rows of benchmarks/paper_figures.py fig7, fig8, fig9 (Table 3 reads
#: the saturated rate, held above)
COST_ROWS = ([("ew", kind, 128, 2048, None) for kind in ("add", "mul", "sub")]
             + [("ew", kind, 128, 4096, None)
                for kind in ("add", "mul", "sub")]
             + [("mac", None, 128, k, 1)
                for k in (8, 16, 64, 128, 256, 512, 1024, 2048)]
             + [("mac", None, 128, 8, 256), ("mac", None, 128, 4096, 128),
                ("ew", "sub", 37, 300, None), ("mac", None, 77, 33, 5)])


@pytest.mark.parametrize("what,kind,m,k,n", COST_ROWS)
def test_cost_reports_equal_the_reference(what, kind, m, k, n):
    if what == "ew":
        got, want = tcost.elementwise_cost(kind, m, k), \
            jcost.elementwise_cost(kind, m, k)
    else:
        got, want = tcost.mfmacc_cost(m, k, n), jcost.mfmacc_cost(m, k, n)
    assert report(got) == report(want)
    assert got.flop_per_cycle == want.flop_per_cycle
    assert got.gflops == want.gflops


def test_saturated_rates_equal_the_reference():
    for kind in ("mac", "add", "mul", "sub"):
        assert tcost.saturated_flop_per_cycle(kind) == \
            jcost.saturated_flop_per_cycle(kind)
    assert tcost.saturated_flop_per_cycle("mac") > 58.1   # Table 3


def test_mac_invocation_decomposition():
    assert len(tpep.mac_invocations(2048, 1)) == 1
    assert len(tpep.mac_invocations(8, 256)) == 1
    assert len(tpep.mac_invocations(4096, 128)) == 256
    k, n = 48, 3
    invs = tpep.mac_invocations(k, n)
    coords = [tpep.mac_pass_coords(i.start + t, k)
              for i in invs for t in range(i.passes)]
    assert coords == [(j, 8 * c) for j in range(n) for c in range(6)]
    assert [dataclasses.astuple(i) for i in invs] == \
        [dataclasses.astuple(i) for i in jpep.mac_invocations(k, n)]


def test_elementwise_double_invocation_at_max_tile():
    assert tcost.elementwise_cost("add", 128, 4096).launches == 2
    assert tcost.mfmacc_cost(128, 4096, 128).launches == 256


def test_fig9_scaling_monotone_saturation():
    sizes = [8, 32, 128, 512, 1024, 2048]
    effs = [tcost.mfmacc_cost(128, s, 1).flop_per_cycle for s in sizes]
    assert all(b > a for a, b in zip(effs, effs[1:]))
    assert effs[-1] > 0.95 * tcost.saturated_flop_per_cycle("mac")
    assert effs[0] < 0.5 * effs[-1]


def test_sub_slower_than_add():
    add = tcost.elementwise_cost("add", 128, 2048)
    sub = tcost.elementwise_cost("sub", 128, 2048)
    assert sub.cycles > add.cycles
    assert sub.flop_per_cycle < add.flop_per_cycle


def test_no_multi_channel_flop_scaling():
    eng = engine()
    eng.mld(0, rand_tile(128, 64))
    eng.mld(1, rand_tile(64, 4))
    eng.msettilek(64), eng.msettilen(4)
    r = eng.mfmacc(0, 0, 1)
    assert r.flops == 2 * 128 * 64 * 4
    assert r.cycles == tcost.mfmacc_cost(128, 64, 4).cycles
    assert not hasattr(eng, "channels")


# ---------------------------------------------------------------------------
# closed-form shard costs == the tile walk, equal to the reference
# (tests/test_fastpath.py:71-126)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,ks,ns", [
    (1, 1, 1), (127, 7, 1), (128, 4096, 128), (129, 4097, 2),
    (256, 8192, 129), (1000, 100, 7), (512, 4096, 512)])
def test_gemm_shard_cost_equals_tile_walk(rows, ks, ns):
    walk = [tcost.mfmacc_cost(i1 - i0, c1 - c0, j1 - j0)
            for i0, i1, j0, j1, c0, c1 in tengine.gemm_tiles(rows, ks, ns)]
    agg = tcost.gemm_shard_cost(rows, ks, ns)
    assert agg.launches == sum(r.launches for r in walk)
    assert agg.passes == sum(r.passes for r in walk)
    assert agg.commands == sum(r.commands for r in walk)
    assert agg.flops == sum(r.flops for r in walk)
    assert agg.cycles == sum(r.cycles for r in walk)
    assert report(agg) == report(jcost.gemm_shard_cost(rows, ks, ns))
    assert list(tengine.gemm_tiles(rows, ks, ns)) == \
        list(jengine.gemm_tiles(rows, ks, ns))


@pytest.mark.parametrize("kind", ["add", "sub", "mul"])
@pytest.mark.parametrize("rows,cols", [(1, 1), (127, 4097), (128, 2048),
                                       (300, 96), (1000, 8200)])
def test_ew_shard_cost_equals_tile_walk(kind, rows, cols):
    walk = [tcost.elementwise_cost(kind, i1 - i0, c1 - c0)
            for i0, i1, c0, c1 in tengine.ew_tiles(rows, cols)]
    agg = tcost.ew_shard_cost(kind, rows, cols)
    assert agg.launches == sum(r.launches for r in walk)
    assert agg.commands == sum(r.commands for r in walk)
    assert agg.flops == sum(r.flops for r in walk)
    assert agg.cycles == sum(r.cycles for r in walk)
    assert report(agg) == report(jcost.ew_shard_cost(kind, rows, cols))


def test_shard_span_expands_to_walk_records():
    span = tengine.ShardSpan("mac", 300, 4200, 130)
    walk = [(i1 - i0, c1 - c0, j1 - j0)
            for i0, i1, j0, j1, c0, c1 in tengine.gemm_tiles(300, 4200, 130)]
    assert [(r.m, r.k, r.n) for r in span.records()] == walk
    span = tengine.ShardSpan("sub", 300, 4200)
    assert [(r.m, r.k) for r in span.records()] == \
        [(i1 - i0, c1 - c0) for i0, i1, c0, c1 in tengine.ew_tiles(300, 4200)]
    assert [dataclasses.astuple(r) for r in span.records()] == \
        [dataclasses.astuple(r)
         for r in jengine.ShardSpan("sub", 300, 4200).records()]


def _ledger(eng):
    return (eng.total_cycles, eng.total_flops, eng.total_commands,
            [report(r) for r in eng.log],
            [dataclasses.astuple(r) for r in eng.instrs])


@pytest.mark.parametrize("m,k,n", [(128, 64, 32), (300, 520, 130),
                                   (129, 4097, 2), (64, 8, 1)])
def test_engine_batched_gemm_bit_exact(m, k, n):
    rng = np.random.default_rng(19)
    a = (rng.standard_normal((m, k)) * 0.2).astype(F16)
    b = (rng.standard_normal((k, n)) * 0.2).astype(F16)
    e1, e2, j1, j2 = engine(), engine(), jengine.AMEEngine(), \
        jengine.AMEEngine()
    out_t = tengine.gemm_on_engine(e1, a, b)
    out_b = tengine.gemm_on_engine_batched(e2, a, b)
    assert_bit_equal(out_t, out_b)
    assert_bit_equal(out_b, jengine.gemm_on_engine_batched(j2, a, b))
    assert_bit_equal(out_t, jengine.gemm_on_engine(j1, a, b))
    assert e1.total_cycles == e2.total_cycles
    assert e1.total_flops == e2.total_flops
    assert e1.total_commands == e2.total_commands
    assert sum(r.launches for r in e1.log) == sum(r.launches for r in e2.log)
    assert _ledger(e1) == _ledger(j1)
    assert _ledger(e2) == _ledger(j2)
    if m <= 128 and k * n <= 512:     # fits strict_mac's channel map
        assert_bit_equal(out_b, strict_mac(tpep, a, b)[0])


@pytest.mark.parametrize("kind", ["add", "sub", "mul"])
def test_engine_batched_ew_bit_exact(kind):
    rng = np.random.default_rng(19)
    a = (rng.standard_normal((300, 4200)) * 0.2).astype(F16)
    b = (rng.standard_normal((300, 4200)) * 0.2).astype(F16)
    e1, e2, j1, j2 = engine(), engine(), jengine.AMEEngine(), \
        jengine.AMEEngine()
    out_t = tengine.ew_on_engine(e1, kind, a, b)
    out_b = tengine.ew_on_engine_batched(e2, kind, a, b)
    assert_bit_equal(out_t, out_b)
    assert_bit_equal(out_b, jengine.ew_on_engine_batched(j2, kind, a, b))
    assert_bit_equal(out_t, jengine.ew_on_engine(j1, kind, a, b))
    assert _ledger(e1) == _ledger(j1)
    assert _ledger(e2) == _ledger(j2)
    small_a, small_b = a[:77, :19], b[:77, :19]
    assert_bit_equal(tengine.ew_on_engine_batched(engine(), kind, small_a,
                                                  small_b),
                     strict_ew(tpep, kind, small_a, small_b)[0])


# ---------------------------------------------------------------------------
# properties (tests/test_core_properties.py), guarded as there
# ---------------------------------------------------------------------------

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

dims = st.integers(min_value=1, max_value=512)
small = st.integers(min_value=1, max_value=48)


@given(k=dims, n=dims)
@settings(max_examples=40, deadline=None)
def test_mac_schedule_is_a_partition(k, n):
    invs = tpep.mac_invocations(k, n)
    assert all(1 <= i.passes <= tisa.JUMP_MAX_ITERS for i in invs)
    total = sum(i.passes for i in invs)
    assert total == -(-k // tisa.AAM_BLOCKS) * n
    assert [i.start for i in invs] == list(
        np.cumsum([0] + [i.passes for i in invs[:-1]]))
    seen = {tpep.mac_pass_coords(i.start + t, k)
            for i in invs for t in range(i.passes)}
    assert len(seen) == total
    assert [dataclasses.astuple(i) for i in invs] == \
        [dataclasses.astuple(i) for i in jpep.mac_invocations(k, n)]


@given(c=dims)
@settings(max_examples=40, deadline=None)
def test_ew_invocations_cover_columns(c):
    invs = tpep.ew_invocations(c)
    cols = []
    for col0, passes in invs:
        assert 1 <= passes <= tisa.JUMP_MAX_ITERS
        cols.extend(range(col0, col0 + passes * tisa.AAM_BLOCKS,
                          tisa.AAM_BLOCKS))
    assert cols == sorted(set(cols))
    assert cols[0] == 0 and cols[-1] + tisa.AAM_BLOCKS >= c
    assert invs == jpep.ew_invocations(c)


@given(m=st.integers(2, 128), k=small, n=st.integers(1, 8),
       seed=st.integers(0, 2 ** 16))
@settings(max_examples=20, deadline=None)
def test_mfmacc_linearity_in_blocks(m, k, n, seed):
    """Splitting K across two mfmacc calls == one call."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, k)) * 0.25).astype(F16)
    b = (rng.standard_normal((k, n)) * 0.25).astype(F16)
    e1 = engine()
    e1.msettilem(m), e1.msettilek(k), e1.msettilen(n)
    e1.mld(0, a), e1.mld(1, b)
    e1.mfmacc(0, 0, 1)
    one = e1.mst(0)
    ks = max(1, (k // 2 // tisa.AAM_BLOCKS) * tisa.AAM_BLOCKS) \
        if k > tisa.AAM_BLOCKS else k
    e2 = engine()
    e2.msettilem(m), e2.msettilen(n)
    for lo, hi in ((0, ks), (ks, k)):
        if hi <= lo:
            continue
        e2.msettilek(hi - lo)
        e2.mld(0, a[:, lo:hi]), e2.mld(1, b[lo:hi])
        e2.mfmacc(0, 0, 1)
    assert_bit_equal(one, e2.mst(0))
    assert_bit_equal(one, oracle_gemm_f16(a, b))


@given(m=st.integers(1, 128), k=dims, n=dims)
@settings(max_examples=40, deadline=None)
def test_cost_monotone_and_positive(m, k, n):
    r = tcost.mfmacc_cost(m, k, n)
    assert r.cycles > r.commands > 0
    assert r.flops == 2 * m * k * n
    assert r.flop_per_cycle <= tcost.saturated_flop_per_cycle("mac") + 1e-9
    assert r.flop_per_cycle_isa > r.flop_per_cycle
    assert report(r) == report(jcost.mfmacc_cost(m, k, n))


@given(kind=st.sampled_from(["add", "mul", "sub"]),
       m=st.integers(1, 128), c=dims)
@settings(max_examples=40, deadline=None)
def test_elementwise_cost_lane_waste(kind, m, c):
    r = tcost.elementwise_cost(kind, m, c)
    full = tcost.elementwise_cost(kind, 128, c)
    assert r.cycles == full.cycles
    assert r.flops == m * c
    assert report(r) == report(jcost.elementwise_cost(kind, m, c))
