"""The port's paged KV-cache residency against the reference on the CPU.

Mirrors the runtime half of tests/test_kvcache.py with the harness of
test_torch_runtime.py: ``PagedTensor`` growth, ``KVCacheManager``
appends, capacity eviction, restore and release, the KVAPPEND / KVEVICT
trace markers, and a decode attention step on the paged residency (score
GEMV, the in-place softmax, context GEMV), serialized and async.  Ledgers,
summaries and traces must be ``==``; the softmax's probabilities are held
at one float16 ulp and the context GEMV that reads them near the
reference's.
"""
import numpy as np
import pytest
import torch

import repro.runtime as JR
import repro_torch.runtime as TR
from test_torch_runtime import PACKAGES, assert_records_equal, norm, \
    run_both

#: context GEMV outputs read probabilities one float16 ulp apart at most:
#: each sum of ~300 products of O(0.05) values moves by far less than this
NEAR = dict(atol=2e-3, rtol=1e-2)


def _mgr(R, rt, channels, **kw):
    chans = tuple(range(channels))
    kw.setdefault("n_layers", 1)
    kw.setdefault("n_kv_heads", 1)
    kw.setdefault("head_dim", 64)
    return R.KVCacheManager(rt, channels_for_layer=lambda ell: chans, **kw)


def paged_tensors(R, kw):
    """In-place growth on both axes, the trailing page's box growing and
    its re-mark superseding the old box."""
    rng = np.random.default_rng(0)
    rt = R.PIMRuntime(channels=4, **kw)
    rec = {}
    t = R.PagedTensor(rt.stack, 64, grow_axis=0, numeric=True)
    for count in (100, 60):
        rec[f"first page {count}"] = t.append(
            count, rng.standard_normal((count, 64)).astype(np.float16))
        rec[f"values {count}"] = t.values
        rec[f"shape {count}"] = (t.shape, t.tokens, t.num_blocks)
    vt = R.PagedTensor(rt.stack, 32, grow_axis=1, numeric=True)
    vt.append(130, rng.standard_normal((32, 130)).astype(np.float16))
    rec["transposed"] = (vt.values, vt.shape, vt.block_box(1))
    g = R.PagedTensor(rt.stack, 64, grow_axis=0)
    g.append(100)
    g.mark_resident(0, g.block_box(0))
    g.append(28)
    g.mark_resident(0, g.block_box(0))
    rec["ledgers"] = rt.stack
    return rec


def kv_lifecycle(R, kw, async_mode):
    """Prefill appends, steady decode appends, capacity pressure that
    evicts the coldest request's oldest pages, restore before that
    request decodes, release, trace markers and the summary."""
    rt = R.PIMRuntime(channels=4, async_mode=async_mode, **kw)
    kv = _mgr(R, rt, 4, n_layers=2, n_kv_heads=2,
              capacity_bytes=600 * 64 * 2 * 2 * 2)
    rec = {}
    for rid in ("cold", "hot"):
        kv.request(rid)
        kv.begin_decode(rid)
        for layer in range(2):
            rec[f"prefill {rid} {layer}"] = kv.append_tokens(rid, layer, 140)
    for step in range(3):
        kv.begin_decode("hot")
        for layer in range(2):
            rec[f"decode {step} {layer}"] = kv.append_tokens(
                "hot", layer, 1 + 60 * step)
    rec["evicted"] = {rid: sorted(kv._reqs[rid].evicted)
                      for rid in ("cold", "hot")}
    kv.begin_decode("cold")                   # restores its pages
    rec["after restore"] = kv.summary()
    rec["released"] = kv.release("hot")
    rec["released again"] = kv.release("hot")
    rec["summary"] = kv.summary()
    rec["resident"] = kv.resident_kv_bytes
    rec["ledgers"] = rt.stack
    rec["trace"] = R.emit_trace(rt.stack)
    rec["stats"] = R.parse_trace(rec["trace"])
    if async_mode:
        rec["ops"] = [(h.op_id, h.name, h.deps, h.start, h.retire, h.spans)
                      for h in rt.timeline.ops]
    return rec


def attention_step(R, kw, async_mode):
    """One decode step's attention on resident pages: K @ q kept on
    device, softmax in place, V^T @ probs; only q crosses the bus."""
    rng = np.random.default_rng(0)
    rt = R.PIMRuntime(channels=8, async_mode=async_mode, **kw)
    kv = _mgr(R, rt, 8, numeric=True)
    hd, group, tokens = 64, 2, 300
    kv.request("r")
    kv.append_tokens(
        "r", 0, tokens,
        k_vals=[(rng.standard_normal((tokens, hd)) * 0.05)
                .astype(np.float16)],
        v_vals=[(rng.standard_normal((hd, tokens)) * 0.05)
                .astype(np.float16)])
    k, vt = kv.tensors("r", 0, 0)
    q = (rng.standard_normal((hd, group)) * 0.05).astype(np.float16)
    rec = {}
    res = rt.gemm(k, q, placement="paged", keep_output=True)
    scores = res.result if async_mode else res[0]
    rec["scores"] = scores.values.clone() if isinstance(
        scores.values, torch.Tensor) else np.array(scores.values)
    res = rt.softmax(scores, placement="paged")
    rec["softmax report"] = res.report if async_mode else res[1]
    rec["ulp:probs"] = scores.values
    res = rt.gemm(vt, scores, placement="paged")
    y, rec["context report"] = (res.result, res.report) if async_mode \
        else res
    rec["near:context"] = y
    rec["ledgers"] = rt.stack
    rec["trace"] = R.emit_trace(rt.stack)
    return rec


@pytest.mark.parametrize("scenario", [paged_tensors],
                         ids=lambda f: f.__name__)
def test_paged_tensors_match_reference(scenario):
    assert_records_equal(*run_both(scenario))


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["serialized", "async"])
def test_kv_lifecycle_matches_reference(async_mode):
    ref, port = run_both(kv_lifecycle, async_mode)
    assert ref["evicted"]["cold"] and ref["summary"]["evictions"] > 0
    assert_records_equal(ref, port)


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["serialized", "async"])
def test_attention_step_matches_reference(async_mode):
    ref, port = run_both(attention_step, async_mode)
    got = port.pop("near:context")
    want = ref.pop("near:context")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **NEAR)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float16
    assert_records_equal(ref, port)


def test_numeric_pages_live_on_the_runtime_device():
    rt = TR.PIMRuntime(channels=2, device="cpu")
    t = TR.PagedTensor(rt.stack, 8, grow_axis=1, numeric=True)
    t.append(3, torch.ones(8, 3))
    assert t.values.dtype == torch.float16 and t.values.shape == (8, 3)
    assert t.values.device == rt.device
    with pytest.raises(ValueError):
        t.append(0)


@pytest.mark.parametrize("m,k,n,c", [
    (1, 64, 4, 8), (64, 64, 1, 1), (128, 64, 2, 4), (200, 64, 2, 8),
    (512, 64, 2, 4), (64, 200, 2, 8), (64, 640, 4, 3)])
def test_paged_placement_matches_reference(m, k, n, c):
    want = JR.paged(m, k, n, c)
    got = TR.paged(m, k, n, c)
    TR.validate_cover(got, m, k, n)
    assert norm(got) == norm(want)
    # the fixed policies stay memoized, paged never is
    assert TR.placement_shards("paged", m, k, n, c) is not \
        TR.placement_shards("paged", m, k, n, c)
    assert TR.placement_shards("balanced", m, k, n, c) is \
        TR.placement_shards("balanced", m, k, n, c)


def test_kv_manager_refuses_a_head_dim_past_one_page():
    for R, kw in PACKAGES.values():
        with pytest.raises(ValueError, match="head_dim"):
            _mgr(R, R.PIMRuntime(channels=2, **kw), 2, head_dim=129)
