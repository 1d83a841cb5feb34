"""The port's serving loop, cost model and configs against the reference.

A JAX ``Server`` and the port's ``Server`` (``backend="kernel"`` on the
CPU, so every projection takes the kernel's plain version) get the same
parameters and the same seeded requests: their greedy tokens must be
equal, and with the reference's hardware constants their virtual-time
latency summaries must be ``==`` — also with a PIM decode offload
attached (``pim_offload=``) and serve faults knocking requests out
(``faults=``), where the retries, failures, sheds and the sidecar's step
records must be ``==`` too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.launch import hw as jhw
from repro.models import model as jlm
from repro.serve.loop import Request as JRequest
from repro.serve.loop import Server as JServer
from repro.serve.traffic import HostCostModel as JHostCostModel
from repro_torch.configs import get
from repro_torch.models import convert
from repro_torch.models import model as lm
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.loop import AdmissionError, Request, Server
from repro_torch.serve.offload import DecodeOffload
from repro_torch.serve.traffic import HostCostModel
from test_torch_offload import ERR_FIELDS, ERR_TOL

SLOTS, CACHE_LEN = 2, 40


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    out = []
    for uid in range(5):
        plen = int(rng.choice([8, 13]))     # two lengths: two JAX compiles
        out.append(cls(uid=uid,
                       prompt=rng.integers(0, vocab, plen).astype(np.int32),
                       max_new=int(rng.integers(3, 8))))
    return out


@pytest.fixture(scope="module")
def served():
    jcfg, cfg = jget("qwen3-1.7b").reduced(), get("qwen3-1.7b").reduced()
    jp = jlm.init(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    jsrv = JServer(jcfg, jp, slots=SLOTS, cache_len=CACHE_LEN)
    cost = HostCostModel(cfg, peak_flops=jhw.PEAK_FLOPS, hbm_bw=jhw.HBM_BW)
    srv = Server(cfg, params, slots=SLOTS, cache_len=CACHE_LEN, cost=cost,
                 backend="kernel", device="cpu", metrics=MetricsRegistry())
    for s, cls in ((jsrv, JRequest), (srv, Request)):
        for req in _requests(cls, cfg.vocab_size):
            s.submit(req)
        s.run_until_drained()
    return jsrv, srv


def test_same_requests_give_same_tokens(served):
    jsrv, srv = served
    want = {r.uid: r.out_tokens for r in jsrv.completed}
    got = {r.uid: r.out_tokens for r in srv.completed}
    assert len(got) == 5 and got == want
    assert all(len(t) >= 2 for t in got.values())


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_moe_families_serve_the_same_tokens_and_times(name):
    """Reduced mixtral-8x22b and deepseek-v3-671b through both servers:
    the decode batch runs both slots (an empty one included) through the
    MoE's capacity-limited routing, and the tokens, the virtual-time
    summary and the cache splice of the latent MLA cache all agree."""
    jcfg, cfg = jget(name).reduced(), get(name).reduced()
    jp = jax.jit(jlm.init, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    jsrv = JServer(jcfg, jp, slots=SLOTS, cache_len=CACHE_LEN)
    cost = HostCostModel(cfg, peak_flops=jhw.PEAK_FLOPS, hbm_bw=jhw.HBM_BW)
    srv = Server(cfg, params, slots=SLOTS, cache_len=CACHE_LEN, cost=cost,
                 backend="kernel", device="cpu")
    for s, cls in ((jsrv, JRequest), (srv, Request)):
        for req in _requests(cls, cfg.vocab_size):
            s.submit(req)
        s.run_until_drained()
    assert {r.uid: r.out_tokens for r in srv.completed} == \
        {r.uid: r.out_tokens for r in jsrv.completed}
    assert srv.latency_summary() == jsrv.latency_summary()
    assert srv.decode_steps > 0 and srv.prefills == 5


@pytest.mark.parametrize("one_len", [8, 16, 24], ids=["pad", "equal",
                                                      "trim"])
def test_splice_takes_the_latent_cache_and_other_lengths(one_len):
    """``_splice`` writes a one-sequence prefill cache into one slot of
    the server's, for MLA's latent {ckv, kr} pair too, cutting a longer
    sequence axis and zero-filling a shorter one as the reference's
    ``_splice`` does."""
    from repro.serve.loop import _splice as jsplice
    from repro_torch.serve.loop import _splice
    jcfg, cfg = jget("deepseek-v3-671b").reduced(), \
        get("deepseek-v3-671b").reduced()
    rng = np.random.default_rng(1)
    full = lm.make_caches(cfg, 3, 16, device="cpu")
    one = lm.make_caches(cfg, 1, one_len, device="cpu")
    for tree in (full, one):
        for _, leaf in convert.leaves(tree):
            leaf.copy_(torch.from_numpy(rng.standard_normal(leaf.shape)))
    want = {path: np.asarray(jsplice(jax.numpy.asarray(leaf.numpy()),
                                     jax.numpy.asarray(
                                         dict(convert.leaves(one))[path]
                                         .numpy()), 1, jcfg))
            for path, leaf in convert.leaves(full)}
    _splice(full, one, 1)
    got = dict(convert.leaves(full))
    assert set(got) == {"dense_stack/ckv", "dense_stack/kr",
                        "moe_stack/ckv", "moe_stack/kr"}
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)


def test_same_virtual_time(served):
    jsrv, srv = served
    assert srv.latency_summary() == jsrv.latency_summary()
    snap = srv.metrics.snapshot()
    assert snap["serve.requests"]["value"] == 5
    assert snap["serve.tokens"]["value"] == srv.latency_summary()["tokens"]


def test_cost_model_exact_at_full_width():
    jcost = JHostCostModel(jget("qwen3-1.7b"))
    cost = HostCostModel(get("qwen3-1.7b"), peak_flops=jhw.PEAK_FLOPS,
                         hbm_bw=jhw.HBM_BW)
    for attr in ("weight_bytes", "flops_per_token", "act_bytes_per_token",
                 "kv_bytes_per_token"):
        assert getattr(cost, attr) == getattr(jcost, attr), attr
    for t in (1, 17, 512, 4096):
        assert cost.prefill_s(t) == jcost.prefill_s(t)
        assert cost.kv_ship_bytes(t) == jcost.kv_ship_bytes(t)
    for b in (1, 4, 64, 1024):
        assert cost.decode_step_s(b) == jcost.decode_step_s(b)


def test_cost_model_defaults_to_h100():
    cost = HostCostModel(get("qwen3-1.7b"))
    assert cost.peak_flops == 989e12 and cost.hbm_bw == 3.35e12
    # one decode step reads every weight once in bf16: the 1,409,286,144
    # elements that go through K1 plus the lm_head over the padded vocab
    assert get("qwen3-1.7b").vocab_padded == 152_064
    assert cost.weight_bytes == 2 * (1_409_286_144 + 152_064 * 2048)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_configs_equal_field_by_field(reduced):
    jcfg, cfg = jget("qwen3-1.7b"), get("qwen3-1.7b")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    assert cfg.head_dim_ == jcfg.head_dim_
    assert cfg.vocab_padded == jcfg.vocab_padded


def test_admission_and_unported_options():
    cfg = get("qwen3-1.7b").reduced().replace(n_layers=1)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    srv = Server(cfg, params, slots=1, cache_len=16, max_queue=1,
                 device="cpu")
    srv.submit(Request(uid=0, prompt=np.zeros(4, np.int32)))
    with pytest.raises(AdmissionError):
        srv.submit(Request(uid=1, prompt=np.zeros(4, np.int32)))
    with pytest.raises(ValueError, match="cache_len"):
        srv.submit(Request(uid=2, prompt=np.zeros(16, np.int32)))
    assert srv.shed == 1
    # the sidecar and serve-fault options construct: the sidecar scales
    # the admission cap, the serve faults are parsed
    off = DecodeOffload(cfg, channels=2, device="cpu")
    srv = Server(cfg, params, device="cpu", pim_offload=off, max_queue=1,
                 faults="fail slot 0 @ iter 1")
    assert srv.pim_offload is off and srv.surviving_fraction == 1.0
    assert [(f.at_iter, f.slot) for f in srv._serve_faults] == [(1, 0)]


# ---------------------------------------------------------------------------
# the PIM decode offload and serve faults
# ---------------------------------------------------------------------------

#: sidecar and serve options of the degraded serve: a numeric sidecar
#: with KV offload on 2 x 2 channels that loses one channel, and two slot
#: knock-outs (one of them twice, past max_retries=1)
OFFLOAD_KW = dict(channels=2, stacks=2, numeric=True, kv_offload=True,
                  faults="kill channel 1 @ 20000; flaky link p=0.3")
SERVE_FAULTS = "fail slot 0 @ iter 3; fail slot 1 @ iter 4; " \
    "fail slot 0 @ iter 9"


def _degraded(make_server, make_offload, cls, cfg, params, vocab, **kw):
    off = make_offload(cfg)
    srv = make_server(cfg, params, off)
    shed = []
    for req in _requests(cls, vocab):
        try:
            srv.submit(req)
        except Exception as e:              # AdmissionError of either
            shed.append((req.uid, type(e).__name__))
    srv.run_until_drained()
    return srv, off, shed


@pytest.fixture(scope="module")
def degraded():
    from repro.serve.offload import DecodeOffload as JDecodeOffload
    jcfg, cfg = jget("qwen3-1.7b").reduced(), get("qwen3-1.7b").reduced()
    jp = jlm.init(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    common = dict(slots=SLOTS, cache_len=CACHE_LEN, max_queue=4,
                  max_retries=1, retry_backoff_steps=1,
                  faults=SERVE_FAULTS)
    ref = _degraded(
        lambda c, p, off: JServer(c, p, pim_offload=off, **common),
        lambda c: JDecodeOffload(c, **OFFLOAD_KW), JRequest, jcfg, jp,
        cfg.vocab_size)
    cost = HostCostModel(cfg, peak_flops=jhw.PEAK_FLOPS, hbm_bw=jhw.HBM_BW)
    port = _degraded(
        lambda c, p, off: Server(c, p, pim_offload=off, cost=cost,
                                 backend="kernel", device="cpu",
                                 metrics=MetricsRegistry(), **common),
        lambda c: DecodeOffload(c, device="cpu", peak_flops=jhw.PEAK_FLOPS,
                                hbm_bw=jhw.HBM_BW, **OFFLOAD_KW),
        Request, cfg, params, cfg.vocab_size)
    return ref, port


def test_offload_and_faults_same_tokens_and_summary(degraded):
    (jsrv, joff, jshed), (srv, off, shed) = degraded
    assert shed == jshed and srv.shed == jsrv.shed == len(shed) > 0
    assert {r.uid: r.out_tokens for r in srv.completed} == \
        {r.uid: r.out_tokens for r in jsrv.completed}
    assert [(r.uid, r.retries) for r in srv.failed_requests] == \
        [(r.uid, r.retries) for r in jsrv.failed_requests] != []
    assert (srv.retries_total, srv.decode_steps) == \
        (jsrv.retries_total, len(joff.steps)) and srv.retries_total >= 2
    assert srv.latency_summary() == jsrv.latency_summary()
    assert srv.metrics.snapshot()["serve.retries"]["value"] == \
        srv.retries_total


def test_offload_sidecar_steps_equal(degraded):
    (_, joff, _), (_, off, _) = degraded
    assert len(off.steps) == len(joff.steps) > 0
    for a, b in zip(joff.steps, off.steps):
        da, db = a.to_json(), b.to_json()
        for f in ERR_FIELDS:       # FP32 references summed in another order
            assert abs(da.pop(f) - db.pop(f)) <= ERR_TOL, f
        assert db == da
    assert off.rt.faults.counters == joff.rt.faults.counters
    assert off.rt.faults.counters["channel_failures"] == 1
    assert off.rt.faults.counters["link_retries"] > 0
    assert len(off.kv._reqs) == len(joff.kv._reqs) == 0
    assert off.surviving_fraction == joff.surviving_fraction == 0.75


def _tiny_server(**kw):
    cfg = get("qwen3-1.7b").reduced().replace(n_layers=1)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    return Server(cfg, params, slots=1, cache_len=16, device="cpu", **kw)


def test_step_deadline_counts_misses():
    srv = _tiny_server(step_deadline_s=0.0)
    srv.submit(Request(uid=0, prompt=np.zeros(4, np.int32), max_new=3))
    srv.run_until_drained()
    assert srv.deadline_misses == srv.decode_steps > 0
    assert srv.latency_summary()["deadline_misses"] == srv.deadline_misses
    generous = _tiny_server(step_deadline_s=1e9)
    generous.submit(Request(uid=0, prompt=np.zeros(4, np.int32), max_new=3))
    generous.run_until_drained()
    assert generous.deadline_misses == 0


def test_admission_cap_scales_with_surviving_capacity():
    off = DecodeOffload(get("qwen3-1.7b").reduced().replace(n_layers=1),
                        channels=2, stacks=2, faults="kill stack 1 @ 0",
                        device="cpu")
    # the fault fired at the first op boundary, the weights' placement
    srv = _tiny_server(max_queue=4, pim_offload=off)
    assert srv.surviving_fraction == off.surviving_fraction == 0.5
    srv.submit(Request(uid=0, prompt=np.zeros(4, np.int32)))
    srv.submit(Request(uid=1, prompt=np.zeros(4, np.int32)))
    with pytest.raises(AdmissionError, match="cap 2"):   # 4 x 0.5
        srv.submit(Request(uid=2, prompt=np.zeros(4, np.int32)))
    assert srv.shed == 1


def test_serve_example_runs_on_the_cpu(capsys):
    """``python -m repro_torch.serve --device cpu``: serve_lm's reduced
    qwen3 with the analytic sidecar and the traffic replay."""
    from repro_torch.serve.__main__ import main
    main(["--device", "cpu", "--requests", "4", "--slots", "2",
          "--max-new", "4", "--pim-offload", "--traffic", "50"])
    out = capsys.readouterr().out
    assert "served 4 requests / 16 tokens" in out
    assert "disaggregated:" in out and "colocated    :" in out
    assert out.rstrip().endswith("serve_lm OK")
