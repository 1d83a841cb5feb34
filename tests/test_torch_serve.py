"""The port's serving loop, cost model and configs against the reference.

A JAX ``Server`` and the port's ``Server`` (``backend="kernel"`` on the
CPU, so every projection takes the kernel's plain version) get the same
parameters and the same seeded requests: their greedy tokens must be
equal, and with the reference's hardware constants their virtual-time
latency summaries must be ``==``.
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
from repro_torch.serve.traffic import HostCostModel

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
    for kw in ({"pim_offload": object()}, {"faults": "fail slot 0 @ iter 1"}):
        with pytest.raises(NotImplementedError):
            Server(cfg, params, device="cpu", **kw)
