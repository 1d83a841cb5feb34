"""The port's hybrid family (Zamba2) against the JAX reference on the CPU.

Reduced zamba2-2.7b (7 layers: two groups of three mamba layers, each
followed by one of two shared attention blocks, then a tail of one mamba
layer), parameters from the reference's ``lm.init`` carried over as numpy
arrays.  ``lora_b`` starts at zero in both packages, so it is overwritten
with seeded values (and the mamba ``a_log`` / ``dt_bias`` with seeded
values too) before the conversion: the LoRA-merged shared input
projection and every decay then take part.  Prefill logits and caches and
three decode steps are held against JAX, ``backend="torch"`` against XLA
and ``"kernel"`` (its plain versions on a CPU tensor) against PALLAS in
interpret mode; the ``Server`` gives the JAX ``Server``'s tokens and
virtual-time summary.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.launch import hw as jhw
from repro.models import model as jlm
from repro.models.layers import PALLAS, XLA
from repro.serve.loop import Request as JRequest
from repro.serve.loop import Server as JServer
from repro.serve.traffic import HostCostModel as JHostCostModel
from repro_torch.configs import get
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as k4
from repro_torch.launch import hw
from repro_torch.models import convert
from repro_torch.models import model as lm
from repro_torch.models import transformer as tf
from repro_torch.serve.loop import Request, Server, _splice
from repro_torch.serve.traffic import HostCostModel

NAME = "zamba2-2.7b"
#: f32 compute: as tests/test_torch_model.py (sum order only)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
#: the reduced config's SSD chunk is 32: a 40-token prompt crosses it
PROMPT_T, CACHE_LEN, DECODE_STEPS = 40, 48, 3
CACHE_LEAVES = [("groups", "conv"), ("groups", "ssm"), ("shared_kv", "k"),
                ("shared_kv", "v"), ("shared_kv", "pos"), ("tail", "conv"),
                ("tail", "ssm")]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _seeded(np_params):
    """Seeded non-zero ``lora_b`` and mamba decays (in place)."""
    rng = np.random.default_rng(11)
    st = np_params["stack"]
    st["lora_b"] = (rng.standard_normal(st["lora_b"].shape) * 0.2) \
        .astype(np.float32)
    for stack in ("groups", "tail"):
        m = st[stack]["mamba"]
        m["a_log"] = rng.uniform(-1.0, 1.0, m["a_log"].shape) \
            .astype(np.float32)
        m["dt_bias"] = rng.uniform(-2.0, 0.5, m["dt_bias"].shape) \
            .astype(np.float32)
    return np_params


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jget(NAME).reduced(), get(NAME).reduced()
    init = jax.jit(jlm.init, static_argnums=0)
    npp = _seeded(jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(0))))
    jp = jax.tree.map(jnp.asarray, npp)
    return jcfg, jp, cfg, convert.params_from_jax(npp, cfg, device="cpu")


def _run_both(jcfg, jp, cfg, params, jbackend, backend):
    """Prefill then DECODE_STEPS decode steps on both sides, both fed
    JAX's greedy tokens; yields (what, jax_out, port_out) triples."""
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, PROMPT_T)).astype(np.int32)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                         cache_len=CACHE_LEN, backend=jbackend)
    tl, tc = lm.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                        cfg, cache_len=CACHE_LEN, backend=backend)
    yield "prefill logits", _np(jl), tl
    for part, leaf in CACHE_LEAVES:
        yield f"cache {part}/{leaf}", _np(jc[part][leaf]), tc[part][leaf]
    pos = np.full((2,), PROMPT_T, np.int32)
    for s in range(DECODE_STEPS):
        nxt = np.argmax(_np(jl), -1).astype(np.int32)[:, None]
        jl, jc = jlm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc,
                                 jcfg, backend=jbackend)
        tl, tc = lm.decode_step(params, torch.from_numpy(nxt).long(),
                                torch.from_numpy(pos).long(), tc, cfg,
                                backend=backend)
        yield f"decode {s} logits", _np(jl), tl
        pos = pos + 1
    for part, leaf in CACHE_LEAVES:
        yield f"final cache {part}/{leaf}", _np(jc[part][leaf]), \
            tc[part][leaf]


@pytest.mark.parametrize("backend,jbackend", [("torch", XLA),
                                              ("kernel", PALLAS)],
                         ids=["torch-vs-xla", "kernel-vs-pallas"])
def test_prefill_and_decode_match_jax(models, backend, jbackend):
    jcfg, jp, cfg, params = models
    seen = 0
    for what, want, got in _run_both(jcfg, jp, cfg, params, jbackend,
                                     backend):
        assert tuple(got.shape) == want.shape, what
        np.testing.assert_allclose(got.float().numpy(), want, err_msg=what,
                                   **F32_TOL)
        seen += 1
    assert seen == 4 + 2 * len(CACHE_LEAVES)


def test_lora_merge_and_tail_take_part(models):
    """The reduced model has a tail and a live LoRA pair: zeroing
    ``lora_b`` or skipping the tail moves the logits."""
    _, _, cfg, params = models
    assert cfg.n_layers % cfg.hybrid.shared_every == 1 and "tail" in \
        params["stack"]
    toks = {"tokens": torch.arange(9)[None] % cfg.vocab_size}
    base, _ = lm.prefill(params, toks, cfg, cache_len=16)
    stack = dict(params["stack"],
                 lora_b=torch.zeros_like(params["stack"]["lora_b"]))
    no_lora, _ = lm.prefill(dict(params, stack=stack), toks, cfg, 16)
    assert float((base - no_lora).abs().max()) > 1e-3
    h = torch.randn(1, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(5)[None]
    full, _, _ = tf.hybrid_apply(params["stack"], h, cfg, positions=pos)
    cut = {k: v for k, v in params["stack"].items() if k != "tail"}
    short, _, _ = tf.hybrid_apply(cut, h, cfg, positions=pos)
    assert float((full - short).abs().max()) > 1e-3


def test_full_width_shapes_match_reference_without_allocating():
    jshapes = jax.eval_shape(
        lambda: jlm.init(jget(NAME), jax.random.PRNGKey(0)))
    meta = lm.init(get(NAME), device="meta")
    want = dict(convert.leaves(jshapes))
    got = dict(convert.leaves(meta))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(want[path].dtype), path
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))
    assert lm.param_count(meta) == n_ref == 2_505_742_240
    st = meta["stack"]
    assert tuple(st["groups"]["mamba"]["in_proj"]["w"].shape) == \
        (54, 2560, 10448)
    assert tuple(st["shared"]["in_proj"]["w"].shape) == (2, 5120, 2560)
    assert tuple(st["lora_a"].shape) == (9, 5120, 64)
    assert tuple(st["lora_b"].shape) == (9, 64, 2560)
    assert "tail" not in st                     # 54 % 6 == 0


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_configs_equal_field_by_field(reduced):
    jcfg, cfg = jget(NAME), get(NAME)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert (cfg.n_layers, cfg.hybrid.shared_every,
                cfg.hybrid.lora_rank) == (7, 3, 8)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.head_dim_ == jcfg.head_dim_
    assert cfg.vocab_padded == jcfg.vocab_padded


def test_caches_match_reference_and_splice_per_slot():
    """The mixed {groups, shared_kv, tail} cache has the reference's
    shapes, and ``_splice`` copies one sequence's prefill cache into
    slot 1 of every leaf (batch on axis 1) and nowhere else."""
    jcfg, cfg = jget(NAME).reduced(), get(NAME).reduced()
    want = jax.eval_shape(lambda: jlm.make_caches(jcfg, 3, 16))
    full = lm.make_caches(cfg, 3, 16, device="cpu")
    assert {p: tuple(v.shape) for p, v in convert.leaves(full)} == \
        {p: tuple(v.shape) for p, v in convert.leaves(want)}
    one = lm.make_caches(cfg, 1, 16, device="cpu")
    for _, leaf in convert.leaves(one):
        leaf.fill_(7)
    _splice(full, one, 1)
    for path, leaf in convert.leaves(full):
        assert bool((leaf[:, 1] == 7).all()), path
        assert not bool((leaf[:, 0] == 7).any()), path
        assert not bool((leaf[:, 2] == 7).any()), path


def test_server_gives_the_same_tokens_and_times_as_jax(models):
    jcfg, jp, cfg, params = models
    cost = HostCostModel(cfg, peak_flops=jhw.PEAK_FLOPS, hbm_bw=jhw.HBM_BW)
    jsrv = JServer(jcfg, jp, slots=2, cache_len=CACHE_LEN)
    srv = Server(cfg, params, slots=2, cache_len=CACHE_LEN, cost=cost,
                 backend="kernel", device="cpu")
    rng = np.random.default_rng(0)
    # one 1-token prompt (recurrence prefill), one across the chunk of 32
    work = [(rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
             int(rng.integers(3, 6))) for plen in (1, 9, 40, 9)]
    for s, cls in ((jsrv, JRequest), (srv, Request)):
        for uid, (prompt, max_new) in enumerate(work):
            s.submit(cls(uid=uid, prompt=prompt, max_new=max_new))
        s.run_until_drained()
    want = {r.uid: r.out_tokens for r in jsrv.completed}
    got = {r.uid: r.out_tokens for r in srv.completed}
    assert len(got) == 4 and got == want
    assert srv.latency_summary() == jsrv.latency_summary()


def test_cost_model_takes_the_generic_fallback_on_both_sides():
    jcost = JHostCostModel(jget(NAME))
    cost = HostCostModel(get(NAME), peak_flops=jhw.PEAK_FLOPS,
                         hbm_bw=jhw.HBM_BW)
    d, layers = 2560, 54
    # the fallback's dense-transformer estimate, not the hybrid's own count
    assert cost.weight_bytes == 2 * (layers * 12 * d * d + 32000 * d)
    for attr in ("weight_bytes", "flops_per_token", "act_bytes_per_token",
                 "kv_bytes_per_token"):
        assert getattr(cost, attr) == getattr(jcost, attr), attr
    for t in (1, 300):
        assert cost.prefill_s(t) == jcost.prefill_s(t)
    assert cost.decode_step_s(4) == jcost.decode_step_s(4)


@pytest.fixture(scope="module")
def full_mamba_layer():
    """One full-width zamba2 mamba layer in bf16 (the serve's dtype)."""
    from repro_torch.models import ssm
    cfg = get(NAME)
    return cfg, ssm.mamba_init(torch.Generator().manual_seed(0), cfg,
                               torch.bfloat16, "cpu")


@pytest.mark.parametrize("t", [2, 37, 64, 300])
def test_k4_takes_mma_on_the_full_width_serve_views(t, full_mamba_layer,
                                                    monkeypatch):
    """The scan operands a full-width zamba2 mamba layer hands K4 in bf16
    compute: 80 heads of P = 64 with N = 64, x*dt f32 seen transposed
    out of (B,T,80,64), b and c the conv output's columns expanded over
    the heads; K4's rule sends them to its mma variant."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import TORCH
    cfg, params = full_mamba_layer
    s = cfg.ssm
    seen = []

    def catch(x, log_a, b, c, **kw):
        seen.append((x, log_a, b, c))
        return torch.zeros_like(x)
    monkeypatch.setattr(ops, "ssd4", catch)
    u = torch.randn(1, t, cfg.d_model).bfloat16()
    ssm.mamba_apply(params, u, cfg, backend=TORCH)
    (x, log_a, b, c), = seen
    conv_dim = 5120 + 2 * s.d_state
    assert x.shape == (1, 80, t, 64) and b.shape == (1, 80, t, 64)
    assert x.dtype == torch.float32 and b.dtype == c.dtype == torch.bfloat16
    assert x.stride() == (t * 80 * 64, 64, 80 * 64, 1)
    assert b.stride() == c.stride() == (t * conv_dim, 0, conv_dim, 1)
    assert k4.variant(x, b, c) == "mma"
    assert k4.smem_bytes(min(s.chunk, t), s.d_state) <= hw.SMEM_PER_BLOCK
