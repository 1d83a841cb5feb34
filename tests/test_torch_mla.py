"""The port's MLA attention (``models/attention.py``) against the reference.

Reduced deepseek-v3-671b's multi-head latent attention (q and kv ranks
32, nope 16, rope 16, v 32; 4 heads): the reference's ``mla_init``
parameters carried over as numpy arrays, the same seeded input through
both ``mla_apply``s — a prefill that fills the latent cache from slot 0,
then decode steps that write slot ``pos`` and attend over the whole
cache.  Outputs and the cache's ``ckv`` and ``kr`` agree within an f32
tolerance, ``backend="torch"`` against XLA and ``"kernel"`` (its plain
version on a CPU tensor) against PALLAS in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as jattn
from repro.configs import get as jget
from repro.models.layers import PALLAS, XLA
from repro_torch.configs import get
from repro_torch.models import attention as attn
from repro_torch.models.layers import as_backend
from test_torch_model import check_family, reduced_pair

#: as tests/test_torch_model.py: f32 sums in another order, through a
#: softmax and several products
F32_TOL = dict(atol=1e-4, rtol=1e-4)
B, PROMPT_T, CACHE_LEN, DECODE_STEPS = 2, 10, 16, 3


def _pair():
    jcfg, cfg = jget("deepseek-v3-671b").reduced(), \
        get("deepseek-v3-671b").reduced()
    jp = jax.tree.map(np.asarray, jattn.mla_init(jax.random.PRNGKey(4), jcfg,
                                                 jnp.float32))
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, jax.tree.map(jnp.asarray, jp), cfg, p


@pytest.mark.parametrize("backend,jbackend", [("torch", XLA),
                                              ("kernel", PALLAS)],
                         ids=["torch-vs-xla", "kernel-vs-pallas"])
def test_mla_prefill_and_decode_match_reference(backend, jbackend):
    jcfg, jp, cfg, p = _pair()
    be = as_backend(backend)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, PROMPT_T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(PROMPT_T), (B, PROMPT_T))
    jc = jattn.mla_make_cache(jcfg, B, CACHE_LEN, jnp.float32)
    c = attn.mla_make_cache(cfg, B, CACHE_LEN, torch.float32, "cpu")
    jy, jc = jattn.mla_apply(jp, jnp.asarray(x), jcfg,
                             positions=jnp.asarray(pos), cache=jc,
                             backend=jbackend)
    y, c = attn.mla_apply(p, torch.from_numpy(x), cfg,
                          positions=torch.from_numpy(pos.copy()), cache=c,
                          backend=be)
    seen = [("prefill", jy, y)]
    for step in range(DECODE_STEPS):
        # the port's cache is updated in place: keep copies
        seen += [(f"cache {k} after {step} steps", jc[k], c[k].clone())
                 for k in ("ckv", "kr")]
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        p1 = np.full((B,), PROMPT_T + step) - np.arange(B)   # ragged rows
        jy, jc = jattn.mla_apply(jp, jnp.asarray(x1), jcfg,
                                 positions=jnp.asarray(p1)[:, None],
                                 cache=jc, backend=jbackend)
        y, c = attn.mla_apply(p, torch.from_numpy(x1), cfg,
                              positions=torch.from_numpy(p1)[:, None],
                              cache=c, backend=be)
        seen.append((f"decode {step}", jy, y))
    seen += [(f"final cache {k}", jc[k], c[k]) for k in ("ckv", "kr")]
    for what, want, got in seen:
        assert tuple(got.shape) == want.shape, what
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=what, **F32_TOL)
    # prefill filled slots 0..T-1; row 1's decode rewrote slot T-1
    assert float(c["ckv"][0, PROMPT_T + DECODE_STEPS:].abs().max()) == 0.0


def test_mla_cache_is_the_latent_pair():
    jcfg, cfg = jget("deepseek-v3-671b"), get("deepseek-v3-671b")
    want = jax.eval_shape(lambda: jattn.mla_make_cache(jcfg, 4, 128,
                                                       jnp.bfloat16,
                                                       layers=3))
    got = attn.mla_make_cache(cfg, 4, 128, torch.bfloat16, "meta",
                              layers=3)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()} == \
        {"ckv": (3, 4, 128, 512), "kr": (3, 4, 128, 64)}
    assert all(v.dtype == torch.bfloat16 for v in got.values())


def test_mla_projections_go_through_the_backend(monkeypatch):
    """``wdq``, ``wuq``, ``wdkv``, ``wkr`` and ``wo`` are ``dense()``
    products (five GEMMs through the backend); ``wuk`` / ``wuv`` are the
    absorbed einsums."""
    from repro_torch.kernels import ops
    _, _, cfg, p = _pair()
    m = cfg.mla
    calls = []
    gemm = ops.gemm

    def count(a, b, **kw):
        calls.append(tuple(b.shape))
        return gemm(a, b, **kw)
    monkeypatch.setattr(ops, "gemm", count)
    attn.mla_apply(p, torch.randn(1, 3, cfg.d_model), cfg,
                   positions=torch.arange(3)[None],
                   backend=as_backend("kernel"))
    h = cfg.n_heads
    assert calls == [(cfg.d_model, m.q_lora_rank),
                     (m.q_lora_rank, h * (m.qk_nope_dim + m.qk_rope_dim)),
                     (cfg.d_model, m.kv_lora_rank),
                     (cfg.d_model, m.qk_rope_dim),
                     (h * m.v_head_dim, cfg.d_model)]


@pytest.fixture(scope="module")
def deepseek():
    return reduced_pair("deepseek-v3-671b")


@pytest.mark.parametrize("backend,jbackend", [("torch", XLA),
                                              ("kernel", PALLAS)],
                         ids=["torch-vs-xla", "kernel-vs-pallas"])
def test_deepseek_prefill_and_decode_match_jax(deepseek, backend, jbackend):
    """Reduced deepseek-v3-671b end to end (one dense layer, three MoE
    layers with a shared expert, MLA everywhere): prefill logits and
    latent caches, four decode steps and the final caches."""
    check_family(*deepseek, jbackend, backend, steps=4)
