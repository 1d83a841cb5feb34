"""The port's MoE layer (``models/moe.py``) against the reference on the CPU.

Reduced mixtral-8x22b (4 experts, top-2, no shared expert) and
deepseek-v3-671b (4 experts, top-2, one shared expert), the reference's
``moe_init`` parameters carried over as numpy arrays and the same seeded
input through both ``moe_apply``s: ``y`` and the load-balance ``aux``
within tests/test_kernels.py's f32 tolerance, and the dispatch — which
token lands in which expert's capacity slot, and so which are dropped —
``==``.  The cases cover ample capacity, an over-capacity group, a decode
batch whose four rows (empty slots included) compete for one slot per
expert, and router logits with exact ties, where the lower expert index
must win as in ``jax.lax.top_k``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
from repro.configs import get as jget
from repro.models import model as jlm
from repro.models.layers import PALLAS, XLA
from repro_torch.configs import get
from repro_torch.models import convert
from repro_torch.models import model as lm
from repro_torch.models import moe
from repro_torch.models.layers import as_backend
from test_torch_model import F32_TOL as MODEL_TOL
from test_torch_model import check_family, reduced_pair

#: tests/test_kernels.py's f32 tolerance: only the order of f32 sums
#: differs between the two packages
F32_TOL = dict(atol=2e-5, rtol=2e-5)


class _CaptureCombine:
    """Stands in for the reference module's ``jnp``: every attribute is
    jax.numpy's, and the combine einsum's first operand is kept."""

    def __init__(self):
        self.combine = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        if spec == "gsec,egcd->gsd":
            self.combine.append(np.asarray(ops[0], np.float32))
        return jnp.einsum(spec, *ops, **kw)


def _cfg(get_fn, name, **moe_kw):
    cfg = get_fn(name).reduced()
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))


def _tie_router(w, rng):
    """Router weights of small dyadic values with expert 2's column a copy
    of expert 1's: every logit is exact in f32 whatever the order of the
    sums, so experts 1 and 2 tie exactly on every token."""
    w = rng.integers(-16, 17, w.shape).astype(np.float32) / 16
    w[:, 2] = w[:, 1]
    return w


def _run(name, case, jbackend, backend, monkeypatch):
    """(reference, port) results of one ``moe_apply``: y, aux and the
    combine tensor (G, S, E, C)."""
    rng = np.random.default_rng(5)
    b, t = {"decode": (4, 1), "over-capacity": (2, 16)}.get(case, (2, 12))
    kw = {"over-capacity": dict(capacity_factor=0.25),
          "decode": dict(num_experts=8)}.get(case, {})
    jcfg, cfg = _cfg(jget, name, **kw), _cfg(get, name, **kw)
    jp = jax.tree.map(np.asarray,
                      jmoe.moe_init(jax.random.PRNGKey(1), jcfg, jnp.float32))
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    if case == "tie":
        jp["router"]["w"] = _tie_router(jp["router"]["w"], rng)
        x = (rng.integers(-1, 2, x.shape) * 0.5).astype(np.float32)
    if case == "decode":
        x[2:] = 0.0                      # two empty slots, as served

    cap = _CaptureCombine()
    monkeypatch.setattr(jmoe, "jnp", cap)
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                              jcfg, jbackend)
    monkeypatch.undo()

    got = {}
    route = moe.route

    def capture(*a, **k):
        got["combine"], got["aux"] = route(*a, **k)
        return got["combine"], got["aux"]
    monkeypatch.setattr(moe, "route", capture)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    y, aux = moe.moe_apply(p, torch.from_numpy(x), cfg,
                           as_backend(backend))
    want = (np.asarray(jy), float(jaux), cap.combine[0])
    return want, (y.numpy(), float(aux), got["combine"].float().numpy())


CASES = ["ample", "over-capacity", "decode", "tie"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name,backend,jbackend", [
    ("mixtral-8x22b", "torch", XLA),
    ("deepseek-v3-671b", "torch", XLA),
    ("deepseek-v3-671b", "kernel", PALLAS)],
    ids=["mixtral-torch-vs-xla", "deepseek-torch-vs-xla",
         "deepseek-kernel-vs-pallas"])
def test_moe_apply_matches_reference(name, backend, jbackend, case,
                                     monkeypatch):
    (jy, jaux, jc), (y, aux, c) = _run(name, case, jbackend, backend,
                                       monkeypatch)
    assert c.shape == jc.shape
    assert np.array_equal(c > 0, jc > 0)       # the same slots and drops
    np.testing.assert_allclose(c, jc, **F32_TOL)
    np.testing.assert_allclose(y, jy, **F32_TOL)
    np.testing.assert_allclose(aux, jaux, **F32_TOL)
    kept = (c > 0).sum((1, 3))                  # (G, E) tokens kept
    g, s, e, slots = c.shape
    assert (kept <= slots).all()
    routed = s * 2                              # top-2 of each token
    if case == "over-capacity":
        assert kept.sum() < g * routed          # capacity dropped some
    if case == "ample":
        assert kept.sum() == g * routed
    if case == "decode":
        assert (g, s, slots) == (1, 4, 1)       # int(1.25 * 4 * 2 / 8)
    if case == "tie":                           # 1 won the tie against 2
        assert ((c[:, :, 1] > 0).any(-1) & ~(c[:, :, 2] > 0).any(-1)).any()


def test_tied_router_takes_the_lower_expert():
    """Equal probabilities: ``top_k`` orders them by index, as
    ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, (3, 64, 8)).astype(np.float32) / 4
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    v, i = moe.top_k(torch.from_numpy(probs), 3)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert np.array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("s,g", [(12, 1), (256, 1), (512, 2), (768, 3),
                                 (1000, 2)])
def test_groups_match_reference(s, g):
    assert moe._group(s) == jmoe._group(s) == g


def test_moe_capacity_drops():
    """Mirrors tests/test_models_smoke.py::test_moe_capacity_drops on
    both packages: a tiny capacity factor drops tokens, so prefill logits
    move but stay finite, and the port's equal the reference's in each
    setting."""
    jhi = _cfg(jget, "mixtral-8x22b", capacity_factor=8.0)
    jp = jax.jit(jlm.init, static_argnums=0)(jhi, jax.random.PRNGKey(3))
    tokens = np.random.default_rng(0).integers(0, jhi.vocab_size, (2, 16))
    out = {}
    for cf in (0.25, 8.0):
        jcfg = _cfg(jget, "mixtral-8x22b", capacity_factor=cf)
        cfg = _cfg(get, "mixtral-8x22b", capacity_factor=cf)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                         device="cpu")
        jl, _ = jlm.prefill(jp, {"tokens": jnp.asarray(tokens, jnp.int32)},
                            jcfg, cache_len=16)
        tl, _ = lm.prefill(params, {"tokens": torch.as_tensor(tokens)}, cfg,
                           cache_len=16)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        out[cf] = tl
    assert torch.isfinite(out[0.25]).all()
    assert float((out[0.25] - out[8.0]).abs().max()) > 1e-4


def test_shared_expert_goes_through_the_backend(monkeypatch):
    """deepseek's shared expert is an MLP of ``dense()`` products (three
    GEMMs through the backend); the router and the expert banks are plain
    products, as in the reference."""
    cfg = get("deepseek-v3-671b").reduced()
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    calls = []
    from repro_torch.kernels import ops
    gemm = ops.gemm

    def count(a, b, **kw):
        calls.append((tuple(a.shape), tuple(b.shape), kw["use_kernel"]))
        return gemm(a, b, **kw)
    monkeypatch.setattr(ops, "gemm", count)
    moe.moe_apply(p, torch.randn(1, 5, cfg.d_model), cfg,
                  as_backend("kernel"))
    f = cfg.moe.d_ff_expert * cfg.moe.n_shared
    assert calls == [((5, cfg.d_model), (cfg.d_model, f), True)] * 2 \
        + [((5, f), (f, cfg.d_model), True)]


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_decoder_sums_the_moe_layers_aux_loss(name):
    """``decoder_apply`` returns the hidden states and the MoE layers'
    summed load-balance loss, as the reference's does (a dense-only stack
    returns 0)."""
    import repro.models.transformer as jtf
    from repro_torch.models import transformer as tf
    jcfg, jp, cfg, params = reduced_pair(name)
    h = np.random.default_rng(2).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    jh, _, jaux = jtf.decoder_apply(jp["stack"], jnp.asarray(h), jcfg,
                                    positions=jnp.asarray(pos))
    th, _, aux = tf.decoder_apply(params["stack"], torch.from_numpy(h), cfg,
                                  positions=torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **F32_TOL)
    assert float(aux) > 0
    dense = cfg.replace(family="dense", moe=None)
    assert tf.decoder_apply(tf.decoder_init(None, dense, torch.float32,
                                            "meta"), torch.empty(
        1, 2, cfg.d_model, device="meta"), dense,
        positions=torch.zeros(1, 2, dtype=torch.long, device="meta"))[2] \
        == 0.0


# ---------------------------------------------------------------------------
# reduced mixtral-8x22b end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixtral():
    return reduced_pair("mixtral-8x22b")


@pytest.mark.parametrize("backend,jbackend", [("torch", XLA),
                                              ("kernel", PALLAS)],
                         ids=["torch-vs-xla", "kernel-vs-pallas"])
def test_mixtral_prefill_and_decode_match_jax(mixtral, backend, jbackend):
    """Prefill logits and KV caches, four decode steps and the final
    caches (tests/test_torch_model.py's f32 tolerance)."""
    check_family(*mixtral, jbackend, backend, steps=4)


def _decode_chain(cfg, params, tokens, cache_len, decode):
    """Prefill one token, then decode the rest one by one (the
    reference test's ``_decode_chain_logits``)."""
    b, t = tokens.shape
    logits, caches = decode(None, tokens[:, :1], None, cache_len)
    outs = [logits]
    for i in range(1, t):
        logits, caches = decode(caches, tokens[:, i:i + 1], i, cache_len)
        outs.append(logits)
    return np.stack([np.asarray(o, np.float32) for o in outs], 1)


def test_swa_rolling_cache_decode():
    """Mirrors tests/test_models_smoke.py::test_swa_rolling_cache_decode:
    reduced mixtral's 16-slot rolling cache decoding 24 tokens matches the
    full forward, and each step matches the reference's decode chain."""
    jcfg = jget("mixtral-8x22b").reduced()
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                capacity_factor=8.0))
    cfg = get("mixtral-8x22b").reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    assert cfg.sliding_window == 16
    jp = jax.jit(jlm.init, static_argnums=0)(jcfg, jax.random.PRNGKey(2))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    b, t = 1, 24
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, t))

    jstep = jax.jit(lambda p, tk, ps, c: jlm.decode_step(p, tk, ps, c, jcfg))

    def jdecode(c, tk, i, clen):
        tk = jnp.asarray(tk, jnp.int32)
        if c is None:
            return jlm.prefill(jp, {"tokens": tk}, jcfg, cache_len=clen)
        return jstep(jp, tk, jnp.full((b,), i, jnp.int32), c)

    def decode(c, tk, i, clen):
        tk = torch.as_tensor(tk)
        if c is None:
            return lm.prefill(params, {"tokens": tk}, cfg, cache_len=clen)
        return lm.decode_step(params, tk, torch.full((b,), i), c, cfg,
                              backend="kernel")

    full, caches = lm.prefill(params, {"tokens": torch.as_tensor(tokens)},
                              cfg, cache_len=t)
    assert caches["moe_stack"]["k"].shape[2] == 16      # rolling
    chain = _decode_chain(cfg, params, tokens, t, decode)
    np.testing.assert_allclose(chain[:, -1], full.numpy(), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(chain, _decode_chain(jcfg, jp, tokens, t,
                                                    jdecode), **MODEL_TOL)


