"""The port's dense model against the JAX reference on the CPU.

Reduced qwen3-1.7b, parameters from the reference's ``lm.init`` carried
over as numpy arrays through ``convert.params_from_jax``.  Prefill logits
and caches and three decode steps are held against JAX: ``backend="torch"``
against the reference's XLA backend, and ``backend="kernel"`` (its plain
version on a CPU tensor) against PALLAS in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.models import model as jlm
from repro.models.layers import PALLAS, XLA
from repro_torch.configs import MoEConfig, get
from repro_torch.models import convert
from repro_torch.models import model as lm

#: f32 compute: both sides accumulate every product in f32 but in another
#: order (einsum vs XLA dot, chunked softmax sums), so logits agree to a
#: few f32 ulps of their O(1) magnitude; 1e-4 leaves two orders of margin
F32_TOL = dict(atol=1e-4, rtol=1e-4)
#: bf16 compute: activations round to 8 mantissa bits after every layer,
#: and the two frameworks round at other places (e.g. silu in f32 vs bf16)
BF16_TOL = dict(atol=0.05, rtol=0.05)

PROMPT_T, CACHE_LEN, DECODE_STEPS = 12, 24, 3


def _setup(compute_dtype="float32"):
    jcfg = jget("qwen3-1.7b").reduced().with_policy(compute_dtype=compute_dtype)
    cfg = get("qwen3-1.7b").reduced().with_policy(compute_dtype=compute_dtype)
    jp = jlm.init(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    return jcfg, jp, cfg, params


@pytest.fixture(scope="module")
def f32_models():
    return _setup("float32")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _run_both(jcfg, jp, cfg, params, jbackend, backend, steps):
    """Prefill then ``steps`` decode steps on both sides, both fed JAX's
    greedy tokens; yields (what, jax_out, port_out) pairs."""
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, PROMPT_T)).astype(np.int32)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                         cache_len=CACHE_LEN, backend=jbackend)
    tl, tc = lm.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                        cfg, cache_len=CACHE_LEN, backend=backend)
    yield "prefill logits", _np(jl), tl
    for name in ("k", "v", "pos"):
        yield f"cache {name}", _np(jc["dense_stack"][name]), \
            tc["dense_stack"][name]
    pos = np.full((2,), PROMPT_T, np.int32)
    for s in range(steps):
        nxt = np.argmax(_np(jl), -1).astype(np.int32)[:, None]
        jl, jc = jlm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc,
                                 jcfg, backend=jbackend)
        tl, tc = lm.decode_step(params, torch.from_numpy(nxt).long(),
                                torch.from_numpy(pos).long(), tc, cfg,
                                backend=backend)
        yield f"decode {s} logits", _np(jl), tl
        pos = pos + 1
    for name in ("k", "v", "pos"):
        yield f"final cache {name}", _np(jc["dense_stack"][name]), \
            tc["dense_stack"][name]


@pytest.mark.parametrize("backend,jbackend", [("torch", XLA),
                                              ("kernel", PALLAS)],
                         ids=["torch-vs-xla", "kernel-vs-pallas"])
def test_prefill_and_decode_match_jax(f32_models, backend, jbackend):
    jcfg, jp, cfg, params = f32_models
    for what, want, got in _run_both(jcfg, jp, cfg, params, jbackend,
                                     backend, DECODE_STEPS):
        np.testing.assert_allclose(got.float().numpy(), want,
                                   err_msg=what, **F32_TOL)


def test_bf16_compute_matches_jax():
    jcfg, jp, cfg, params = _setup("bfloat16")
    params = lm.compute_params(params, cfg)
    for what, want, got in _run_both(jcfg, jp, cfg, params, XLA, "kernel",
                                     steps=1):
        if "pos" in what:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=what)
        else:
            np.testing.assert_allclose(got.float().numpy(), want,
                                       err_msg=what, **BF16_TOL)


def test_compute_params_is_bit_identical():
    cfg = get("qwen3-1.7b").reduced().with_policy(compute_dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = lm.init(cfg, gen, device="cpu")
    cast = lm.compute_params(params, cfg)
    assert cast["stack"]["dense_stack"]["attn"]["wq"]["w"].dtype \
        == torch.bfloat16
    assert cast["final_norm"]["scale"].dtype == torch.float32
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (1, 6),
                                    generator=gen)}
    a, _ = lm.prefill(params, toks, cfg, cache_len=8, backend="kernel")
    b, _ = lm.prefill(cast, toks, cfg, cache_len=8, backend="kernel")
    assert torch.equal(a, b)


def test_full_width_shapes_match_reference_without_allocating():
    jshapes = jax.eval_shape(
        lambda: jlm.init(jget("qwen3-1.7b"), jax.random.PRNGKey(0)))
    meta = lm.init(get("qwen3-1.7b"), device="meta")
    want = dict(convert.leaves(jshapes))
    got = dict(convert.leaves(meta))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(want[path].dtype), path
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))
    assert lm.param_count(meta) == n_ref
    assert 1.7e9 < n_ref < 1.75e9


def test_unported_families_raise():
    cfg = get("qwen3-1.7b").reduced()
    moe = cfg.replace(family="moe", moe=MoEConfig(num_experts=4, top_k=2,
                                                  d_ff_expert=64))
    with pytest.raises(NotImplementedError, match="moe"):
        lm.init(moe, device="meta")
    with pytest.raises(NotImplementedError, match="ssm"):
        lm.make_caches(cfg.replace(family="ssm"), 1, 8, device="cpu")


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(get("qwen3-1.7b").reduced())
