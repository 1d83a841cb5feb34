"""The port's dense model against the JAX reference on the CPU.

Reduced qwen3-1.7b, parameters from the reference's ``lm.init`` carried
over as numpy arrays through ``convert.params_from_jax``.  Prefill logits
and caches and three decode steps are held against JAX: ``backend="torch"``
against the reference's XLA backend, and ``backend="kernel"`` (its plain
version on a CPU tensor) against PALLAS in interpret mode.  The same for
the prefill of reduced gemma-2b, phi4-mini-3.8b and command-r-35b (the
MoE and MLA families have theirs in tests/test_torch_{moe,mla}.py); every
registered config equals the reference's field by field, and so do its
cells of the input grid (``applicable``, ``input_specs``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable as japplicable
from repro.configs import get as jget
from repro.configs import input_specs as jinput_specs
from repro.models import model as jlm
from repro.models.layers import PALLAS, XLA
from repro_torch.configs import (SHAPES, MLAConfig, MoEConfig, all_names,
                                 applicable, get, input_specs)
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
    """Every family builds now (the encoder and VLM since their port
    with training); what stays refused is the encoder's decode step,
    which the reference refuses too.  MoE and MLA models build."""
    audio = get("hubert-xlarge").reduced()
    p = lm.init(audio, device="meta")
    assert {"mask_emb", "head"} <= set(p) and "embed" not in p
    assert "head" in lm.init(get("internvl2-76b").reduced(), device="meta")
    caches = lm.make_caches(audio, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="no decode step"):
        lm.decode_step(p, torch.zeros((1, 1), dtype=torch.long),
                       torch.zeros((1,), dtype=torch.long), caches, audio)
    cfg = get("qwen3-1.7b").reduced()
    moe = cfg.replace(family="moe", moe=MoEConfig(num_experts=4, top_k=2,
                                                  d_ff_expert=64))
    assert "moe_stack" in lm.init(moe, device="meta")["stack"]
    mla = cfg.replace(mla=MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                    qk_nope_dim=16, qk_rope_dim=16,
                                    v_head_dim=32))
    assert set(lm.make_caches(mla, 1, 8, device="cpu")["dense_stack"]) \
        == {"ckv", "kr"}


def test_cuda_default_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(get("qwen3-1.7b").reduced())


# ---------------------------------------------------------------------------
# the other configs: their families' forwards, shapes and inputs
# ---------------------------------------------------------------------------

def reduced_pair(name, seed=0):
    """(jcfg, jax params, cfg, port params) of a reduced config, the
    reference's ``lm.init`` (jitted) converted through numpy."""
    jcfg, cfg = jget(name).reduced(), get(name).reduced()
    jp = jax.jit(jlm.init, static_argnums=0)(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, cfg, convert.params_from_jax(
        jax.tree.map(np.asarray, jp), cfg, device="cpu")


def run_family(jcfg, jp, cfg, params, jbackend, backend, steps=4):
    """Prefill then ``steps`` decode steps on both sides, both fed JAX's
    greedy tokens; yields (what, jax_out, port_out) with every cache leaf
    (KV or MLA's latent pair) after the prefill and at the end."""
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, PROMPT_T)).astype(np.int32)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                         cache_len=CACHE_LEN, backend=jbackend)
    tl, tc = lm.prefill(params, {"tokens": torch.from_numpy(toks).long()},
                        cfg, cache_len=CACHE_LEN, backend=backend)
    yield "prefill logits", _np(jl), tl
    want = dict(convert.leaves(jc))
    for path, leaf in convert.leaves(tc):
        yield f"cache {path}", _np(want[path]), leaf.clone()
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
    want = dict(convert.leaves(jc))
    for path, leaf in convert.leaves(tc):
        yield f"final cache {path}", _np(want[path]), leaf


def check_family(jcfg, jp, cfg, params, jbackend, backend, steps=4):
    """:func:`run_family` within F32_TOL; every output seen."""
    leaves = len(list(convert.leaves(lm.make_caches(cfg, 1, 4, "cpu"))))
    seen = 0
    for what, want, got in run_family(jcfg, jp, cfg, params, jbackend,
                                      backend, steps):
        assert tuple(got.shape) == want.shape, what
        np.testing.assert_allclose(got.float().numpy(), want,
                                   err_msg=what, **F32_TOL)
        seen += 1
    assert seen == 1 + steps + 2 * leaves


@pytest.mark.parametrize("name,n_params", [
    ("mixtral-8x22b", 140_630_071_296),
    ("deepseek-v3-671b", 671_077_791_744)])
def test_moe_full_width_shapes_match_reference(name, n_params):
    jshapes = jax.eval_shape(lambda: jlm.init(jget(name),
                                              jax.random.PRNGKey(0)))
    meta = lm.init(get(name), device="meta")
    want = dict(convert.leaves(jshapes))
    got = dict(convert.leaves(meta))
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[path].shape), path
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(want[path].dtype), path
    assert lm.param_count(meta) == n_params == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jshapes))


@pytest.mark.parametrize("name", ["gemma-2b", "phi4-mini-3.8b",
                                  "command-r-35b"])
@pytest.mark.parametrize("backend,jbackend", [("torch", XLA),
                                              ("kernel", PALLAS)],
                         ids=["torch-vs-xla", "kernel-vs-pallas"])
def test_dense_configs_prefill_matches_jax(name, backend, jbackend):
    """Reduced gemma-2b (GeGLU, MQA, head_dim 32, tied embeddings),
    phi4-mini-3.8b and command-r-35b (tied): prefill logits and caches."""
    check_family(*reduced_pair(name, seed=1), jbackend, backend, steps=0)


#: fields of the port's own (DeepSeek-V3's published routing, its share
#: of the experts, YaRN), absent from the reference; every registered
#: config holds them at their defaults, which compute what the reference
#: does
PORT_ONLY = {"moe": ("scoring", "n_group", "topk_group", "routed_scale",
                     "held", "held_from"),
             "mla": ("yarn_factor", "yarn_original_len", "yarn_beta_fast",
                     "yarn_beta_slow", "yarn_mscale_all_dim")}


def _reference_fields(cfg):
    """``dataclasses.asdict(cfg)`` without the port's own fields, each
    checked to hold its default."""
    d = dataclasses.asdict(cfg)
    for group, names in PORT_ONLY.items():
        if d[group] is None:
            continue
        default = type(getattr(cfg, group))
        for n in names:
            assert d[group].pop(n) == \
                default.__dataclass_fields__[n].default, (group, n)
    return d


@pytest.mark.parametrize("name", all_names())
def test_configs_equal_field_by_field_everywhere(name):
    for jcfg, cfg in ((jget(name), get(name)),
                      (jget(name).reduced(), get(name).reduced())):
        assert _reference_fields(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.head_dim_, cfg.vocab_padded, cfg.attention_free,
                cfg.quadratic_attention) == \
            (jcfg.head_dim_, jcfg.vocab_padded, jcfg.attention_free,
             jcfg.quadratic_attention)


@pytest.mark.parametrize("shape", sorted(JSHAPES))
@pytest.mark.parametrize("name", all_names())
def test_shapes_applicable_and_input_specs_match(name, shape):
    """Every registered config x every shape of the grid: the same
    verdict and reason, and meta-device inputs with the reference's
    ``ShapeDtypeStruct`` shapes and dtypes (full and reduced)."""
    assert dataclasses.asdict(SHAPES[shape]) == \
        dataclasses.asdict(JSHAPES[shape])
    cfg, jcfg = get(name), jget(name)
    assert applicable(cfg, SHAPES[shape]) == japplicable(jcfg,
                                                         JSHAPES[shape])
    for reduced in (False, True):
        want = jinput_specs(jcfg, JSHAPES[shape], reduced=reduced)
        got = input_specs(cfg, SHAPES[shape], reduced=reduced)
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (k, reduced)
            assert str(v.dtype).removeprefix("torch.") == \
                str(want[k].dtype), (k, reduced)
