"""The port's AdamW and gradient compression against the JAX reference.

The same numpy parameters and gradients go through ``repro.optim`` and
``repro_torch.optim`` for a few steps, and every parameter and moment
leaf is compared.  Where the update is elementwise (f32, bf16 and int8
moments, no clipping) the port is ``==``: its constants enter as f32,
its schedule and bias corrections are f32 tensors and its rounding is
half-to-even, as ``jnp``'s are.  Where a reduction enters (the global
norm once clipping is active, the factored second moment's means) the
sums run in another order and the results stand a few f32 ulps apart.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_names as jall_names
from repro.configs import get as jget
from repro.models import model as jlm
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro_torch.configs import get
from repro_torch.models import convert
from repro_torch.models import model as lm
from repro_torch.optim import adamw, compression

#: a leaf of each kind the models have: a stacked norm scale, a stacked
#: dense weight (3-D, the sliced path when CHUNK_BYTES is lowered), an
#: embedding table and a 1-D vector that takes no decay
SHAPES = {"stack": {"dense_stack": {"ln1": {"scale": (3, 16)},
                                    "mlp": {"wi": {"w": (3, 16, 24)}}}},
          "embed": {"table": (40, 16)}, "mask_emb": (16,)}
#: gradient scales: 0.01 keeps the global norm under clip_norm = 1 (the
#: clip factor is exactly 1), 1.0 clips every step
NO_CLIP, CLIP = 0.01, 1.0
#: where a reduction enters (the clipped step: global norms 3e-7 apart;
#: the factored means), each entry within this many f32 ulps of the
#: leaf's largest magnitude: an entry near zero after ``p - lr * u``
#: cancels, so its own ulps say nothing
REDUCTION_ULPS = 4


def _tree(rng, shapes, scale):
    return {k: _tree(rng, v, scale) if isinstance(v, dict)
            else (rng.standard_normal(v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _as_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) \
        else x.float().numpy()


def run_both(cfg_kw, gscale, steps=3, param_dtype="float32", seed=0):
    """``steps`` AdamW steps in both packages on the same numpy gradients;
    returns (jax params, jax state, jax metrics, port params, port state,
    port metrics) after the last step."""
    rng = np.random.default_rng(seed)
    p0 = _tree(rng, SHAPES, 1.0)
    jc = jadamw.AdamWConfig(**cfg_kw)
    c = adamw.AdamWConfig(**cfg_kw)
    jdt = jnp.bfloat16 if param_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if param_dtype == "bfloat16" else torch.float32
    jp = jax.tree.map(lambda x: jnp.asarray(x).astype(jdt), p0)
    tp = adamw.tree_map(lambda x: torch.from_numpy(x.copy()).to(tdt), p0)
    js, ts = jadamw.init(jp, jc), adamw.init(tp, c)
    for _ in range(steps):
        g = _tree(rng, SHAPES, gscale)
        jp, js, jm = jadamw.apply(jp, jax.tree.map(jnp.asarray, g), js, jc)
        tp, ts, tm = adamw.apply(tp, adamw.tree_map(torch.from_numpy, g), ts,
                                 c)
    return jp, js, jm, tp, ts, tm


def _pairs(jtree, ttree):
    """(path, jax leaf as f32 numpy, port leaf as f32 numpy), every leaf."""
    jl = dict(convert.leaves(jax.tree.map(_as_f32, jtree)))
    tl = dict(convert.leaves(adamw.tree_map(_as_f32, ttree)))
    assert set(jl) == set(tl)
    return [(k, jl[k], tl[k]) for k in sorted(jl)]


def assert_trees(jtree, ttree, ulps=0):
    """Every leaf ``==``, or within ``ulps`` f32 ulps of its largest
    magnitude."""
    for path, want, got in _pairs(jtree, ttree):
        if ulps:
            tol = ulps * np.spacing(np.abs(want).max().astype(np.float32))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)


MOMENTS = [("float32", False), ("bfloat16", False), ("int8", False)]


@pytest.mark.parametrize("moment_dtype,factored", MOMENTS)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_elementwise_steps_are_bit_exact(moment_dtype, factored,
                                         param_dtype):
    kw = dict(warmup_steps=2, total_steps=10, moment_dtype=moment_dtype,
              factored_v=factored)
    jp, js, jm, tp, ts, tm = run_both(kw, NO_CLIP, param_dtype=param_dtype)
    assert_trees(jp, tp)
    assert_trees({"m": js["m"], "v": js["v"]}, {"m": ts["m"], "v": ts["v"]})
    assert int(js["step"]) == int(ts["step"]) == 3
    assert ts["step"].dtype == torch.int32
    assert float(tm["lr"]) == float(jm["lr"])


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_big_leaves_update_in_slices(moment_dtype, monkeypatch):
    """With ``CHUNK_BYTES`` lowered, the stacked (3, 16, 24) weight takes
    the dim-0 sliced path (the int8 codec's per-row scales and all): the
    port's results are ``==`` its unsliced ones.  The reference's sliced
    loop body is fused by XLA and rounds a few entries one ulp apart from
    its own unsliced path (3 of 1152 here), so against it: one ulp."""
    kw = dict(warmup_steps=2, total_steps=10, moment_dtype=moment_dtype)
    _, _, _, whole, whole_s, _ = run_both(kw, NO_CLIP)
    monkeypatch.setattr(jadamw, "CHUNK_BYTES", 1024)
    monkeypatch.setattr(adamw, "CHUNK_BYTES", 1024)
    assert adamw._is_big(torch.zeros(3, 16, 24))
    jp, js, _, tp, ts, _ = run_both(kw, NO_CLIP)
    for a, b in ((whole, tp), (whole_s, ts)):
        for (path, x), (_, y) in zip(convert.leaves(a), convert.leaves(b)):
            assert torch.equal(x, y), path
    for path, want, got in _pairs(jp, tp):
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_factored_second_moment(moment_dtype):
    kw = dict(warmup_steps=2, total_steps=10, moment_dtype=moment_dtype,
              factored_v=True)
    jp, js, _, tp, ts, _ = run_both(kw, NO_CLIP)
    v = dict(convert.leaves(ts["v"]))
    assert v["embed/table/r"].shape == (40,)
    assert v["embed/table/c"].shape == (16,)
    assert "mask_emb/r" not in v                 # 1-D: not factored
    assert_trees(jp, tp, ulps=REDUCTION_ULPS)
    assert_trees(js["v"], ts["v"], ulps=REDUCTION_ULPS)


def test_clipping():
    kw = dict(warmup_steps=2, total_steps=10)
    jp, js, jm, tp, ts, tm = run_both(kw, CLIP)
    assert float(tm["grad_norm"]) > 1.0          # clipping was active
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    assert_trees(jp, tp, ulps=REDUCTION_ULPS)
    assert_trees(js["m"], ts["m"], ulps=REDUCTION_ULPS)


def test_clipping_bounds_a_huge_step():
    """The reference's own case: one huge gradient is clipped to norm 1."""
    c = adamw.AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                          clip_norm=1.0)
    p = {"w": torch.ones(4)}
    p2, _, m = adamw.apply(p, {"w": torch.full((4,), 100.0)},
                           adamw.init(p, c), c)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert torch.isfinite(p2["w"]).all()
    assert float((p2["w"] - 1).abs().max()) < 1.0


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (20, 300)])
def test_schedule(warmup, total):
    """Linear warmup is ``==``; the cosine part within one f32 ulp of
    ``cos`` (XLA's and ATen's may round apart), which ``peak_lr * (1 -
    end_lr_frac) / 2`` scales, plus one ulp of the result.  (Near the end
    ``1 + cos`` cancels, so the result's own ulps do not bound it: the
    reference's jitted and eager schedules stand 5 ulps apart there.)"""
    kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
    jc, c = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    steps = np.arange(0, total + 20, dtype=np.int32)
    want = np.array([np.asarray(jadamw.schedule(jc, jnp.asarray(s)))
                     for s in steps])                # eager, as apply's
    got = adamw.schedule(c, torch.from_numpy(steps)).numpy()
    np.testing.assert_array_equal(got[:warmup], want[:warmup])
    cos_ulp = c.peak_lr * (1 - c.end_lr_frac) / 2 * 2.0 ** -23
    np.testing.assert_allclose(got, want, rtol=2.0 ** -23, atol=cos_ulp)
    assert got[-1] == pytest.approx(3e-5, rel=1e-3)    # end_lr_frac


def test_global_norm():
    rng = np.random.default_rng(1)
    g = _tree(rng, SHAPES, 1.0)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(adamw.global_norm(adamw.tree_map(torch.from_numpy, g)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", sorted(jall_names()))
def test_decay_mask_per_leaf(name):
    """The decay decision of every parameter leaf of every config, by
    the reference's path rule."""
    jp = jax.eval_shape(lambda: jlm.init(jget(name).reduced(),
                                         jax.random.PRNGKey(0)))
    want = {"/".join(str(k.key) for k in path): jadamw._decay_mask(path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {path: adamw._decay_mask(path) for path, _ in
           adamw.tree_leaves(lm.init(get(name).reduced(), device="meta"))}
    assert got == want
    assert any(want.values()) and not all(want.values())


def test_weight_decay_mask_applies():
    c = adamw.AdamWConfig(peak_lr=0.1, warmup_steps=0, weight_decay=0.5)
    p = {"w": torch.ones(4), "ln": {"scale": torch.ones(4)}}
    p3, _, _ = adamw.apply(p, adamw.tree_map(torch.zeros_like, p),
                           adamw.init(p, c), c)
    assert float((p3["w"] - 1).abs().max()) > 0           # decayed
    assert float((p3["ln"]["scale"] - 1).abs().max()) == 0  # masked


@pytest.mark.parametrize("moment_dtype,factored", [("int8", False),
                                                   ("float32", True),
                                                   ("bfloat16", False)])
def test_opt_state_from_jax(moment_dtype, factored):
    """A reference AdamW state of a reduced model carries over through
    ``convert.opt_state_from_jax`` leaf for leaf: int8 ``{q, s}``,
    factored ``{r, c}``, bf16 moments, the int32 step."""
    cfg = get("qwen3-1.7b").reduced()
    kw = dict(moment_dtype=moment_dtype, factored_v=factored)
    jc, c = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jp = jlm.init(jget("qwen3-1.7b").reduced(), jax.random.PRNGKey(0))
    js = jadamw.init(jp, jc)
    g = jax.tree.map(lambda x: jnp.full_like(x, 0.01), jp)
    _, js, _ = jax.jit(jadamw.apply, static_argnums=3)(jp, g, js, jc)
    state = convert.opt_state_from_jax(jax.tree.map(np.asarray, js), cfg, c,
                                       device="cpu")
    template = adamw.init(lm.init(cfg, device="meta"), c)
    for (path, got), (_, want) in zip(convert.leaves(state),
                                      convert.leaves(template)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
    assert int(state["step"]) == 1
    assert_trees(js, state)
    with pytest.raises(ValueError, match="trees differ"):
        convert.opt_state_from_jax(jax.tree.map(np.asarray, js), cfg,
                                   dataclasses.replace(c, factored_v=not
                                                       factored),
                                   device="cpu")


def test_compress_and_compress_tree_bit_exact():
    rng = np.random.default_rng(2)
    g = _tree(rng, SHAPES, 1e-3)
    jef = jcompression.init_state(jax.tree.map(jnp.asarray, g))
    ef = compression.init_state(adamw.tree_map(torch.from_numpy, g))
    assert_trees(jef, ef)
    for _ in range(3):
        jq, jef = jcompression.compress_tree(jax.tree.map(jnp.asarray, g),
                                             jef)
        q, ef = compression.compress_tree(
            adamw.tree_map(torch.from_numpy, g), ef)
        assert_trees(jq, q)
        assert_trees(jef, ef)
    x = torch.from_numpy(g["mask_emb"])
    q1, e1 = compression.compress(x, torch.zeros_like(x, dtype=torch.bfloat16))
    assert q1.dtype == e1.dtype == torch.bfloat16


def test_error_feedback_is_unbiased_over_time():
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(64)
                         .astype(np.float32) * 1e-3)
    ef = torch.zeros_like(g, dtype=torch.bfloat16)
    total = torch.zeros_like(g)
    for _ in range(50):
        q, ef = compression.compress(g, ef)
        total = total + q.float()
    assert float((total - 50 * g).abs().max()) < float(g.abs().max()) * 2.5
