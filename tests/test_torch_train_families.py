"""Training-side checks of the port beyond the per-config loss
(tests/test_torch_train_model.py), on the CPU against the JAX reference:

* the bf16 loss and gradients, within twice the reference's own bf16
  distance from its f32 result;
* remat (``torch.utils.checkpoint`` per block) changes no gradient, and
  really recomputes each block in backward;
* the encoder (hubert): the loss ignores targets outside the mask, and
  the stack is not causal;
* the VLM (internvl2): prefill with patch embeddings ahead of the text and
  three decode steps against XLA and PALLAS (interpret mode);
* ``_sinusoidal`` against the reference's;
* the kernel backend is forward-only: a gradient through it raises, on
  the CPU as on the card, and under ``torch.no_grad()`` nothing changes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.models import model as jlm
from repro.models.layers import PALLAS, XLA
from repro_torch.configs import get
from repro_torch.kernels import ops
from repro_torch.models import convert
from repro_torch.models import model as lm
from repro_torch.models import transformer as tf
from repro_torch.train.loop import batch_to, grad_tree
from test_torch_train_model import jax_loss_and_grads, setup

#: f32 logits of the VLM's prefill and decode (as the dense serve tests)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
#: the port's bf16 run may stand this many times the reference's own
#: bf16-vs-f32 distance from the reference's bf16 run: both round the same
#: f32 function to bf16, at other places (tests/test_torch_ssm.py's rule)
BF16_NOISE_FACTOR = 2.0


def test_bf16_loss_and_grads_within_jax_noise():
    """Every gradient leaf within BF16_NOISE_FACTOR x the reference's own
    bf16-vs-f32 distance of that leaf (a maximum over all its entries).
    The loss, a mean over tokens whose bf16 errors partly cancel, has no
    such yardstick (its bf16-vs-f32 distance was 4.7e-4 here, the port's
    1.4e-3 from the reference's bf16 loss): it is held to one bf16 ulp of
    its magnitude, the precision a bf16 computation of it has."""
    jcfg, jp, cfg, params, batch = setup("qwen3-1.7b", "bfloat16")
    jl, _, jg = jax_loss_and_grads(jcfg, jp, batch)
    _, _, jg32 = jax_loss_and_grads(jcfg.with_policy(
        compute_dtype="float32"), jp, batch)
    loss, _ = lm.loss_fn(params, batch_to(batch, "cpu"), cfg)
    assert abs(float(loss.detach()) - jl) <= 2.0 ** (np.floor(np.log2(abs(jl))) - 7)
    grads = dict(convert.leaves(grad_tree(loss, params)))
    for path, ref in jg.items():
        noise = np.abs(ref - jg32[path]).max()
        err = np.abs(grads[path].float().numpy() - ref).max()
        assert err <= BF16_NOISE_FACTOR * noise, (path, err, noise)


@pytest.mark.parametrize("name,fn", [("qwen3-1.7b", "block_apply"),
                                     ("mamba2-370m", "_mamba_layer"),
                                     ("zamba2-2.7b", "_mamba_layer")])
def test_remat_gives_the_same_gradients(name, fn, monkeypatch):
    """``policy.remat`` on (the configs' default) and off: equal losses
    and gradients, bit for bit; with it on, each block runs again in
    backward."""
    _, _, cfg, params, batch = setup(name)
    assert cfg.policy.remat
    inner, calls = getattr(tf, fn), []

    def counted(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return inner(*a, **kw)
    monkeypatch.setattr(tf, fn, counted)
    out = {}
    for remat in (True, False):
        calls.clear()
        c = cfg.with_policy(remat=remat)
        loss, _ = lm.loss_fn(params, batch_to(batch, "cpu"), c)
        forward = len(calls)
        grads = grad_tree(loss, params)
        out[remat] = loss, grads, forward, len(calls) - forward
    (l1, g1, f1, b1), (l0, g0, f0, b0) = out[True], out[False]
    assert torch.equal(l1, l0)
    for (path, a), (_, b) in zip(convert.leaves(g1), convert.leaves(g0)):
        assert torch.equal(a, b), path
    assert f1 == f0 > 0 and b0 == 0 and b1 == f1   # recomputed in backward


def _hubert():
    cfg = get("hubert-xlarge").reduced()
    return cfg, lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_hubert_loss_ignores_targets_outside_the_mask():
    cfg, params = _hubert()
    rng = np.random.default_rng(3)
    b, t = 2, 32
    frames = torch.from_numpy(rng.standard_normal((b, t, cfg.d_model))
                              .astype(np.float32) * 0.1)
    targets = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, t)))
    mask = torch.zeros((b, t), dtype=torch.bool)
    mask[:, :4] = True
    l0, m0 = lm.loss_fn(params, {"frames": frames, "mask": mask,
                                 "targets": targets}, cfg)
    flipped = targets.clone()
    flipped[:, 10:] = (flipped[:, 10:] + 1) % cfg.vocab_size
    l1, _ = lm.loss_fn(params, {"frames": frames, "mask": mask,
                                "targets": flipped}, cfg)
    assert float(m0["tokens"]) == b * 4
    assert torch.equal(l0, l1)


def test_encoder_is_not_causal():
    """A change to the last frame moves the encoder's first position (and
    the reference's, from the same parameters)."""
    cfg, params = _hubert()
    jcfg = jget("hubert-xlarge").reduced()
    jp = jlm.init(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((1, 16, cfg.d_model)).astype(np.float32)
    frames2 = frames.copy()       # not a constant shift: layernorm drops it
    frames2[0, -1] += rng.standard_normal(cfg.d_model).astype(np.float32)
    outs = []
    for f in (frames, frames2):
        h, pos, _ = lm._embed_inputs(params, {"frames": torch.from_numpy(f)},
                                     cfg)
        h, _, _ = tf.decoder_apply(params["stack"], h, cfg, positions=pos,
                                   causal=False)
        jh, jpos, _ = jlm._embed_inputs(jp, {"frames": jnp.asarray(f)}, jcfg)
        jh, _, _ = jlm._family_fns(jcfg)[1](jp["stack"], jh, jcfg,
                                            positions=jpos, caches=None,
                                            causal=False)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **F32_TOL)
        outs.append(h)
    assert float((outs[0][:, 0] - outs[1][:, 0]).abs().max()) > 1e-4


@pytest.fixture(scope="module")
def vlm():
    jcfg = jget("internvl2-76b").reduced()
    cfg = get("internvl2-76b").reduced()
    jp = jlm.init(jcfg, jax.random.PRNGKey(0))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     device="cpu")
    return jcfg, jp, cfg, params


@pytest.mark.parametrize("backend,jbackend", [("torch", XLA),
                                              ("kernel", PALLAS)],
                         ids=["torch-xla", "kernel-pallas"])
def test_vlm_prefill_and_decode_match_jax(vlm, backend, jbackend):
    """8 patch embeddings ahead of 12 text tokens, then 3 decode steps fed
    the reference's greedy tokens; logits and the KV cache."""
    jcfg, jp, cfg, params = vlm
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    vis = (rng.standard_normal((2, 8, cfg.d_model)) * 0.1).astype(np.float32)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks),
                              "vision_embeds": jnp.asarray(vis)}, jcfg,
                         cache_len=32, backend=jbackend)
    tl, tc = lm.prefill(params, {"tokens": torch.from_numpy(toks).long(),
                                 "vision_embeds": torch.from_numpy(vis)},
                        cfg, cache_len=32, backend=backend)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    np.testing.assert_allclose(tc["dense_stack"]["k"].numpy(),
                               np.asarray(jc["dense_stack"]["k"]), **F32_TOL)
    pos = np.full((2,), 20, np.int32)
    for _ in range(3):
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        jl, jc = jlm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc,
                                 jcfg, backend=jbackend)
        tl, tc = lm.decode_step(params, torch.from_numpy(nxt).long(),
                                torch.from_numpy(pos).long(), tc, cfg,
                                backend=backend)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
        pos = pos + 1


@pytest.mark.parametrize("t,d", [(1, 8), (37, 64), (1024, 1280)])
def test_sinusoidal_matches_reference(t, d):
    """The angle ``pos / 10000 ** (dim / d)`` may round one f32 ulp apart
    (``pow`` of XLA and ATen), which moves its sine by up to the angle's
    ulp, ``spacing(t)`` at the last position; and ``sin``/``cos`` may
    round a few ulps of 1 apart."""
    got = lm._sinusoidal(t, d, torch.float32)
    want = np.asarray(jlm._sinusoidal(t, d, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 + np.spacing(np.float32(t)))


def test_kernel_backend_refuses_a_gradient():
    """On the CPU the kernel backend takes the plain (differentiable)
    versions, so without the refusal a gradient would flow here and be
    dropped on the card; it raises instead, and under ``no_grad`` the
    loss equals the torch backend's."""
    _, _, cfg, params, batch = setup("mamba2-370m")
    b = batch_to(batch, "cpu")
    with pytest.raises(RuntimeError, match="forward-only"):
        lm.loss_fn(params, b, cfg, backend="kernel")
    with torch.no_grad():
        lk, _ = lm.loss_fn(params, b, cfg, backend="kernel")
        lt, _ = lm.loss_fn(params, b, cfg, backend="torch")
    assert torch.equal(lk, lt)


@pytest.mark.parametrize("call", ["gemm", "elementwise", "ssd", "ssd4",
                                  "attention"])
def test_every_kernel_dispatch_is_forward_only(call):
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    args = {"gemm": lambda: (r(4, 8), r(8, 6)),
            "elementwise": lambda: ("add", r(4, 8), r(4, 8)),
            "ssd": lambda: (r(2, 16, 4), -r(2, 16).abs(), r(2, 16, 4),
                            r(2, 16, 4)),
            "ssd4": lambda: (r(1, 2, 16, 4), -r(1, 2, 16).abs(),
                             r(1, 2, 16, 4), r(1, 2, 16, 4)),
            "attention": lambda: (r(2, 4, 8), r(2, 4, 8), r(2, 4, 8))}[call]
    fn = getattr(ops, call)
    plain = fn(*args(), use_kernel=True)        # no operand needs a grad
    a = args()
    tensors = [x for x in a if torch.is_tensor(x)]
    tensors[-1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward-only"):
        fn(*a, use_kernel=True)
    with torch.no_grad():
        fn(*a, use_kernel=True)
    out = fn(*a, use_kernel=False)              # the plain path trains
    assert out.requires_grad and out.shape == plain.shape
