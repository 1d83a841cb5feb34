"""The port's training loss against the JAX reference on the CPU.

For every registered config at ``reduced()`` size with f32 compute, the
reference's parameters (``lm.init``) are carried over through
``convert.params_from_jax`` and a batch of the reference's
``SyntheticLM`` goes through both ``loss_fn``s: the loss and every metric
(``ce``, ``aux``, ``tokens``, ``mtp``, ``loss``), and the gradient of
every parameter leaf by autograd against ``jax.grad``.  The encoder and
VLM families' own checks, remat, the bf16 case and the kernel backend's
refusal of a gradient are in tests/test_torch_train_families.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import SHAPES as JSHAPES
from repro.configs import all_names as jall_names
from repro.configs import get as jget
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as jlm
from repro_torch.configs import all_names, get
from repro_torch.models import convert
from repro_torch.models import model as lm
from repro_torch.train.loop import batch_to, grad_tree, trainable

#: f32 compute: the same sums in another order (XLA vs ATen), so a loss
#: of ~6.6 agrees to a few f32 ulps (measured <= 1e-6 relative)
LOSS_TOL = dict(rel=1e-5, abs=1e-6)
#: a gradient leaf, against the largest entry of the reference's leaf:
#: backward sums over every token and layer in another order (measured
#: <= 1.9e-5 of the leaf's scale, the SSM's dt_bias the worst)
GRAD_REL_TOL = 1e-4
BATCH, SEQ = 2, 32


def setup(name, compute_dtype="float32", seq=SEQ):
    """(jcfg, jparams, cfg, params requiring grad, numpy batch)."""
    jcfg = jget(name).reduced().with_policy(compute_dtype=compute_dtype)
    cfg = get(name).reduced().with_policy(compute_dtype=compute_dtype)
    jp = jlm.init(jcfg, jax.random.PRNGKey(0))
    params = trainable(convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                               cfg, device="cpu"))
    batch = JSyntheticLM(jcfg, JSHAPES["train_4k"], seed=1,
                         batch_override=BATCH, seq_override=seq).batch(0)
    return jcfg, jp, cfg, params, batch


def jax_loss_and_grads(jcfg, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, mets), g = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb, jcfg), has_aux=True))(jp)
    return float(loss), {k: float(v) for k, v in mets.items()}, \
        dict(convert.leaves(jax.tree.map(
            lambda x: np.asarray(x, np.float32), g)))


def grad_errors(grads, ref):
    """max |g - g_ref| / max |g_ref| for every leaf."""
    return {path: float(np.abs(g.float().numpy() - ref[path]).max()
                        / max(np.abs(ref[path]).max(), 1e-30))
            for path, g in convert.leaves(grads)}


def test_every_registered_config_is_covered():
    assert sorted(all_names()) == sorted(jall_names())


@pytest.mark.parametrize("name", sorted(jall_names()))
def test_loss_metrics_and_grads_match_jax(name):
    jcfg, jp, cfg, params, batch = setup(name)
    jloss, jmets, jgrads = jax_loss_and_grads(jcfg, jp, batch)
    loss, mets = lm.loss_fn(params, batch_to(batch, "cpu"), cfg)
    assert set(mets) == set(jmets)
    assert set(mets) >= {"ce", "aux", "tokens", "loss"}
    assert ("mtp" in mets) == cfg.mtp
    for k, v in mets.items():
        assert float(v.detach()) == pytest.approx(jmets[k], **LOSS_TOL), k
    assert float(loss.detach()) == pytest.approx(jloss, **LOSS_TOL)
    grads = grad_tree(loss, params)
    assert set(dict(convert.leaves(grads))) == set(jgrads)
    errs = grad_errors(grads, jgrads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL_TOL, (worst, errs[worst])
