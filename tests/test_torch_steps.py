"""The port's step builders and accounting against the reference's, on the
CPU and without a process group.

* ``launch/params``, ``launch/modelflops`` and ``launch/memmodel``
  (given the reference's 16 GiB capacity) ``==`` the reference's for
  every config and every ``SHAPES`` cell, on both production meshes.
* ``launch/steps``' abstract shapes equal ``jax.eval_shape``'s, and the
  specs its builders return equal the reference's rules on the same
  shapes (a duck-typed mesh: the builders read only its sizes until the
  step runs).
* ``_split_microbatches`` splits as the reference's does.

The steps themselves run on real meshes in ``test_torch_distributed.py``.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import all_names
from repro.configs import get as jget
from repro.configs.base import input_specs as jinput_specs
from repro.launch import memmodel as jmem
from repro.launch import modelflops as jflops
from repro.launch import params as jparams
from repro.launch import steps as jsteps
from repro.models import model as jlm
from repro.optim import adamw as jadamw
from repro.sharding import rules as jrules
from repro_torch.configs import SHAPES, get
from repro_torch.launch import hw, memmodel, modelflops, params, steps
from repro_torch.optim import adamw
from test_torch_sharding import FakeMesh, MULTI, SINGLE, jflat, tflat

#: the reference's per-chip capacity (repro/launch/hw.py), passed in
REF_HBM = 16 * 2 ** 30


@pytest.mark.parametrize("arch", all_names())
def test_accounting_matches_the_reference(arch):
    jc, tc = jget(arch), get(arch)
    assert params.count_params(tc) == jparams.count_params(jc)
    assert params.param_bytes(tc) == jparams.param_bytes(jc)
    assert modelflops.active_params(tc) == jflops.active_params(jc)
    for name, shape in SHAPES.items():
        assert modelflops.model_flops(tc, shape) \
            == jflops.model_flops(jc, JSHAPES[name]), name
        for axes in (None, MULTI):
            assert memmodel.estimate(tc, shape, axes, hbm_bytes=REF_HBM) \
                == jmem.estimate(jc, JSHAPES[name], axes), (name, axes)


def test_memmodel_all_cells_estimable_on_the_card():
    """The reference's ``test_memmodel_all_cells_estimable`` with the
    card's capacity (the H100 SXM data sheet's 80 GB): every applicable
    cell fits a device of the single-pod mesh."""
    from repro_torch.configs import applicable
    assert hw.HBM_BYTES == 80 * 10 ** 9
    for name in all_names():
        cfg = get(name)
        for shape in SHAPES.values():
            if not applicable(cfg, shape)[0]:
                continue
            est = memmodel.estimate(cfg, shape)
            assert est["total"] > 0
            assert est["fits_16g"], (name, shape.name, est["total"] / 2 ** 30)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x22b",
                                  "mamba2-370m", "zamba2-2.7b",
                                  "deepseek-v3-671b"])
def test_abstract_shapes_match_eval_shape(arch):
    jc, tc = jget(arch), get(arch)
    oc, joc = adamw.AdamWConfig(moment_dtype="int8"), \
        jadamw.AdamWConfig(moment_dtype="int8")
    for mine, theirs in [
            (steps.abstract_params(tc), jsteps.abstract_params(jc)),
            (steps.abstract_opt(tc, oc), jsteps.abstract_opt(jc, joc))]:
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in adamw.tree_leaves(mine)}
        want = {jrules._path_str(p): (tuple(v.shape), str(v.dtype))
                for p, v in jax.tree_util.tree_flatten_with_path(theirs)[0]}
        assert got == want


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mixtral-8x22b",
                                  "mamba2-370m", "internvl2-76b",
                                  "hubert-xlarge"])
@pytest.mark.parametrize("axes", [SINGLE, MULTI])
def test_step_specs_match_the_reference_rules(arch, axes):
    """Each builder's returned specs are the reference's rules on the
    reference's shapes; the serve steps' logits specs as the reference's
    builders make them."""
    jc, tc = jget(arch), get(arch)
    m = FakeMesh(axes)
    baxes = ("pod", "data") if "pod" in axes else ("data",)
    for name, shape in SHAPES.items():
        kind, _, shapes, specs = steps.make_step_for(tc, m, shape)
        jshape = JSHAPES[name]
        jps = jsteps.abstract_params(jc)
        assert tflat(specs[0]) == jflat(jrules.param_pspecs(jc, jps, m))
        if kind == "train_step":
            jos = jsteps.abstract_opt(jc, jadamw.from_policy(jc.policy))
            assert tflat(specs[1]) == jflat(jrules.opt_pspecs(jc, jos, m))
            assert tflat(specs[2]) == jflat(jrules.batch_pspecs(
                jc, jinput_specs(jc, jshape), m))
            continue
        if kind == "prefill_step":
            assert tflat(specs[1]) == jflat(jrules.batch_pspecs(
                jc, jinput_specs(jc, jshape), m))
            cache_len = jshape.seq_len
        else:
            cache_len = (min(jshape.seq_len, jc.sliding_window)
                         if jc.sliding_window else jshape.seq_len)
            bax = baxes if jshape.global_batch % np.prod(
                [axes[a] for a in baxes]) == 0 else None
            assert tuple(specs[1]) == tuple(JP(bax, None))
            assert tuple(specs[2]) == tuple(JP(bax))
        jcs = jax.eval_shape(
            lambda: jlm.make_caches(jc, jshape.global_batch, cache_len))
        assert tflat(specs[-1]) == jflat(jrules.cache_pspecs(jc, jcs, m)), \
            (name, kind)


def test_split_microbatches_matches_the_reference():
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 9, (8, 6)),
             "frames": rng.standard_normal((8, 6, 3)).astype(np.float32)}
    want = jsteps._split_microbatches(
        {k: jax.numpy.asarray(v) for k, v in batch.items()}, 4)
    got = steps._split_microbatches(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 4)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
