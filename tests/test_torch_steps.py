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
* The sharded train step sums its microbatch gradients into one tree in
  place, as the reference's ``lax.scan`` carries one
  (``memmodel.estimate`` counts one): its traced peak on a 1-rank fake
  world stays at one microbatch's, and on a 1-rank ``gloo`` world its
  parameters, optimizer state and loss are ``torch.equal`` to the same
  step summed out of place.  Each runs in a subprocess of its own (a
  process group is global to its process).

The steps themselves run on real meshes in ``test_torch_distributed.py``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

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
ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))


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


#: the microbatched steps' reduced qwen3-1.7b (examples/distributed_train.py's
#: widths): parameters dominate its memory, so one extra gradient tree
#: shows in the peak
TINY_QWEN3 = """
from repro_torch.configs import get
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import make_debug_mesh
def tiny(mb):
    return get("qwen3-1.7b").reduced().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=512).with_policy(microbatches=mb)
"""

PEAK_SCRIPT = TINY_QWEN3 + """
import json
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch import dryrun, steps, traceanalysis
dryrun.fake_world(1)
mesh = make_debug_mesh((1, 1), device="cpu")
shape = ShapeSpec("tiny", 8, 8, "train")
out = {}
for mb in (1, 2, 4):
    cfg = tiny(mb)
    fn, shapes, specs = steps.make_train_step(cfg, mesh, shape)
    with FakeTensorMode():
        args = dryrun._inputs(cfg, shape, "train_step", shapes, specs, mesh)
        _, rep = traceanalysis.trace(fn, *args)
        out["tree"] = traceanalysis.local_bytes(args[0])
    out[mb] = rep.peak_bytes
print(json.dumps(out))
"""


def _run(script):
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_microbatches_add_no_gradient_tree_to_the_traced_peak():
    """The sharded train step traced under ``FakeTensorMode`` on a 1x1
    mesh: at 2 and 4 microbatches its peak stays within a tenth of one
    parameter tree of the 1-microbatch peak (summed out of place, the
    accumulator, the microbatch's tree and their sum are live at once:
    one tree more)."""
    out = _run(PEAK_SCRIPT)
    tree = out["tree"]
    assert tree > 0 and out["1"] > tree
    for mb in ("2", "4"):
        assert out[mb] - out["1"] <= tree / 10, (mb, out)


EQUAL_SCRIPT = TINY_QWEN3 + """
import json, torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import steps
from repro_torch.models import model as lm
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.sharding.context import use_mesh
from repro_torch.train.loop import batch_to, grad_tree

MB, STEPS = 4, 2
dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
mesh = make_debug_mesh((1, 1), device="cpu")
cfg = tiny(MB)
shape = ShapeSpec("tiny", 16, 8, "train")
oc = adamw.AdamWConfig(peak_lr=5e-3, warmup_steps=1, total_steps=10)
fn, _, (pspec, ospec, bspec) = steps.make_train_step(cfg, mesh, shape,
                                                     opt_cfg=oc)
ppl = rules.to_placements(pspec, mesh)


def oracle(params, opt, batch):
    # the step with its microbatch gradients summed out of place
    params = adamw.tree_map(lambda p: p.requires_grad_(True), params)
    with use_mesh(mesh), implicit_replication():
        grads = adamw.tree_map(lambda p: torch.zeros_like(p), params)
        ls = []
        for mbatch in steps._microbatches(batch, MB, mesh, cfg):
            loss, _ = lm.loss_fn(params, mbatch, cfg)
            g = adamw.tree_map(lambda g, pl: g.redistribute(mesh, pl),
                               grad_tree(loss, params), ppl)
            grads = adamw.tree_map(lambda a, gg: a + gg.to(a.dtype), grads,
                                   g)
            ls.append(loss.detach())
        grads = adamw.tree_map(lambda g: g / MB, grads)
        params = adamw.tree_map(lambda p: p.requires_grad_(False), params)
        params, opt, _ = adamw.apply(params, grads, opt, oc)
        return params, opt, {"loss_out": torch.stack(ls).mean()}


def full(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def leaves(tree):
    return [full(x) for _, x in adamw.tree_leaves(tree)]


params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
pipe = SyntheticLM(cfg, shape, seed=0)
runs = []
for step_fn in (fn, oracle):
    p = rules.distribute(adamw.tree_map(torch.clone, params), pspec, mesh)
    o = rules.distribute(adamw.init(params, oc), ospec, mesh)
    losses = []
    for i in range(STEPS):
        b = rules.distribute(batch_to(pipe.batch(i), "cpu"), bspec, mesh)
        p, o, m = step_fn(p, o, b)
        losses.append(full(m["loss_out"]))
    runs.append((leaves(p), leaves(o), losses))
(p1, o1, l1), (p2, o2, l2) = runs
print(json.dumps({
    "leaves": [len(p1), len(o1)],
    "params": [bool(torch.equal(a, b)) for a, b in zip(p1, p2)],
    "opt": [bool(torch.equal(a, b)) for a, b in zip(o1, o2)],
    "loss": [[float(a), float(b)] for a, b in zip(l1, l2)],
    "loss_equal": [bool(torch.equal(a, b)) for a, b in zip(l1, l2)]}))
"""


def test_in_place_accumulation_equals_the_out_of_place_sum():
    """Two steps at 4 microbatches on a 1-rank ``gloo`` world (1x1 mesh):
    the parameters, the optimizer state and the loss ``torch.equal`` to
    the step that sums the microbatch gradients out of place (kept here as
    the oracle): the same operations in the same order."""
    out = _run(EQUAL_SCRIPT)
    assert out["leaves"][0] > 0 and out["leaves"][1] > 0
    assert len(out["params"]) == out["leaves"][0] and all(out["params"])
    assert len(out["opt"]) == out["leaves"][1] and all(out["opt"])
    assert all(out["loss_equal"]), out["loss"]
    assert out["loss"][1][0] < out["loss"][0][0]
