"""The port's sharding specs against the reference's, exactly.

``repro_torch.sharding.rules``' spec half and ``sharding.context`` on
duck-typed meshes (``.shape``, ``.axis_names``), as the reference's own
tests run its rules: every config's parameter, optimizer (f32, bf16,
int8 and factored moments), batch and cache specs ``==`` the reference's
as tuples, on the single-pod ``{data: 16, model: 16}`` and multi-pod
``{pod: 2, data: 16, model: 16}`` meshes, in every ``tp_mode``.  Nothing
here starts a process group.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as JSHAPES
from repro.configs import all_names
from repro.configs import get as jget
from repro.configs.base import input_specs as jinput_specs
from repro.launch.params import param_shapes as jparam_shapes
from repro.models import model as jlm
from repro.optim import adamw as jadamw
from repro.sharding import context as jcontext
from repro.sharding import rules as jrules
from repro_torch.configs import SHAPES, get
from repro_torch.configs.base import input_specs
from repro_torch.launch.params import param_shapes
from repro_torch.models import model as lm
from repro_torch.optim import adamw
from repro_torch.sharding import context, rules
from repro_torch.sharding.context import P


class FakeMesh:
    def __init__(self, axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


SINGLE = {"data": 16, "model": 16}
MULTI = {"pod": 2, "data": 16, "model": 16}
MESHES = [SINGLE, MULTI]
TP_MODES = ("allreduce", "allgather", "ame_pim")
#: (moment_dtype, factored_v)
MOMENTS = [("float32", False), ("bfloat16", False), ("int8", False),
           ("float32", True)]


def jflat(tree):
    """Path -> spec as a tuple, of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jrules._path_str(p): tuple(s) for p, s in leaves}


def tflat(tree):
    return {p: tuple(s) for p, s in adamw.tree_leaves(tree)}


@pytest.mark.parametrize("arch", all_names())
def test_param_and_opt_specs_match_the_reference(arch):
    for tp in TP_MODES:
        jc, tc = jget(arch).with_policy(tp_mode=tp), \
            get(arch).with_policy(tp_mode=tp)
        jps, tps = jparam_shapes(jc), param_shapes(tc)
        for axes in MESHES:
            m = FakeMesh(axes)
            assert tflat(rules.param_pspecs(tc, tps, m)) \
                == jflat(jrules.param_pspecs(jc, jps, m)), (tp, axes)
            for md, fv in MOMENTS:
                jo = jax.eval_shape(lambda p: jadamw.init(
                    p, jadamw.AdamWConfig(moment_dtype=md, factored_v=fv)),
                    jps)
                to = adamw.init(tps, adamw.AdamWConfig(moment_dtype=md,
                                                       factored_v=fv))
                assert tflat(rules.opt_pspecs(tc, to, m)) \
                    == jflat(jrules.opt_pspecs(jc, jo, m)), (tp, axes, md)


@pytest.mark.parametrize("arch", all_names())
def test_batch_and_cache_specs_match_the_reference(arch):
    jc, tc = jget(arch), get(arch)
    for axes in MESHES:
        m = FakeMesh(axes)
        for name, shape in SHAPES.items():
            assert tflat(rules.batch_pspecs(tc, input_specs(tc, shape), m)) \
                == jflat(jrules.batch_pspecs(
                    jc, jinput_specs(jc, JSHAPES[name]), m)), (name, axes)
            if shape.kind == "train":
                continue
            b, t = shape.global_batch, shape.seq_len
            jcs = jax.eval_shape(lambda: jlm.make_caches(jc, b, t))
            tcs = lm.make_caches(tc, b, t, device="meta")
            assert tflat(rules.cache_pspecs(tc, tcs, m)) \
                == jflat(jrules.cache_pspecs(jc, jcs, m)), (name, axes)


def test_sharding_rules_cover_all_archs():
    """Every parameter of every full config gets a valid spec on a mock
    16x16 mesh (divisibility-checked) (the reference's
    ``test_distributed.py`` test, on the port)."""
    m = FakeMesh(SINGLE)
    for name in all_names():
        cfg = get(name)
        shapes = param_shapes(cfg)
        specs = dict(adamw.tree_leaves(rules.param_pspecs(cfg, shapes, m)))
        for path, leaf in adamw.tree_leaves(shapes):
            spec = specs[path]
            assert len(spec) <= leaf.dim(), (name, path)
            for dim, ax in enumerate(spec):
                if ax is None:
                    continue
                size = 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    size *= SINGLE[a]
                assert leaf.shape[dim] % size == 0, (name, path, spec)


def test_embedding_and_ffn_sharded_on_model_axis():
    cfg = get("command-r-35b")
    specs = rules.param_pspecs(cfg, param_shapes(cfg), FakeMesh(SINGLE))
    assert specs["embed"]["table"][0] == "model"        # vocab on model
    wi = specs["stack"]["dense_stack"]["mlp"]["wi"]["w"]
    assert wi[-1] == "model" and wi[-2] == "data"       # TP + FSDP
    wo = specs["stack"]["dense_stack"]["mlp"]["wo"]["w"]
    assert wo[-2] == "model"                 # row-sharded (allreduce TP)
    ag = rules.param_pspecs(cfg.with_policy(tp_mode="allgather"),
                            param_shapes(cfg), FakeMesh(SINGLE))
    assert ag["stack"]["dense_stack"]["mlp"]["wo"]["w"][-1] == "model"


@pytest.mark.parametrize("axes", [(("data",), None), ("data", None),
                                  (("pod", "data"), "model"), (), (None,),
                                  ((), "model")])
def test_spec_compares_to_jax_as_a_tuple(axes):
    """``P`` stores a one-name tuple as the name and an empty tuple as
    ``None``, as JAX's ``PartitionSpec`` does."""
    assert tuple(P(*axes)) == tuple(JP(*axes))


def test_placements_shard_a_two_axis_dim_pod_major():
    m = FakeMesh(MULTI)
    assert context.placements(P(("pod", "data"), None, "model"), m) \
        == [Shard(0), Shard(0), Shard(2)]
    assert context.placements(P(None, None), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        context.placements(P(("data", "pod")), m)
    tree = rules.to_placements({"a": P("model", None), "b": {"c": P()}}, m)
    assert tree == {"a": [Replicate(), Replicate(), Shard(0)],
                    "b": {"c": [Replicate()] * 3}}


@pytest.mark.parametrize("axes", MESHES)
def test_resolve_axis_and_spec_match_the_reference(axes):
    m = FakeMesh(axes)
    for logical in (None, "batch", "batch_heads", "fsdp", "model", "pod",
                    "expert"):
        assert context.resolve_axis(logical, m) \
            == jcontext.resolve_axis(logical, m), logical


def test_uneven_dims_are_replicated():
    """``_fits`` drops an axis that does not divide its dim (8 KV heads on
    a 16-way model axis), as the reference does; DTensor itself would
    take the uneven shards."""
    m = FakeMesh(SINGLE)
    for shape, spec in [((8, 128), ("model", None)),
                        ((32, 8), (("data",), "model")),
                        ((3,), (None, "model"))]:
        assert tuple(rules._fits(shape, spec, m)) \
            == tuple(jrules._fits(shape, spec, m))
    assert tuple(rules._fits((8, 128), ("model", None), m)) == (None, None)


def test_constraints_are_no_ops_without_a_mesh():
    """With no mesh set, or on a plain tensor under one, ``constrain``
    returns its argument, so every single-device result is unchanged."""
    x = torch.randn(4, 8)
    assert context.current_mesh() is None
    assert context.constrain(x, "batch", "model") is x
    assert context.spec("batch", "model") == P()
    assert context.named_sharding("batch") is None
    with context.use_mesh(FakeMesh(SINGLE)):
        assert context.constrain(x, "batch", "model") is x
        assert context.spec("batch", "model") == P("data", "model")
    assert context.current_mesh() is None


def test_sharded_einsum_is_torch_einsum_on_plain_tensors():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(2, 3, 4, generator=g), torch.randn(2, 4, 5, generator=g)
    assert torch.equal(context.einsum("bij,bjk->bik", a, b),
                       torch.einsum("bij,bjk->bik", a, b))
