"""The port's data pipeline and checkpoints against the JAX reference.

``SyntheticLM`` is the reference's numpy code in the port's package: its
batches are ``==`` for text, audio frames and VLM patches, across steps
and shards.  ``CheckpointManager`` keeps the reference's files
(``step_XXXXXXXX/arrays.npz`` with '/'-joined keys, ``meta.json``), so
an f32 checkpoint written by either package restores in the other to
equal arrays; bf16 leaves are stored as their raw bits.
"""
import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import CheckpointManager as JCheckpointManager
from repro.configs import SHAPES as JSHAPES
from repro.configs import get as jget
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import SHAPES, get
from repro_torch.data.pipeline import PipelineState, SyntheticLM


@pytest.mark.parametrize("name", ["qwen3-1.7b", "hubert-xlarge",
                                  "internvl2-76b"])
@pytest.mark.parametrize("shard,num_shards", [(0, 1), (1, 2)])
def test_synthetic_batches_equal_the_reference(name, shard, num_shards):
    kw = dict(seed=5, shard=shard, num_shards=num_shards, batch_override=8,
              seq_override=32, active_vocab=64)
    mine = SyntheticLM(get(name).reduced(), SHAPES["train_4k"], **kw)
    ref = JSyntheticLM(jget(name).reduced(), JSHAPES["train_4k"], **kw)
    keys = {"qwen3-1.7b": {"tokens", "targets", "loss_mask"},
            "hubert-xlarge": {"frames", "mask", "targets"},
            "internvl2-76b": {"tokens", "targets", "loss_mask",
                              "vision_embeds"}}[name]
    for step in (0, 3):
        a, b = mine.batch(step), ref.batch(step)
        assert set(a) == set(b) == keys
        for k in keys:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert mine.batch(0)["targets"].shape[0] == 8 // num_shards


def test_pipeline_deterministic_sharded_and_iterable():
    cfg = get("qwen3-1.7b").reduced()
    kw = dict(seed=5, batch_override=8, seq_override=32)
    pipe = SyntheticLM(cfg, SHAPES["train_4k"], **kw)
    np.testing.assert_array_equal(pipe.batch(3)["tokens"],
                                  pipe.batch(3)["tokens"])
    assert not np.array_equal(pipe.batch(3)["tokens"],
                              pipe.batch(4)["tokens"])
    p0, p1 = (SyntheticLM(cfg, SHAPES["train_4k"], shard=s, num_shards=2,
                          **kw) for s in (0, 1))
    assert not np.array_equal(p0.batch(0)["tokens"], p1.batch(0)["tokens"])
    state = PipelineState.from_dict({"step": 2})
    it = pipe.iterate(state)
    np.testing.assert_array_equal(next(it)["tokens"], pipe.batch(2)["tokens"])
    next(it)
    assert state.to_dict() == {"step": 3}        # advanced past batch 2


def _state():
    """A training-state-like tree: f32, bf16, int8 and int32 leaves in a
    (params, opt_state) tuple."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 4, generator=g),
              "h": {"b": torch.randn(5, generator=g).to(torch.bfloat16)}}
    opt = {"m": {"w": {"q": torch.randint(-127, 128, (3, 4), generator=g,
                                          dtype=torch.int8),
                       "s": torch.rand(3, 1, generator=g)}},
           "step": torch.tensor(7, dtype=torch.int32)}
    return params, opt


def _assert_same(a, b):
    for (ka, x), (kb, y) in zip(ckpt._leaves(a), ckpt._leaves(b)):
        assert ka == kb and x.dtype == y.dtype and torch.equal(x, y), ka


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _state()
    for step in (1, 2, 3):
        mgr.save(step, state, meta={"pipeline": {"step": step}},
                 blocking=True)
    assert mgr.latest_step() == 3
    assert sorted(mgr.steps()) == [2, 3]               # gc kept the last 2
    restored, meta = mgr.restore(state)
    _assert_same(restored, state)
    assert meta["pipeline"]["step"] == 3 and meta["step"] == 3
    assert meta[ckpt.DTYPES_KEY] == {"[0]/h/b": "bfloat16"}
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as npz:
        assert sorted(npz.files) == ["[0]/h/b", "[0]/w", "[1]/m/w/q",
                                     "[1]/m/w/s", "[1]/step"]
        assert npz["[0]/h/b"].dtype == np.uint16
    restored2, _ = mgr.restore(state, step=2)
    _assert_same(restored2, state)
    with pytest.raises(ValueError, match="ckpt"):
        mgr.restore(({"w": torch.zeros(4, 3), "h": state[0]["h"]}, state[1]))


def test_checkpoint_atomicity_tmp_never_visible(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    (tmp_path / "step_00000009.tmp").mkdir()          # a write cut short
    mgr.save(7, {"x": torch.ones(2)}, blocking=True)
    assert mgr.steps() == [7] and mgr.latest_step() == 7
    assert not list(tmp_path.glob("step_00000007.tmp"))


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """The write runs on a thread, one at a time; what it writes is the
    state as it was when ``save`` was called, even if the caller updates
    the tensors in place before the thread gets to them."""
    gate = threading.Event()
    real = np.savez

    def held(*a, **kw):
        assert gate.wait(timeout=30)
        return real(*a, **kw)
    monkeypatch.setattr(np, "savez", held)
    mgr = CheckpointManager(tmp_path)
    x = torch.zeros(4)
    mgr.save(1, {"x": x})
    x.add_(1.0)                                       # the next train step
    assert mgr.latest_step() is None                  # not yet published
    gate.set()
    mgr.wait()
    restored, _ = mgr.restore({"x": x})
    assert torch.equal(restored["x"], torch.zeros(4))


def test_f32_checkpoints_cross_between_packages(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((2, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(4).astype(np.float32)},
            "step": np.int32(5)}
    jstate = (jax.tree.map(jnp.asarray, tree), {"n": jnp.arange(3)})
    tstate = (ckpt_tree(tree), {"n": torch.arange(3, dtype=torch.int32)})
    JCheckpointManager(tmp_path / "jax").save(4, jstate, blocking=True)
    CheckpointManager(tmp_path / "torch").save(4, tstate, blocking=True)
    # the reference's checkpoint in the port, the port's in the reference
    got, meta = CheckpointManager(tmp_path / "jax").restore(tstate)
    _assert_same(got, tstate)
    assert meta["step"] == 4
    back, meta = JCheckpointManager(tmp_path / "torch").restore(jstate)
    for (path, x), (_, y) in zip(
            jax.tree_util.tree_flatten_with_path(back)[0],
            jax.tree_util.tree_flatten_with_path(jstate)[0]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
    assert meta["step"] == 4


def test_reference_bf16_leaf_restores_as_bf16(tmp_path):
    """The reference stores a bf16 leaf as ``ml_dtypes``' type, which numpy
    reads back as raw 2-byte voids: the port takes those bits as bf16."""
    x = jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16)
    JCheckpointManager(tmp_path).save(1, {"x": x}, blocking=True)
    got, _ = CheckpointManager(tmp_path).restore(
        {"x": torch.zeros(3, dtype=torch.bfloat16)})
    assert got["x"].dtype == torch.bfloat16
    assert got["x"].float().tolist() == np.asarray(x, np.float32).tolist()


def ckpt_tree(tree):
    return {k: ckpt_tree(v) if isinstance(v, dict) else torch.as_tensor(v)
            for k, v in tree.items()}


def test_meta_json_is_the_reference_layout(tmp_path):
    CheckpointManager(tmp_path).save(3, {"x": torch.ones(2)},
                                     meta={"pipeline": {"step": 3}},
                                     blocking=True)
    meta = json.loads((Path(tmp_path) / "step_00000003" / "meta.json")
                      .read_text())
    assert set(meta) == {"pipeline", "step", "time"}
