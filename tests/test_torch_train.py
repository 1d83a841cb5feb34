"""The port's training loop against the JAX reference on the CPU.

The reference's own tiny setup (tests/test_substrate.py:_tiny_setup: a
2-layer, 64-wide qwen3, AdamW, ``SyntheticLM``) runs 6 steps in both
packages from the same parameters, and each step's logged loss agrees
within the reference's resume tolerance.  Then the port alone: resume
from a checkpoint matches an uninterrupted run, SIGTERM preempts with a
final checkpoint, and ``python -m repro_torch.train --device cpu``
reaches its loop.
"""
import json
import os
import signal
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import convert
from repro_torch.optim import adamw
from repro_torch.train import __main__ as train_main
from repro_torch.train.loop import LoopConfig, TrainLoop, make_step, trainable
from test_substrate import TrainLoop as JTrainLoop
from test_substrate import _tiny_setup

#: the reference's own bound between two runs of its loop
#: (tests/test_substrate.py::test_train_loop_resume_matches_uninterrupted)
REL = 1e-4


def tiny(tmp_path, total_steps=6, ckpt_every=2):
    """The port's twin of the reference's ``_tiny_setup``: the same config,
    parameters (the reference's, carried over), optimizer and data; plus
    the reference's setup itself."""
    ref = _tiny_setup(tmp_path / "ref", total_steps, ckpt_every)
    jcfg, jparams = ref[0], ref[1]
    cfg = get("qwen3-1.7b").reduced().replace(n_layers=2, d_model=64,
                                              d_ff=128, vocab_size=128)
    assert cfg.d_model == jcfg.d_model and cfg.vocab_size == jcfg.vocab_size
    params = trainable(convert.params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    oc = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=100)
    pipe = SyntheticLM(cfg, SHAPES["train_4k"], seed=1, batch_override=4,
                       seq_override=16)
    lc = LoopConfig(total_steps=total_steps, ckpt_every=ckpt_every,
                    log_every=1, out_dir=str(tmp_path / "run"))
    return (cfg, params, adamw.init(params, oc), pipe,
            make_step(cfg, oc, "cpu"), lc), ref


def _lines(out_dir):
    return [json.loads(line) for line in
            (Path(out_dir) / "metrics.jsonl").read_text().splitlines()]


def test_six_steps_match_the_reference(tmp_path):
    (cfg, params, opt, pipe, step_fn, lc), ref = tiny(tmp_path)
    out = TrainLoop(lc, step_fn, params, opt, pipe).run()
    jout = JTrainLoop(ref[5], ref[4], ref[1], ref[2], ref[3]).run()
    assert out["status"] == jout["status"] == "done"
    assert out["step"] == 6
    mine, theirs = _lines(lc.out_dir), _lines(ref[5].out_dir)
    assert [r["step"] for r in mine] == [r["step"] for r in theirs] \
        == list(range(1, 7))
    assert set(mine[0]) == set(theirs[0])          # the reference's keys
    for a, b in zip(mine, theirs):
        for k in ("loss", "ce", "tokens", "lr", "grad_norm"):
            assert a[k] == pytest.approx(b[k], rel=REL), (a["step"], k)


def test_train_loop_runs_and_checkpoints(tmp_path):
    (cfg, params, opt, pipe, step_fn, lc), _ = tiny(tmp_path)
    loop = TrainLoop(lc, step_fn, params, opt, pipe)
    out = loop.run()
    assert out["status"] == "done" and out["step"] == 6
    assert np.isfinite(out["loss"])
    assert loop.ckpt.latest_step() == 6
    assert sorted(loop.ckpt.steps()) == [2, 4, 6]
    assert _lines(lc.out_dir)[-1]["step"] == 6


def test_resume_matches_uninterrupted(tmp_path):
    (cfg, params, opt, pipe, step_fn, lc), _ = tiny(tmp_path / "a",
                                                    total_steps=6,
                                                    ckpt_every=3)
    loop_a = TrainLoop(lc, step_fn, params, opt, pipe)
    out_a = loop_a.run()
    (cfg, params, opt, pipe, step_fn, lc), _ = tiny(tmp_path / "b",
                                                    total_steps=3,
                                                    ckpt_every=3)
    TrainLoop(lc, step_fn, params, opt, pipe).run()
    # a new process would start from fresh parameters: restore overwrites
    fresh = adamw.tree_map(lambda p: torch.zeros_like(p).requires_grad_(),
                           params)
    lc2 = LoopConfig(total_steps=6, ckpt_every=3, log_every=1,
                     out_dir=lc.out_dir)
    loop_b = TrainLoop(lc2, step_fn, fresh, adamw.init(fresh, adamw
                                                       .AdamWConfig()), pipe)
    out_b = loop_b.run()
    assert out_b["step"] == 6 and _lines(lc.out_dir)[-1]["resumed"]
    assert out_a["loss"] == pytest.approx(out_b["loss"], rel=REL)
    for (path, x), (_, y) in zip(convert.leaves(loop_a.params),
                                 convert.leaves(loop_b.params)):
        assert torch.equal(x, y), path
    assert int(loop_b.opt_state["step"]) == 6


def test_preemption_checkpoints_and_restores_handlers(tmp_path):
    (cfg, params, opt, pipe, step_fn, lc), _ = tiny(tmp_path, total_steps=50,
                                                    ckpt_every=50)
    loop = TrainLoop(lc, step_fn, params, opt, pipe)
    calls = {"n": 0}

    def counting(p, s, b):
        calls["n"] += 1
        if calls["n"] == 3:
            os.kill(os.getpid(), signal.SIGTERM)   # preempt mid-run
        return step_fn(p, s, b)
    loop.step_fn = counting
    before = signal.getsignal(signal.SIGTERM)
    out = loop.run()
    assert out["status"] == "preempted"
    assert loop.ckpt.latest_step() == out["step"] >= 3
    assert signal.getsignal(signal.SIGTERM) is before


def test_cli_reaches_its_loop_on_the_cpu(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.train --device cpu`` at a few steps: the
    53M-parameter model trains, logs and checkpoints; 3 steps cannot drop
    the CE by the 0.5 nats the full 300-step run must, so the run ends on
    that check."""
    out = tmp_path / "run"
    with pytest.raises(SystemExit, match="did not improve"):
        train_main.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--out", str(out)])
    text = capsys.readouterr().out
    assert "arch=qwen3-1.7b(reduced) params=53." in text
    assert '"status": "done", "step": 3' in text and "ce: " in text
    lines = _lines(out)
    assert [r["step"] for r in lines] == [3] and np.isfinite(lines[0]["ce"])
    assert sorted(p.name for p in (out / "ckpt").iterdir()) \
        == ["step_00000003"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main.main(["--steps", "1", "--out", str(tmp_path / "x")])
