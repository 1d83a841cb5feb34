"""The plain reference against itself (its blocked form against the
direct one) and against the port at a tiny size in float32, where the two
must agree to rounding; and the weights the benchmark makes give decode
tokens that follow the context."""
import json

import pytest
import torch

from portbench import check, port, weights
from portbench.reference import plain
from portbench.tests.conftest import PKG, tiny_cfg


def test_blocked_attention_matches_the_direct_softmax():
    g = torch.Generator().manual_seed(1)
    t, h, hkv, d = 37, 4, 2, 8
    q = torch.randn(t, h, d, generator=g)
    k = torch.randn(t, hkv, d, generator=g)
    v = torch.randn(t, hkv, d, generator=g)
    kk, vv = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
    s = torch.einsum("qhd,khd->hqk", q, kk) / d ** 0.5
    s = s.masked_fill(~torch.tril(torch.ones(t, t, dtype=torch.bool)),
                      float("-inf"))
    want = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), vv)
    for block in (5, 512):
        got = plain.causal_attention(q, k, v, block=block)
        assert torch.allclose(got, want, atol=1e-5)


def test_fp8_control_rounds_each_product():
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn(8, 64, generator=g), torch.randn(64, 16, generator=g)
    exact, low = plain.linear(x, w, "f32"), plain.linear(x, w, "fp8")
    rel = ((low - exact).norm() / exact.norm()).item()
    assert 1e-3 < rel < 0.2
    with pytest.raises(ValueError):
        plain.linear(x, w, "int4")


def test_reference_agrees_with_the_port_in_float32():
    from repro_torch.models import model as lm
    cfg = dict(tiny_cfg(), compute_dtype="float32")
    a = port.arch(cfg)
    w = weights.make(port.meta_params(a), 3, "cpu")
    ref = check.reference(cfg)
    toks = torch.randint(0, cfg["vocab_size"], (1, 21),
                         generator=torch.Generator().manual_seed(4))
    # the whole prompt through the reference, rows 14.. at once
    full = ref.forward(w, cfg, toks[0], slice(14, None), "f32")
    assert full.shape == (7, cfg["vocab_size"])
    # the port: a prefill of 15 tokens, then decode steps through the cache
    params = lm.compute_params(w, a)
    logits, caches = lm.prefill(params, {"tokens": toks[:, :15]}, a,
                                cache_len=32, backend="torch")
    got = [logits[0]]
    for i in range(15, 21):
        logits, caches = lm.decode_step(params, toks[:, i:i + 1],
                                        torch.tensor([i]), caches, a,
                                        backend="torch")
        got.append(logits[0])
    got = torch.stack(got)[:, :cfg["vocab_size"]]
    assert torch.allclose(got, full, atol=2e-4, rtol=2e-4), \
        (got - full).abs().max()
    # and the reference agrees with itself over other rows
    assert torch.allclose(ref.forward(w, cfg, toks[0], slice(18, 20), "f32"),
                          full[4:6], atol=1e-5)


def test_stacked_norm_scales_are_drawn_near_one():
    cfg = tiny_cfg()
    w = weights.make(port.meta_params(port.arch(cfg)), 7, "cpu")
    st = w["stack"]["dense_stack"]
    for leaf in (st["ln1"]["scale"], st["ln2"]["scale"],
                 st["attn"]["qnorm"]["scale"], w["final_norm"]["scale"]):
        assert abs(leaf.float().mean().item() - 1.0) < 0.05
        assert leaf.float().std().item() < 0.2


def test_decode_tokens_follow_the_context():
    """At the configuration's depth and vocabulary (narrow widths), the
    reference's greedy answer is not one token repeated, and most of its
    tokens change when the answer's earlier tokens are dropped from the
    context, as a decode step that kept no cache would see it."""
    cfg = json.loads((PKG / "configs" / "qwen3-1.7b.json").read_text())
    cfg.update(d_model=256, n_heads=4, head_dim=64, n_kv_heads=1, d_ff=768)
    w = weights.make(port.meta_params(port.arch(cfg)), 5, "cpu")
    ref = check.reference(cfg)
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg["vocab_size"], (64,), generator=g)
    seq, answer = prompt, []
    for _ in range(16):
        nxt = ref.forward(w, cfg, seq, slice(-1, None)).argmax(-1)
        answer.append(int(nxt))
        seq = torch.cat([seq, nxt])
    assert len(set(answer)) >= 8
    changed = sum(
        int(ref.forward(w, cfg, torch.cat([prompt, torch.tensor([prev])]),
                        slice(-1, None)).argmax()) != nxt
        for prev, nxt in zip(answer, answer[1:]))
    assert changed >= 0.5 * (len(answer) - 1)
