"""Which attention a decode step runs (``models/attention.py``).

A window-free decode over CUDA tensors takes the port's decode kernel
(``kernels/decode_attention.py``), the sharded step with its DTensors'
local shards; a CPU tensor and a rolling (sliding-window) cache keep
``chunked_attention``, called as before the kernel existed.  The CPU
cannot launch the kernel, so the CUDA side of the routing is reached by
standing in for ``takes_decode_kernel``; the kernel itself is held
against ``chunked_attention`` on the card (``tests/test_torch_gpu.py``),
and the sharded route on a 2x2 CPU mesh
(``tests/test_torch_distributed.py``).
"""
import types
from unittest import mock

import pytest
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get
from repro_torch.models import attention
from repro_torch.models import model as lm

PROMPT_T, CACHE_LEN, DECODE_STEPS = 10, 24, 2


def test_takes_decode_kernel_only_for_plain_cuda_tensors():
    cuda = types.SimpleNamespace(is_cuda=True)
    sharded = mock.Mock(spec=DTensor, is_cuda=True)
    assert attention.takes_decode_kernel(cuda, cuda, cuda)
    assert not attention.takes_decode_kernel(torch.zeros(2), cuda, cuda)
    assert not attention.takes_decode_kernel(cuda, sharded, sharded)
    assert not attention.takes_decode_kernel(sharded)


def _layers(caches):
    """Each layer's slot cache, in the order the layers run."""
    return [{leaf: c[leaf][i] for leaf in ("k", "v", "pos")}
            for name in ("dense_stack", "moe_stack") if name in caches
            for c in (caches[name],) for i in range(c["pos"].shape[0])]


def _decode(name, monkeypatch, on_cuda):
    """Prefill and DECODE_STEPS decode steps of reduced ``name`` on the
    CPU, with ``takes_decode_kernel`` answering ``on_cuda``; returns the
    decode calls of chunked_attention (its keyword arguments, its output)
    and of the decode kernel (its arguments), the positions and the
    logits, per step, and the caches."""
    cfg = get(name).reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, PROMPT_T),
                         generator=torch.Generator().manual_seed(1))
    lg, caches = lm.prefill(params, {"tokens": toks}, cfg, CACHE_LEN)
    chunked, kernel = [], []
    plain = attention.chunked_attention

    def spy(q, k, v, **kw):
        out = plain(q, k, v, **kw)
        chunked.append((kw, out))
        return out

    def stand_in(q, k, v, kpos, pos):
        kernel.append((q, k, v, kpos, pos))
        return plain(q, k, v, causal=True, q_offset=pos, kv_positions=kpos)

    monkeypatch.setattr(attention, "chunked_attention", spy)
    monkeypatch.setattr(attention, "decode_attention", stand_in)
    monkeypatch.setattr(attention, "takes_decode_kernel",
                        lambda *t: on_cuda)
    pos = torch.full((2,), PROMPT_T)
    steps = []
    for _ in range(DECODE_STEPS):
        del chunked[:], kernel[:]
        lg, caches = lm.decode_step(params, lg.argmax(-1)[:, None], pos,
                                    caches, cfg)
        steps.append((list(chunked), list(kernel), pos, lg))
        pos = pos + 1
    return cfg, steps, caches


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mixtral-8x22b"])
def test_cpu_decode_calls_chunked_attention_as_before(name, monkeypatch):
    """On CPU tensors every layer's decode calls chunked_attention with the
    arguments it took before the kernel existed (the slot cache, its
    positions, kv_valid only for a sliding window), and the kernel never;
    the window-free and the rolling cache alike."""
    cfg, steps, caches = _decode(name, monkeypatch, on_cuda=False)
    layers = _layers(caches)
    for chunked, kernel, pos, _ in steps:
        assert kernel == []
        assert len(chunked) == cfg.n_layers
        for layer, (kw, _) in enumerate(chunked):
            assert kw["causal"] is True and kw["chunk"] == 1024
            assert kw["window"] == cfg.sliding_window
            assert torch.equal(kw["q_offset"], pos)
            kpos = layers[layer]["pos"]
            assert kw["kv_positions"].data_ptr() == kpos.data_ptr()
            if cfg.sliding_window:
                assert torch.equal(kw["kv_valid"], torch.clamp(
                    pos + 1, max=kpos.shape[-1]))
            else:
                assert kw["kv_valid"] is None


def test_a_window_free_cuda_decode_takes_the_kernel(monkeypatch):
    """Where the tensors are plain CUDA tensors (stood in for here), a
    window-free decode hands the kernel q, the layer's slot cache in place
    and the positions, once a layer, and calls no chunked_attention."""
    cfg, steps, caches = _decode("qwen3-1.7b", monkeypatch, on_cuda=True)
    layers = _layers(caches)
    for chunked, kernel, pos, _ in steps:
        assert chunked == []
        assert len(kernel) == cfg.n_layers
        for layer, (q, k, v, kpos, qpos) in enumerate(kernel):
            assert q.shape == (2, 1, cfg.n_heads, cfg.head_dim_)
            for got, leaf in ((k, "k"), (v, "v"), (kpos, "pos")):
                assert got.data_ptr() == layers[layer][leaf].data_ptr()
            assert torch.equal(qpos, pos)


def test_a_rolling_cache_keeps_chunked_attention_on_cuda(monkeypatch):
    """mixtral's sliding window rolls its cache: even on CUDA tensors
    (stood in for here) its decode keeps chunked_attention."""
    cfg, steps, _ = _decode("mixtral-8x22b", monkeypatch, on_cuda=True)
    assert cfg.sliding_window > 0
    for chunked, kernel, _, _ in steps:
        assert kernel == [] and len(chunked) == cfg.n_layers


def test_the_kernel_path_changes_nothing_around_the_call():
    """The routed decode, with chunked_attention standing in for the
    kernel, gives the CPU path's logits and caches bit for bit: the branch
    changes nothing around the attention call."""
    runs = []
    for on_cuda in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            runs.append(_decode("qwen3-1.7b", mp, on_cuda)[1:])
    (plain, pc), (routed, rc) = runs
    for a, b in zip(plain, routed):
        assert torch.equal(a[3], b[3])
    for leaf in ("k", "v", "pos"):
        assert torch.equal(pc["dense_stack"][leaf], rc["dense_stack"][leaf])
