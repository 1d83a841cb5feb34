"""Which attention a decode step runs (``models/attention.py``).

A window-free decode over CUDA tensors takes the port's decode kernel
(``kernels/decode_attention.py``), the sharded step with its DTensors'
local shards; a CPU tensor and a rolling (sliding-window) cache keep
``chunked_attention``, called as before the kernel existed.  MLA's bf16
decode over plain CUDA tensors takes the MLA kernel
(``kernels/mla_decode.py``) with the layer's latent cache in place; CPU
tensors, f32, DTensors and prefills keep ``chunked_attention``.  The CPU
cannot launch either kernel, so the CUDA side of the routing is reached
by standing in for ``takes_decode_kernel``; the kernels themselves are
held against ``chunked_attention`` on the card
(``tests/test_torch_gpu.py``), and the sharded route on a 2x2 CPU mesh
(``tests/test_torch_distributed.py``).
"""
import types
from unittest import mock

import pytest
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get
from repro_torch.kernels import mla_decode as km
from repro_torch.kernels import ops
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
    monkeypatch.setattr(ops, "decode_attention", stand_in)
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


# ---------------------------------------------------------------------------
# MLA's decode: the latent cache in place, or chunked_attention
# ---------------------------------------------------------------------------


def _mla_layers(caches):
    """Each MLA layer's latent cache, in the order the layers run."""
    return [{leaf: c[leaf][i] for leaf in ("ckv", "kr")}
            for name in ("dense_stack", "moe_stack") if name in caches
            for c in (caches[name],) for i in range(c["ckv"].shape[0])]


def _mla_decode(monkeypatch, on_cuda, dtype="bfloat16"):
    """Reduced deepseek-v3-671b in ``dtype`` on the CPU, with
    ``takes_decode_kernel`` answering ``on_cuda`` and the MLA kernel stood
    in for by its plain version: a prefill and DECODE_STEPS decode steps.
    Returns the config, the prefill's calls of chunked_attention and the
    kernel, per step the decode's calls of chunked_attention (keyword
    arguments, k and v), of the kernel (its arguments), of
    ``takes_decode_kernel`` and of ``torch.cat`` (the data pointers of its
    inputs), the positions and the logits, and the caches."""
    cfg = get("deepseek-v3-671b").reduced().with_policy(
        compute_dtype=dtype, param_dtype=dtype)
    params = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, PROMPT_T),
                         generator=torch.Generator().manual_seed(1))
    chunked, kernel, asked, cats = [], [], [], []
    plain, cat = attention.chunked_attention, torch.cat
    standing_in = []

    def spy(q, k, v, **kw):
        if not standing_in:               # the stand-in's own call aside
            chunked.append((kw, k, v))
        return plain(q, k, v, **kw)

    def stand_in(qq, ckv, kr, pos):
        kernel.append((qq, ckv, kr, pos))
        standing_in.append(True)
        try:
            return km.plain(qq, ckv, kr, pos)
        finally:
            standing_in.pop()

    def rule(*t):
        asked.append(t)
        return on_cuda

    def cat_spy(tensors, *a, **kw):
        if not standing_in:
            cats.append([x.data_ptr() for x in tensors])
        return cat(tensors, *a, **kw)

    monkeypatch.setattr(attention, "chunked_attention", spy)
    monkeypatch.setattr(ops, "mla_decode", stand_in)
    monkeypatch.setattr(attention, "takes_decode_kernel", rule)
    lg, caches = lm.prefill(params, {"tokens": toks}, cfg, CACHE_LEN)
    prefill = (list(chunked), list(kernel))
    monkeypatch.setattr(torch, "cat", cat_spy)
    pos = torch.full((2,), PROMPT_T)
    steps = []
    for _ in range(DECODE_STEPS):
        del chunked[:], kernel[:], asked[:], cats[:]
        lg, caches = lm.decode_step(params, lg.argmax(-1)[:, None], pos,
                                    caches, cfg)
        steps.append((list(chunked), list(kernel), list(asked), list(cats),
                      pos, lg))
        pos = pos + 1
    monkeypatch.setattr(torch, "cat", cat)
    return cfg, prefill, steps, caches


def test_a_bf16_mla_cuda_decode_takes_the_mla_kernel(monkeypatch):
    """On plain CUDA tensors (stood in for here) a bf16 MLA decode hands
    the kernel qq, the layer's ckv and kr in place and the positions, once
    a layer, and calls neither chunked_attention nor ``torch.cat`` on the
    cache."""
    cfg, _, steps, caches = _mla_decode(monkeypatch, on_cuda=True)
    layers = _mla_layers(caches)
    m = cfg.mla
    for chunked, kernel, _, cats, pos, _ in steps:
        assert chunked == []
        assert len(kernel) == cfg.n_layers
        cache_ptrs = {t.data_ptr() for layer in layers for t in layer.values()}
        assert not any(p in cache_ptrs for ptrs in cats for p in ptrs)
        for layer, (qq, ckv, kr, qpos) in enumerate(kernel):
            assert qq.shape == (2, 1, cfg.n_heads,
                                m.kv_lora_rank + m.qk_rope_dim)
            assert qq.dtype == torch.bfloat16 and qq.is_contiguous()
            assert ckv.data_ptr() == layers[layer]["ckv"].data_ptr()
            assert kr.data_ptr() == layers[layer]["kr"].data_ptr()
            assert ckv.shape == (2, CACHE_LEN, m.kv_lora_rank)
            assert torch.equal(qpos, pos)


@pytest.mark.parametrize("on_cuda,dtype", [(False, "bfloat16"),
                                           (False, "float32"),
                                           (True, "float32")],
                         ids=["cpu", "cpu-f32", "cuda-f32"])
def test_other_mla_decodes_call_chunked_attention_as_before(
        monkeypatch, on_cuda, dtype):
    """CPU tensors (and DTensors, which ``takes_decode_kernel`` turns
    away), and an f32 decode even on the card, call chunked_attention
    once a layer as before the kernel existed: k the concatenated latent
    cache, v the layer's ckv in place, causal from the positions over the
    whole cache; the kernel never."""
    cfg, _, steps, caches = _mla_decode(monkeypatch, on_cuda, dtype)
    layers = _mla_layers(caches)
    for chunked, kernel, _, _, pos, _ in steps:
        assert kernel == []
        assert len(chunked) == cfg.n_layers
        n = int(pos.max()) + 1          # slots written by this step
        for layer, (kw, k, v) in enumerate(chunked):
            assert sorted(kw) == ["causal", "chunk", "q_offset"]
            assert kw["causal"] is True and kw["chunk"] == 1024
            assert torch.equal(kw["q_offset"], pos)
            ckv, kr = layers[layer]["ckv"], layers[layer]["kr"]
            assert v.data_ptr() == ckv.data_ptr()
            assert k.shape == (2, CACHE_LEN, 1, ckv.shape[-1] + kr.shape[-1])
            assert torch.equal(k[:, :n], torch.cat([ckv, kr], -1)[:, :n, None])


def test_the_mla_route_asks_the_rule_about_qq_and_the_layer_cache(
        monkeypatch):
    """A bf16 MLA decode asks ``takes_decode_kernel`` (which turns away
    CPU tensors and DTensors) about qq and the layer's ckv and kr, once a
    layer; a prefill never asks and never takes the kernel."""
    cfg, prefill, steps, caches = _mla_decode(monkeypatch, on_cuda=True)
    assert prefill[1] == [] and len(prefill[0]) == cfg.n_layers
    layers = _mla_layers(caches)
    for _, kernel, asked, _, _, _ in steps:
        assert len(asked) == cfg.n_layers
        for layer, (qq, ckv, kr) in enumerate(asked):
            assert qq.shape == kernel[layer][0].shape
            assert ckv.data_ptr() == layers[layer]["ckv"].data_ptr()
            assert kr.data_ptr() == layers[layer]["kr"].data_ptr()


def test_the_mla_kernel_path_changes_nothing_around_the_call(monkeypatch):
    """The routed MLA decode, with the kernel's plain version standing in
    for it, gives the CPU path's logits and latent caches bit for bit."""
    runs = []
    for on_cuda in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            cfg, _, steps, caches = _mla_decode(mp, on_cuda)
        runs.append(([s[-1] for s in steps], caches))
    (plain, pc), (routed, rc) = runs
    for a, b in zip(plain, routed):
        assert torch.equal(a, b)
    for name in pc:
        for leaf in ("ckv", "kr"):
            assert torch.equal(pc[name][leaf], rc[name][leaf])


def _mla_operands(b=2, clen=24, h=4, r=32, rd=16, dtype=torch.bfloat16):
    return (torch.zeros(b, 1, h, r + rd, dtype=dtype),
            torch.zeros(b, clen, r, dtype=dtype),
            torch.zeros(b, clen, rd, dtype=dtype),
            torch.tensor([3, 23][:b]))


@pytest.mark.parametrize("case,error,match", [
    ("qq f32", TypeError, "bfloat16"),
    ("cache f32", TypeError, "bfloat16"),
    ("widths", ValueError, "widths"),
    ("qq width", ValueError, r"\(B,1,H,r\+rd\)"),
    ("two queries", ValueError, r"\(B,1,H,r\+rd\)"),
    ("slots", ValueError, r"\(B,1,H,r\+rd\)"),
    ("pos dtype", ValueError, "int32/int64"),
    ("pos shape", ValueError, "int32/int64"),
    ("contiguity", ValueError, "contiguous"),
    ("alignment", ValueError, "16-byte"),
    ("cpu", ValueError, "CUDA"),
    ("out", ValueError, "out"),
])
def test_the_mla_wrapper_refuses_what_it_does_not_take(case, error, match):
    """Every refusal is reached before the device, so on CPU tensors: the
    wrong dtype, uncompiled widths, shapes, positions, strides, alignment,
    a CPU operand, and a wrong ``out``; no launch is counted."""
    qq, ckv, kr, pos = _mla_operands()
    kw = {}
    if case == "qq f32":
        qq = qq.float()
    elif case == "cache f32":
        ckv, kr = ckv.float(), kr.float()
    elif case == "widths":
        qq, ckv, kr, pos = _mla_operands(r=64, rd=16)
    elif case == "qq width":
        qq = qq[..., :-8].contiguous()
    elif case == "two queries":
        qq = qq.expand(2, 2, 4, 48)
    elif case == "slots":
        ckv, kr = ckv[:1], kr[:1]
    elif case == "pos dtype":
        pos = pos.float()
    elif case == "pos shape":
        pos = pos[:, None]
    elif case == "contiguity":
        ckv = ckv.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "alignment":
        flat = torch.zeros(qq.numel() + 1, dtype=qq.dtype)
        qq = flat[1:].view(qq.shape)
    elif case == "out":
        kw["out"] = torch.empty(2, 1, 4, 48, dtype=qq.dtype)
    before = km.launches
    if case == "out":
        # a CPU operand is refused before ``out`` is looked at, so the
        # operands' device check is stood in for by a CUDA-like view
        with mock.patch.object(torch.Tensor, "is_cuda", True):
            with pytest.raises(error, match=match):
                km.mla_decode(qq, ckv, kr, pos, **kw)
    else:
        with pytest.raises(error, match=match):
            km.mla_decode(qq, ckv, kr, pos, **kw)
    assert km.launches == before


def test_mla_splits_size_the_grid_from_the_shape_alone():
    """The grid: whole tiles a split, at least MIN_SPLIT keys, at most
    MAX_SPLITS splits, one split where the slots fill the card."""
    for b, blocks, clen in [(64, 2, 1312), (4, 1, 24), (1, 2, 8192),
                            (512, 2, 1312), (3, 1, 90)]:
        split_len, nsplit = km.splits(b, blocks, clen)
        assert split_len % km.KEYS == 0 and 1 <= nsplit <= km.MAX_SPLITS
        assert split_len * nsplit >= clen > split_len * (nsplit - 1)
        assert nsplit == 1 or split_len >= km.MIN_SPLIT
    assert km.splits(512, 2, 1312)[1] == 1
