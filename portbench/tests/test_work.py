"""The yardstick's counts against hand-worked shapes and against the
parameter trees the benchmark makes."""
import json

import pytest
import torch

from portbench import hw, port, work
from portbench.bench import PKG


def _cfg(name):
    return json.loads((PKG / "configs" / f"{name}.json").read_text())


def test_k1_bound_of_a_decode_projection_is_its_bytes():
    m, k, n = 4, 2048, 2048
    nbytes = (m * k + k * n) * 2 + m * n * 2
    assert work.k1_bound_s(m, k, n, 2, 2) == pytest.approx(
        nbytes / hw.HBM_BW)


def test_k1_bound_of_a_prefill_projection_is_its_flops():
    m, k, n = 4096, 2048, 6144
    assert work.k1_bound_s(m, k, n, 2, 2) == pytest.approx(
        2 * m * k * n / hw.PEAK_FLOPS_BF16)
    # float32 operands are held to the CUDA cores' peak
    assert work.k1_bound_s(m, k, n, 4, 4) == pytest.approx(
        2 * m * k * n / hw.PEAK_FLOPS_F32)


def test_k4_bound_at_zamba2s_prefill():
    # one zamba2 layer's scan over 1024 tokens: x f32 (80 heads, P 64),
    # b and c bf16 of one group expanded over the heads, N 64
    bh, t, p, n = 80, 1024, 64, 64
    nbytes = bh * t * (2 * p * 4 + 4) + 1 * t * 2 * n * 2
    ops = 0.0
    for _ in range(8):                              # chunks of 128
        ops += bh * min(5 * 128 * n * p / hw.PEAK_FLOPS_F32,
                        (128 * 129 * n + 3 * (128 * 129 * p
                                              + 4 * 128 * n * p))
                        / hw.PEAK_FLOPS_BF16)
    assert work.k4_bound_s(bh, t, p, n, 128, 4, 2, 1) == pytest.approx(
        max(nbytes / hw.HBM_BW, ops))


def test_weight_bytes_are_the_tree_the_benchmark_makes():
    cfg = _cfg("qwen3-1.7b")
    meta = port.meta_params(port.arch(cfg))
    z = work.sizes(cfg)

    def nbytes(tree, path=()):
        out = 0
        for k, v in tree.items():
            if isinstance(v, dict):
                out += nbytes(v, path + (k,))
            elif k == "table":     # the real rows, not the padding
                out += cfg["vocab_size"] * v.shape[1] * v.element_size()
            elif path[-1:] == ("head",):
                out += v.shape[0] * cfg["vocab_size"] * v.element_size()
            else:
                out += v.numel() * v.element_size()
        return out
    assert z["weight_bytes"] + z["embed_bytes"] == nbytes(meta)


def test_qwen3_counts_by_hand():
    cfg = _cfg("qwen3-1.7b")
    z = work.sizes(cfg)
    layer = 2048 * 2048 + 2 * 2048 * 1024 + 2048 * 2048 + 3 * 2048 * 6144
    assert z["per_token"] == 28 * layer == 1_409_286_144
    t = 1000
    flops, nbytes = work.prefill_work(cfg, t)
    assert flops == pytest.approx(2 * 28 * layer * t + 2 * 2048 * 151936
                                  + 28 * 16 * 2 * 128 * t * (t + 1))
    kv = 2 * 8 * 128 * 2
    assert nbytes == z["weight_bytes"] + z["embed_bytes"] + 28 * t * kv
    flops, nbytes = work.decode_work(cfg, [10, 20])
    assert flops == pytest.approx(2 * (28 * layer + 2048 * 151936) * 2
                                  + 28 * 16 * 4 * 128 * (30 + 2))
    assert nbytes == z["weight_bytes"] + z["embed_bytes"] + 28 * kv * 32


def test_a_family_without_counts_is_refused():
    with pytest.raises(ValueError, match="no work count"):
        work.sizes(dict(_cfg("qwen3-1.7b"), family="moe"))


def test_bound_says_which_side_sets_it():
    assert work.bound_s(1e12, 1.0)[1] == "flops"
    assert work.bound_s(1.0, 1e12)[1] == "bytes"
    assert torch.tensor(work.bound_s(989e12, 0.0)[0]).item() \
        == pytest.approx(1.0)
