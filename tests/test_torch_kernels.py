"""The port's K1 (ame_gemm) plain path against the JAX reference on the CPU.

Same shape x dtype sweep and tolerances as tests/test_kernels.py: the
port's ``ref.gemm`` and ``ops.gemm(use_kernel=True)`` on CPU tensors are
held against JAX's ``ref.gemm`` and the Pallas ``ame_gemm`` in interpret
mode.  The CUDA kernel itself runs only on the card
(tests/test_torch_gpu.py).
"""
import ctypes
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ame_gemm import ame_gemm as jame_gemm
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import ame_gemm as k1
from repro_torch.launch import hw

RNG = np.random.default_rng(42)

#: the reference's tolerances (tests/test_kernels.py:20-22): f32 sums in
#: another order; bf16 outputs round to 8 bits of mantissa
TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=0.06, rtol=0.06),
       "float16": dict(atol=0.02, rtol=0.02)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}


def pair(shape, dtype, scale=0.3):
    """The same seeded values as a JAX array and a torch CPU tensor."""
    x = (RNG.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(x, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [
    (32, 32, 32), (128, 64, 128), (100, 130, 70), (1, 256, 64),
    (257, 33, 129), (8, 8, 8),
])
def test_gemm_matches_jax(m, k, n, dtype):
    (ja, ta), (jb, tb) = pair((m, k), dtype), pair((k, n), dtype)
    want_ref = jref.gemm(ja, jb)
    want_pallas = jame_gemm(ja, jb, block_m=32, block_n=32, block_k=32,
                            interpret=True)
    for got in (ref.gemm(ta, tb), ops.gemm(ta, tb, use_kernel=True),
                ops.gemm(ta, tb, use_kernel=False)):
        assert got.dtype == TDT[dtype] and got.shape == (m, n)
        close(got, want_ref, dtype)
        close(got, want_pallas, dtype)


@pytest.mark.parametrize("out", ["float32", "bfloat16", "float16"])
def test_gemm_out_dtype(out):
    (ja, ta), (jb, tb) = pair((64, 64), "bfloat16"), pair((64, 64),
                                                         "bfloat16")
    got = ops.gemm(ta, tb, use_kernel=True, out_dtype=TDT[out])
    want = jame_gemm(ja, jb, block_m=32, block_n=32, block_k=32,
                     out_dtype=JDT[out], interpret=True)
    assert got.dtype == TDT[out]
    assert str(want.dtype) == out
    close(got, want, out)


def test_smem_claim_fits_a_block():
    # the TPU defaults (128, 128, 512) double-buffered would not fit
    assert k1.smem_bytes(128, 128, 512) * 2 > hw.SMEM_PER_BLOCK
    for dtype_bytes in (2, 4):          # the fma kernel's static tiles
        assert k1.smem_bytes(dtype_bytes=dtype_bytes) < hw.SMEM_PER_BLOCK
        for bm, bn, bk in k1.BLOCKS:
            assert k1.smem_bytes(bm, bn, bk, dtype_bytes) <= 48 * 1024
    for blocks in k1.MMA_BLOCKS:        # the mma kernel's dynamic ring
        assert k1.MMA_CONFIG[blocks][0] >= 3        # a ring of 3+ stages
        assert k1.smem_bytes(*blocks, kind="mma") <= hw.SMEM_PER_BLOCK
    assert (k1.DEFAULT_BM, k1.DEFAULT_BN, k1.DEFAULT_BK) in k1.BLOCKS


#: (m, k, n) of every K1 call on the serving paths: qwen3-1.7b's seven
#: projections and mamba2-370m's two, at one token, a decode step of 4
#: slots, a 64-token prompt and mamba's 300-token prompt
SERVE_SHAPES = [(m, k, n) for m in (1, 4, 64, 300)
                for k, n in ((2048, 2048), (2048, 1024), (2048, 6144),
                             (6144, 2048), (1024, 4384))]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("m,k,n", SERVE_SHAPES)
def test_serving_shapes_take_the_mma_kernel(m, k, n, dtype):
    a = torch.zeros(m, k, dtype=TDT[dtype])
    b = torch.zeros(k, n, dtype=TDT[dtype])
    assert k1.variant(a, b) == "mma"
    blocks = k1.default_blocks(m, n)
    assert blocks in k1.MMA_BLOCKS
    assert k1.smem_bytes(*blocks, kind="mma") <= hw.SMEM_PER_BLOCK
    tiles = -(-m // blocks[0]) * -(-n // blocks[1])
    narrowest = min(bn for bm, bn, _ in k1.MMA_BLOCKS if bm == blocks[0])
    assert tiles >= k1.MIN_TILES or blocks[1] == narrowest


def test_f32_and_unaligned_operands_take_the_general_kernel():
    bf = torch.bfloat16
    cases = [(torch.zeros(4, 64), torch.zeros(64, 32)),             # f32
             (torch.zeros(100, 130, dtype=bf), torch.zeros(130, 70, dtype=bf)),
             (torch.zeros(257, 33, dtype=bf), torch.zeros(33, 129, dtype=bf)),
             (torch.zeros(64 * 128 + 1, dtype=bf)[1:].view(64, 128),
              torch.zeros(128, 256, dtype=bf))]                    # misaligned
    for a, b in cases:
        assert k1.variant(a, b) == "fma"
        assert k1.default_blocks(a.shape[0], b.shape[1], "fma") in k1.BLOCKS


def test_wrapper_refuses_before_it_loads(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a refused call loaded kernel {name!r}")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    a, b = torch.zeros(4, 64, dtype=torch.bfloat16), \
        torch.zeros(64, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\(m,k\) @ \(k,n\)"):
        k1.ame_gemm(a, b.t())
    with pytest.raises(TypeError):
        k1.ame_gemm(a, b.half())
    with pytest.raises(ValueError, match="contiguous"):
        k1.ame_gemm(a, b.t().contiguous().t())
    with pytest.raises(ValueError, match="compiled in for the mma"):
        k1.ame_gemm(a, b, block_m=64, block_n=64, block_k=32)
    with pytest.raises(ValueError, match="compiled in for the mma"):
        k1.ame_gemm(a, b, block_m=16)
    with pytest.raises(ValueError, match="compiled in for the fma"):
        k1.ame_gemm(a.float(), b.float(), block_m=16, block_n=8, block_k=256)
    with pytest.raises(ValueError, match="CUDA"):
        k1.ame_gemm(a, b)


def test_cpu_tensor_never_touches_the_kernel_loader(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name!r}")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    a, b = torch.randn(5, 7), torch.randn(7, 3)
    before = k1.launches
    out = ops.gemm(a, b, use_kernel=True)
    torch.testing.assert_close(out, ref.gemm(a, b))
    assert k1.launches == before


def test_kernel_wrapper_refuses_cpu_tensors(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("loaded"))
    with pytest.raises(ValueError, match="CUDA"):
        k1.ame_gemm(torch.randn(4, 4), torch.randn(4, 4))


def test_entry_binds_once_per_library_and_symbol(monkeypatch):
    """``_build.entry`` binds each (library, symbol) once, with its
    argtypes and a ``c_int`` result, on the library ``load`` gives;
    ``_build.launch_error`` is the wrappers' error for a failed launch."""
    libs, loaded = {}, []

    def load(name):
        loaded.append(name)
        return libs.setdefault(name, types.SimpleNamespace(
            f=types.SimpleNamespace(), g=types.SimpleNamespace()))
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_ENTRIES", {})
    argtypes = [ctypes.c_void_p, ctypes.c_int]
    f = _build.entry("fake", "f", argtypes)
    assert f is libs["fake"].f
    assert f.argtypes == argtypes and f.restype is ctypes.c_int
    assert _build.entry("fake", "f", argtypes) is f
    assert _build.entry("fake", "g", [ctypes.c_int]) is libs["fake"].g
    assert _build.entry("other", "f", argtypes) is libs["other"].f
    assert _build.entry("fake", "g", [ctypes.c_int]) is libs["fake"].g
    assert loaded == ["fake", "fake", "other"]
    err = _build.launch_error(700, "ame_gemm mma", "(m,k,n)=(1, 2, 3)")
    assert isinstance(err, RuntimeError)
    assert str(err) == ("ame_gemm mma launch failed: cudaError 700 at "
                        "(m,k,n)=(1, 2, 3)")


def test_build_lists_the_kernel_sources():
    assert "ame_gemm" in _build.sources()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
