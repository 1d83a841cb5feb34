"""The port's K1 (ame_gemm) plain path against the JAX reference on the CPU.

Same shape x dtype sweep and tolerances as tests/test_kernels.py: the
port's ``ref.gemm`` and ``ops.gemm(use_kernel=True)`` on CPU tensors are
held against JAX's ``ref.gemm`` and the Pallas ``ame_gemm`` in interpret
mode.  The CUDA kernel itself runs only on the card
(tests/test_torch_gpu.py).
"""
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
    for dtype_bytes in (2, 4):
        assert k1.smem_bytes(dtype_bytes=dtype_bytes) < hw.SMEM_PER_BLOCK
        for bm, bn, bk in k1.BLOCKS:
            assert k1.smem_bytes(bm, bn, bk, dtype_bytes) <= 48 * 1024
    assert (k1.DEFAULT_BM, k1.DEFAULT_BN, k1.DEFAULT_BK) in k1.BLOCKS


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


def test_build_lists_the_kernel_sources():
    assert "ame_gemm" in _build.sources()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
