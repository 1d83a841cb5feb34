"""The port's ``ops`` entry point for K2 (ame_elementwise) and K3
(flash_attention) against the JAX reference on the CPU.

The same seeded numpy values go through ``repro.kernels.ref``, the Pallas
kernels in interpret mode, and the port's ``ref`` and ``ops`` (which take
the plain versions for CPU tensors).  Elementwise results must be equal
bit for bit; attention is held to the reference's tolerances
(tests/test_kernels.py:20-22).  The wrappers' refusals are checked here
too: they validate shapes, dtypes and blocks before they look at the
device, so a CPU tensor reaches every refusal.  The CUDA kernels
themselves run only on the card (tests/test_torch_gpu.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.attention import flash_attention as jflash
from repro.kernels.elementwise import ame_elementwise as jelementwise
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import attention as k3
from repro_torch.kernels import elementwise as k2
from repro_torch.launch import hw

RNG = np.random.default_rng(42)

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=0.06, rtol=0.06)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}


def pair(shape, dtype, scale=1.0):
    """The same seeded values as a JAX array and a torch CPU tensor."""
    x = (RNG.standard_normal(shape) * scale).astype(np.float32)
    j = jnp.asarray(x, JDT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])
    return j, t


def assert_equal_values(got: torch.Tensor, want, dtype):
    assert got.dtype == TDT[dtype]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def close(got: torch.Tensor, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.fixture
def no_kernel(monkeypatch):
    """Fail if anything tries to build or load a CUDA kernel."""
    def refuse(name):
        raise AssertionError(f"CPU path tried to load kernel {name!r}")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


# ---------------------------------------------------------------------------
# elementwise (tests/test_kernels.py:70-86): exact equality
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["add", "sub", "mul"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m,c", [(128, 2048), (57, 129), (1, 8)])
def test_elementwise_matches_jax(kind, dtype, m, c, no_kernel):
    (ja, ta), (jb, tb) = pair((m, c), dtype), pair((m, c), dtype)
    want_ref = jref.elementwise(kind, ja, jb)
    want_pallas = jelementwise(ja, jb, kind=kind, block_m=64, block_c=128,
                               interpret=True)
    for got in (ref.elementwise(kind, ta, tb),
                ops.elementwise(kind, ta, tb, use_kernel=True),
                ops.elementwise(kind, ta, tb, use_kernel=False)):
        assert got.shape == (m, c)
        assert_equal_values(got, want_ref, dtype)
        assert_equal_values(got, want_pallas, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["add", "sub", "mul"])
def test_elementwise_fused_relu(kind, dtype, no_kernel):
    (ja, ta), (jb, tb) = pair((64, 64), dtype), pair((64, 64), dtype)
    got = ops.elementwise(kind, ta, tb, relu=True, use_kernel=True)
    assert_equal_values(got, jref.elementwise(kind, ja, jb, relu=True),
                        dtype)
    assert_equal_values(got, jelementwise(ja, jb, kind=kind, relu=True,
                                          block_m=32, block_c=32,
                                          interpret=True), dtype)
    assert float(got.min()) >= 0.0


def test_elementwise_relu_propagates_nan_and_clears_the_sign_of_zero():
    a = torch.tensor([[float("nan"), -1.0, 2.0, -0.0]])
    b = torch.tensor([[1.0, 1.0, 1.0, -1.0]])
    for dtype in ("float32", "bfloat16", "float16"):
        ta, tb = a.to(TDT[dtype]), b.to(TDT[dtype])
        got = ref.elementwise("mul", ta, tb, relu=True)
        want = np.asarray(jref.elementwise(
            "mul", jnp.asarray(a.numpy(), JDT[dtype]),
            jnp.asarray(b.numpy(), JDT[dtype]), relu=True).astype(jnp.float32))
        assert torch.isnan(got[0, 0]) and np.isnan(want[0, 0])
        np.testing.assert_array_equal(got[0, 1:].float().numpy(),
                                      want[0, 1:])
        # (-0) * (-1) = +0 and relu(-0 * 1) = +0, bit for bit as in JAX
        assert not torch.signbit(got[0, 1:].float()).any()
        assert not np.signbit(want[0, 1:]).any()


def test_elementwise_rejects_an_unknown_kind():
    a = torch.ones(2, 2)
    with pytest.raises(ValueError):
        ref.elementwise("max", a, a)
    with pytest.raises(ValueError, match="kind"):
        k2.ame_elementwise(a, a, kind="max")


def test_elementwise_wrapper_refuses_before_it_loads(no_kernel):
    a = torch.randn(4, 6)
    with pytest.raises(ValueError, match="CUDA"):
        k2.ame_elementwise(a, a.clone())
    with pytest.raises(ValueError, match="shape"):
        k2.ame_elementwise(a, a[:, :5].contiguous())
    with pytest.raises(ValueError, match="shape"):
        k2.ame_elementwise(a.reshape(-1), a.reshape(-1))
    with pytest.raises(TypeError):
        k2.ame_elementwise(a, a.half())
    with pytest.raises(TypeError):
        k2.ame_elementwise(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        k2.ame_elementwise(a.t(), a.t())


# ---------------------------------------------------------------------------
# attention (tests/test_kernels.py:124-154): the reference's tolerances
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,tq,tk,d,causal,window", [
    (2, 64, 64, 32, True, 0),
    (1, 128, 128, 64, True, 0),
    (1, 100, 100, 32, True, 0),       # ragged seq vs block
    (2, 64, 64, 32, False, 0),
    (1, 128, 128, 32, True, 48),      # sliding window
    (1, 16, 128, 32, True, 0),        # chunked decode: q tail-aligned
])
def test_attention_matches_jax(bh, tq, tk, d, causal, window, dtype,
                               no_kernel):
    jq, tq_ = pair((bh, tq, d), dtype, 0.5)
    jk, tk_ = pair((bh, tk, d), dtype, 0.5)
    jv, tv_ = pair((bh, tk, d), dtype, 0.5)
    want_ref = jax.vmap(lambda q_, k_, v_: jref.attention(
        q_, k_, v_, causal=causal, window=window))(jq, jk, jv)
    want_pallas = jflash(jq, jk, jv, causal=causal, window=window,
                         block_q=32, block_k=32, interpret=True)
    for got in (ref.attention(tq_, tk_, tv_, causal=causal, window=window),
                ops.attention(tq_, tk_, tv_, causal=causal, window=window,
                              use_kernel=True, block_q=32, block_k=32),
                ops.attention(tq_, tk_, tv_, causal=causal, window=window)):
        assert got.dtype == TDT[dtype] and got.shape == (bh, tq, d)
        close(got, want_ref, dtype)
        close(got, want_pallas, dtype)


def test_attention_block_sweep(no_kernel):
    jq, q = pair((1, 96, 32), "float32", 0.5)
    jk, k = pair((1, 96, 32), "float32", 0.5)
    jv, v = pair((1, 96, 32), "float32", 0.5)
    want = jax.vmap(jref.attention)(jq, jk, jv)
    close(ref.attention(q, k, v), want, "float32")
    for (bq, bk), (pbq, pbk) in zip(k3.BLOCKS, [(16, 16), (32, 96), (96, 32),
                                                (32, 32)]):
        got = ops.attention(q, k, v, use_kernel=True, block_q=bq, block_k=bk)
        close(got, want, "float32")
        close(got, jflash(jq, jk, jv, block_q=pbq, block_k=pbk,
                          interpret=True), "float32")


def test_attention_takes_leading_dims_and_slices_them(monkeypatch):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 10, 16, generator=g)
    k = torch.randn(2, 3, 14, 16, generator=g)
    v = torch.randn(2, 3, 14, 16, generator=g)
    whole = ref.attention(q, k, v, window=5)
    per_head = torch.stack([torch.stack([
        ref.attention(q[b, h], k[b, h], v[b, h], window=5)
        for h in range(3)]) for b in range(2)])
    torch.testing.assert_close(whole, per_head, atol=0, rtol=0)
    monkeypatch.setattr(ref, "SCORES_PER_SLICE", 2 * 10 * 14)   # 2 rows
    torch.testing.assert_close(ref.attention(q, k, v, window=5), whole,
                               atol=0, rtol=0)


def test_causal_tq_over_tk_plain_is_nan_and_kernel_refuses(no_kernel):
    """A divergence by design: with causal and Tq > Tk the first Tq - Tk
    rows see no key; the plain version gives NaN there, as the reference's
    ``ref.attention`` does, and the kernel wrapper refuses the call."""
    q, k = torch.randn(1, 6, 8), torch.randn(1, 4, 8)
    got = ops.attention(q, k, k, causal=True, use_kernel=True)
    assert torch.isnan(got[0, :2]).all() and torch.isfinite(got[0, 2:]).all()
    want = jax.vmap(jref.attention)(*(jnp.asarray(x.numpy())
                                      for x in (q, k, k)))
    assert np.isnan(np.asarray(want)[0, :2]).all()
    with pytest.raises(ValueError, match="see no key"):
        k3.flash_attention(q, k, k, causal=True)
    # without the causal mask every row sees every key: accepted
    with pytest.raises(ValueError, match="CUDA"):
        k3.flash_attention(q, k, k, causal=False)


def test_attention_wrapper_refuses_before_it_loads(no_kernel):
    q = torch.randn(2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        k3.flash_attention(q, q.clone(), q.clone())
    with pytest.raises(ValueError, match="compiled"):
        k3.flash_attention(q, q, q, block_q=128, block_k=128)
    with pytest.raises(ValueError, match="compiled"):
        k3.flash_attention(q, q, q, block_q=32)
    with pytest.raises(ValueError, match=r"\(BH,Tq,D\)"):
        k3.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match=r"\(BH,Tq,D\)"):
        k3.flash_attention(q, q[:, :, :16].contiguous(), q)
    with pytest.raises(TypeError):
        k3.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(TypeError):
        k3.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        k3.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                           q, q)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.randn(1, 4, 300)
        k3.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="window"):
        k3.flash_attention(q, q, q, window=-1)
    with pytest.raises(ValueError, match="key"):
        k3.flash_attention(q, q[:, :0], q[:, :0])


def test_attention_smem_claim_fits_a_block():
    # the TPU defaults (128, 128) in f32 at D = 128 would not fit
    assert 4 * 3 * 128 * 128 + 4 * 128 * 128 > hw.SMEM_PER_BLOCK
    for d in (7, 32, 64, 80, 128, 192, 256):
        for dtype in (torch.float32, torch.bfloat16):
            for tq in (1, 16, 17, 2048):
                assert k3.default_blocks(d, dtype, tq) in k3.blocks_for(dtype)
            for bq, bk in k3.blocks_for(dtype):
                assert k3.smem_bytes(bq, bk, d, dtype) <= hw.SMEM_PER_BLOCK
    # f32: Q, K, V staged in f32 at DP + 1, the score block, 3 statistics
    assert k3.smem_bytes(64, 64, 256) == 4 * (64 * 257 * 3 + 64 * 65 + 192)
    # bf16: Q and two buffers each of K and V in bf16 at DP + 8
    assert k3.smem_bytes(64, 64, 128, torch.bfloat16) == 2 * (64 + 256) * 136
    assert k3.smem_bytes(64, 32, 256, torch.bfloat16) == 2 * (64 + 128) * 264
    assert [k3.padded_dim(d) for d in (1, 32, 33, 80, 81, 192, 256)] == \
        [64, 64, 64, 128, 128, 256, 256]


@pytest.mark.parametrize("shape,blocks", [
    ((16, 2048, 2048, 128), (64, 64)),      # qwen3-1.7b prefill
    ((64, 16, 1024, 128), (16, 64)),        # chunked decode: one warp
    ((4, 1, 1024, 128), (16, 64)),          # one-token decode
    ((48, 8192, 8192, 128), (64, 64)),      # Mixtral window
    ((8, 2048, 2048, 256), (64, 32)),       # gemma-2b head dim 256
    ((4, 16, 1024, 256), (16, 32)),
    ((2, 17, 17, 64), (64, 64)),
])
def test_attention_picks_the_bf16_block_from_tq_and_d(shape, blocks):
    bh, tq, tk, d = shape
    assert k3.default_blocks(d, torch.bfloat16, tq) == blocks
    assert blocks in k3.MMA_BLOCKS
    assert k3.default_blocks(d, torch.float32, tq) == \
        ((64, 64) if d <= 128 else (64, 32))


def test_attention_refuses_a_block_of_the_other_dtype(no_kernel):
    q = torch.randn(2, 8, 32)
    with pytest.raises(ValueError, match="compiled in for torch.bfloat16"):
        k3.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                           block_q=32, block_k=32)
    with pytest.raises(ValueError, match="compiled in for torch.float32"):
        k3.flash_attention(q, q, q, block_q=16, block_k=64)


def test_ops_on_cpu_never_count_a_launch(no_kernel):
    before = (k2.launches, k3.launches)
    ops.elementwise("add", torch.ones(2, 2), torch.ones(2, 2),
                    use_kernel=True)
    q = torch.randn(1, 4, 8)
    ops.attention(q, q, q, use_kernel=True)
    assert (k2.launches, k3.launches) == before


def test_build_lists_the_new_kernel_sources():
    assert {"ame_elementwise", "flash_attention"} <= set(_build.sources())
