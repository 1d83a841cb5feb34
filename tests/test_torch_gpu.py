"""K1 (ame_gemm) on the card: built from csrc/, held against its plain
version, launches counted.  Marked ``gpu``: every test skips with a reason
where there is no CUDA device (decided inside the fixture, never while the
module is imported).  On the card: ``python -m pytest -m gpu tests``.
"""
import pytest
import torch

from repro_torch.kernels import ame_gemm as k1
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu

#: per output dtype, the reference's values (tests/test_kernels.py:20-22);
#: f32 runs FP32 FMA (never TF32), so only the order of the sums differs
#: from the plain version (cuBLAS f32)
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=0.06, rtol=0.06),
       torch.float16: dict(atol=0.02, rtol=0.02)}
#: f32 at the main path's depths: the reference's 2e-5 is set for k <= 256;
#: the rounding of a k-term f32 sum in another order grows about as
#: sqrt(k) (measured on an H100: 5.1e-5 at k = 6144, outputs of magnitude ~5),
#: so deep products get 2e-5 * sqrt(k / 256), 9.8e-5 at k = 6144
F32_DEEP = 256


def tol(dtype, k):
    if dtype == torch.float32 and k > F32_DEEP:
        t = 2e-5 * (k / F32_DEEP) ** 0.5
        return dict(atol=t, rtol=t)
    return TOL[dtype]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pair(m, k, n, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(m, k, generator=g, device=device) * 0.3
    b = torch.randn(k, n, generator=g, device=device) * 0.3
    return a.to(dtype), b.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,k,n", [(1, 2048, 2048), (4, 2048, 6144),
                                   (64, 6144, 2048), (100, 130, 70),
                                   (257, 33, 129), (8, 8, 8)])
@pytest.mark.parametrize("blocks", k1.BLOCKS, ids=lambda b: "x".join(map(str, b)))
def test_kernel_matches_plain(cuda, m, k, n, dtype, blocks):
    a, b = _pair(m, k, n, dtype, cuda)
    bm, bn, bk = blocks
    got = k1.ame_gemm(a, b, block_m=bm, block_n=bn, block_k=bk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.gemm(a, b).float(),
                               **tol(dtype, k))


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16, torch.float16])
def test_kernel_out_dtype(cuda, out):
    a, b = _pair(33, 77, 65, torch.bfloat16, cuda)
    got = ops.gemm(a, b, use_kernel=True, out_dtype=out)
    assert got.dtype == out
    torch.testing.assert_close(got.float(), ref.gemm(a, b, out).float(),
                               **TOL[out])


def test_launch_counter_counts_kernel_launches_only(cuda):
    a, b = _pair(4, 64, 32, torch.bfloat16, cuda)
    before = k1.launches
    ops.gemm(a, b, use_kernel=True)
    ops.gemm(a, b, use_kernel=False)
    ops.gemm(a.cpu(), b.cpu(), use_kernel=True)
    assert k1.launches == before + 1


def test_kernel_rejects_what_it_does_not_take(cuda):
    a, b = _pair(8, 16, 8, torch.float32, cuda)
    with pytest.raises(ValueError, match="compiled"):
        k1.ame_gemm(a, b, block_m=128, block_n=128, block_k=512)
    with pytest.raises(ValueError, match="contiguous"):
        k1.ame_gemm(a, b.t().contiguous().t())
    with pytest.raises(TypeError):
        k1.ame_gemm(a, b.half())
