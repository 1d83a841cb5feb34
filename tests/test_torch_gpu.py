"""K1 (ame_gemm) and K4 (ssd_scan) on the card: built from csrc/, held
against their plain versions, launches counted.  Marked ``gpu``: every test skips with a reason
where there is no CUDA device (decided inside the fixture, never while the
module is imported).  On the card: ``python -m pytest -m gpu tests``.
"""
import pytest
import torch

from repro_torch.kernels import ame_gemm as k1
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as k4
from repro_torch.launch import hw

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


# ---------------------------------------------------------------------------
# K4 ssd_scan
# ---------------------------------------------------------------------------

#: the reference's values (tests/test_kernels.py:104-105), by x's dtype
SSD_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3),
           torch.bfloat16: dict(atol=0.08, rtol=0.08)}


def _ssd_inputs(bh, t, p, n, xdt, bdt, device, seed=0):
    """x, b, c ~ 0.5 N(0,1) and log_a = -|0.2 N(0,1)|, as the reference
    tests draw them."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(bh, t, p, generator=g, device=device) * 0.5).to(xdt)
    la = -(torch.randn(bh, t, generator=g, device=device) * 0.2).abs()
    b = (torch.randn(bh, t, n, generator=g, device=device) * 0.5).to(bdt)
    c = (torch.randn(bh, t, n, generator=g, device=device) * 0.5).to(bdt)
    return x, la, b, c


@pytest.mark.parametrize("xdt,bdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "f32-x-bf16-bc", "bf16-x-f32-bc"])
@pytest.mark.parametrize("bh,t,p,n,chunk", [
    (2, 64, 16, 8, 16), (1, 100, 32, 16, 32), (3, 33, 8, 4, 16),
    (1, 16, 8, 8, 16), (32, 37, 64, 128, 128), (32, 300, 64, 128, 128),
    (4, 129, 40, 24, 64)])
def test_ssd_kernel_matches_plain(cuda, bh, t, p, n, chunk, xdt, bdt):
    x, la, b, c = _ssd_inputs(bh, t, p, n, xdt, bdt, cuda)
    got = k4.ssd_scan(x, la, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert got.dtype == xdt and got.shape == (bh, t, p)
    torch.testing.assert_close(
        got.float(), ref.ssd_chunked(x, la, b, c, chunk=chunk).float(),
        **SSD_TOL[xdt])


def test_ssd_kernel_carries_state_across_chunks(cuda):
    x = torch.zeros(1, 64, 4, device=cuda)
    x[0, 0] = 1.0
    la = torch.full((1, 64), -0.01, device=cuda)
    ones = torch.ones(1, 64, 4, device=cuda)
    got = k4.ssd_scan(x, la, ones, ones, chunk=16)
    torch.cuda.synchronize()
    assert float(got[0, -1].abs().max()) > 0.1
    torch.testing.assert_close(got, ref.ssd_scan(x, la, ones, ones),
                               **SSD_TOL[torch.float32])


def test_ssd4_takes_transposed_inputs(cuda):
    x, la, b, c = _ssd_inputs(6, 50, 16, 8, torch.float32, torch.bfloat16,
                              cuda)
    four = [v.reshape(2, 3, *v.shape[1:]) for v in (x, la, b, c)]
    # (B,T,H,*) stored, (B,H,T,*) seen — as the model hands them over
    tr = [v.transpose(1, 2).contiguous().transpose(1, 2) for v in four]
    assert not tr[0].is_contiguous()
    got = ops.ssd4(*tr, use_kernel=True, chunk=32)
    torch.testing.assert_close(got, ref.ssd_chunked4(*four, chunk=32),
                               **SSD_TOL[torch.float32])


def test_ssd_launch_counter_counts_kernel_launches_only(cuda):
    x, la, b, c = _ssd_inputs(2, 20, 8, 4, torch.float32, torch.float32,
                              cuda)
    before = k4.launches
    ops.ssd(x, la, b, c, use_kernel=True, chunk=8)
    ops.ssd(x, la, b, c, use_kernel=False, chunk=8)
    ops.ssd(x.cpu(), la.cpu(), b.cpu(), c.cpu(), use_kernel=True, chunk=8)
    assert k4.launches == before + 1


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, la, b, c = _ssd_inputs(2, 20, 8, 4, torch.float32, torch.float32,
                              cuda)
    with pytest.raises(ValueError, match="CUDA"):
        k4.ssd_scan(x, la.cpu(), b, c)
    with pytest.raises(ValueError, match="contiguous"):
        k4.ssd_scan(x.transpose(0, 1).contiguous().transpose(0, 1), la, b, c)
    with pytest.raises(TypeError):
        k4.ssd_scan(x.half(), la, b, c)
    with pytest.raises(TypeError):
        k4.ssd_scan(x, la.bfloat16(), b, c)
    with pytest.raises(TypeError):
        k4.ssd_scan(x, la, b, c.bfloat16())
    with pytest.raises(ValueError, match="shared memory"):
        k4.ssd_scan(*_ssd_inputs(1, 256, 8, 128, torch.float32,
                                 torch.float32, cuda), chunk=256)


def test_ssd_smem_claim_matches_the_source_and_fits(cuda):
    lib = k4._lib()
    for l, n in ((128, 128), (64, 128), (16, 4), (100, 24)):
        assert lib.ssd_scan_smem_bytes(l, n) == k4.smem_bytes(l, n)
    assert k4.smem_bytes(128, 128) < hw.SMEM_PER_BLOCK
