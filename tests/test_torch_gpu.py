"""K1 (ame_gemm), K2 (ame_elementwise), K3 (flash_attention) and K4
(ssd_scan) on the card: built from csrc/, held against their plain
versions, launches counted; and the PIM runtime's numerics (and the
numeric decode offload's) on the card bit for bit with the same calls on
the CPU.  Marked ``gpu``: every test
skips with a reason where there is no CUDA device (decided inside the
fixture, never while the module is imported).  On the card:
``python -m pytest -m gpu tests``.
"""
import pytest
import torch

from repro_torch.kernels import ame_gemm as k1
from repro_torch.kernels import attention as k3
from repro_torch.kernels import elementwise as k2
from repro_torch.kernels import _build, ops, ref
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


def _k1_cases():
    """(m, k, n, dtype, block) for every block of the variant each shape
    and dtype takes: mma for bf16/f16 with k and n multiples of 8, fma for
    f32 and the ragged shapes."""
    for m, k, n in [(1, 2048, 2048), (4, 2048, 6144), (64, 6144, 2048),
                    (100, 130, 70), (257, 33, 129), (8, 8, 8)]:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            mma = dtype != torch.float32 and k % 8 == 0 and n % 8 == 0
            for blocks in (k1.MMA_BLOCKS if mma else k1.BLOCKS):
                yield m, k, n, dtype, blocks


@pytest.mark.parametrize("m,k,n,dtype,blocks", list(_k1_cases()),
                         ids=lambda x: "x".join(map(str, x))
                         if isinstance(x, tuple) else str(x))
def test_kernel_matches_plain(cuda, m, k, n, dtype, blocks):
    a, b = _pair(m, k, n, dtype, cuda)
    bm, bn, bk = blocks
    got = k1.ame_gemm(a, b, block_m=bm, block_n=bn, block_k=bk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.gemm(a, b).float(),
                               **tol(dtype, k))


#: (k, n) of every K1 call on the serving paths: qwen3-1.7b's q/o, k/v,
#: gate/up and down projections, mamba2-370m's in_proj and out_proj
SERVE_KN = [(2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048),
            (1024, 4384)]


@pytest.mark.parametrize("out", [None, torch.float32], ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("k,n", SERVE_KN)
@pytest.mark.parametrize("m", [1, 4, 16, 64, 300])
def test_mma_kernel_at_serving_shapes(cuda, m, k, n, dtype, out):
    """Every serving shape takes the tensor-core variant with the block
    the wrapper picks, and matches the plain version."""
    a, b = _pair(m, k, n, dtype, cuda, seed=m)
    assert k1.variant(a, b) == "mma"
    before = k1.launches
    got = k1.ame_gemm(a, b, out_dtype=out)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert got.dtype == (out or dtype) and got.shape == (m, n)
    torch.testing.assert_close(got.float(), ref.gemm(a, b, out).float(),
                               **tol(out or dtype, k))


#: zamba2-2.7b: the mamba layer's in_proj and out_proj; the shared
#: block's q/k/v/o, its MLP's wi and wo (gelu, no gate)
ZAMBA2_KN = [(2560, 10448), (5120, 2560), (2560, 2560), (2560, 10240),
             (10240, 2560)]


@pytest.mark.parametrize("k,n", ZAMBA2_KN)
@pytest.mark.parametrize("m", [1, 4, 64, 300])
def test_mma_kernel_at_zamba2_shapes(cuda, m, k, n):
    """zamba2-2.7b's projections, as served in bf16, take the
    tensor-core variant and match the plain version."""
    a, b = _pair(m, k, n, torch.bfloat16, cuda, seed=m)
    assert k1.variant(a, b) == "mma"
    before = k1.launches
    got = k1.ame_gemm(a, b)
    torch.cuda.synchronize()
    assert k1.launches == before + 1 and got.shape == (m, n)
    torch.testing.assert_close(got.float(), ref.gemm(a, b).float(),
                               **tol(torch.bfloat16, k))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_unaligned_shapes_take_the_general_kernel(cuda, dtype):
    """n or k not a multiple of 8, or a view that does not start on 16
    bytes, cannot be copied in 16-byte pieces: the fma kernel takes them,
    and is still right."""
    cases = [_pair(100, 130, 70, dtype, cuda), _pair(257, 33, 129, dtype, cuda)]
    g = torch.Generator(device=cuda).manual_seed(3)
    base = (torch.randn(64 * 128 + 1, generator=g, device=cuda) * 0.3).to(dtype)
    a = base[1:].view(64, 128)               # contiguous, not 16-byte aligned
    cases.append((a, _pair(64, 128, 256, dtype, cuda)[1]))
    for a, b in cases:
        assert k1.variant(a, b) == "fma"
        got = k1.ame_gemm(a, b)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.gemm(a, b).float(),
                                   **TOL[dtype])


def test_mma_smem_claim_matches_the_source_and_fits(cuda):
    fn = _build.entry("ame_gemm", "ame_gemm_mma_smem_bytes",
                      k1.SMEM_ARGTYPES)
    for blocks in k1.MMA_BLOCKS:
        assert fn(*blocks) == k1.smem_bytes(*blocks, kind="mma")
        assert fn(*blocks) <= hw.SMEM_PER_BLOCK
    assert fn(64, 64, 32) == 0


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


#: the main path's lengths: one and a few tokens, a chunk boundary, two
#: chunks and a ragged third, the longest prefill
SSD_T = [1, 8, 16, 37, 64, 128, 129, 300, 2048]


@pytest.mark.parametrize("variant", ["mma", "fma"])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("t", SSD_T)
def test_ssd_variants_match_plain(cuda, t, xdt, variant):
    """Both variants at mamba2-370m's widths (BH 32, P 64, N 128, bf16
    b/c, chunk 128); past T = 128 the state is carried across chunks."""
    x, la, b, c = _ssd_inputs(32, t, 64, 128, xdt, torch.bfloat16, cuda)
    assert k4.variant(x, b, c) == "mma"
    before = dict(k4.launches_by_variant)
    got = k4.ssd_scan(x, la, b, c, chunk=128, variant=variant)
    torch.cuda.synchronize()
    assert k4.launches_by_variant[variant] == before[variant] + 1
    assert got.dtype == xdt and got.shape == x.shape
    torch.testing.assert_close(
        got.float(), ref.ssd_chunked(x, la, b, c, chunk=128).float(),
        **SSD_TOL[xdt])


@pytest.mark.parametrize("bh,t,p,n,chunk", [
    (32, 300, 64, 128, 128), (4, 100, 64, 128, 37), (2, 300, 64, 64, 32),
    (2, 300, 64, 128, 256), (3, 50, 128, 16, 16)])
def test_ssd_mma_shapes_match_plain(cuda, bh, t, p, n, chunk):
    """The mma kernel off the serve's widths: a chunk of 37 rows pads each
    tile to 48 (rows past the chunk are zero), a chunk of 256 is walked as
    128-row chunks, N = 64 and 16, P = 128."""
    x, la, b, c = _ssd_inputs(bh, t, p, n, torch.float32, torch.bfloat16,
                              cuda)
    assert k4.variant(x, b, c) == "mma"
    got = k4.ssd_scan(x, la, b, c, chunk=chunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.ssd_chunked(x, la, b, c, chunk=chunk),
                               **SSD_TOL[torch.float32])


@pytest.mark.parametrize("p,n,bdt", [(4, 4, torch.float32),
                                     (16, 16, torch.bfloat16)],
                         ids=["fma", "mma"])
def test_ssd_kernel_carries_state_across_chunks(cuda, p, n, bdt):
    x = torch.zeros(1, 64, p, device=cuda)
    x[0, 0] = 1.0
    la = torch.full((1, 64), -0.01, device=cuda)
    ones = torch.ones(1, 64, n, device=cuda, dtype=bdt)
    got = k4.ssd_scan(x, la, ones, ones, chunk=16)
    torch.cuda.synchronize()
    assert float(got[0, -1].abs().max()) > 0.1
    torch.testing.assert_close(got, ref.ssd_scan(x, la, ones, ones),
                               **SSD_TOL[torch.float32])


@pytest.mark.parametrize("layout", ["transposed", "conv"])
@pytest.mark.parametrize("bdt", [torch.float32, torch.bfloat16], ids=str)
def test_ssd4_takes_transposed_inputs(cuda, bdt, layout):
    """ops.ssd4 on the model's views, x and log_a transposed out of
    (B,T,H,.), and b and c either transposed out of (B,T,H,N) (time stride
    H N) or, as mamba_apply hands them over, columns of one (B,T,conv_dim)
    conv output expanded over heads (time stride conv_dim, head stride 0);
    y comes back in x's layout.  Held against ref.ssd_chunked4 on
    contiguous copies."""
    bsz, h, t, p, n = 2, 4, 150, 64, 128
    x, la, b, c = _ssd_inputs(bsz * h, t, p, n, torch.float32, bdt, cuda)
    four = [v.reshape(bsz, h, *v.shape[1:]) for v in (x, la, b, c)]
    # (B,T,H,*) stored, (B,H,T,*) seen
    tr = [v.transpose(1, 2).contiguous().transpose(1, 2) for v in four]
    if layout == "conv":
        conv = torch.cat([x.new_zeros(bsz, t, h * p).to(bdt),
                          four[2][:, 0], four[3][:, 0]], -1)
        cols = torch.split(conv, [h * p, n, n], -1)[1:]
        tr[2:] = [v.reshape(bsz, t, 1, n).expand(bsz, t, h, n)
                  .transpose(1, 2) for v in cols]
        assert tr[2].stride() == (t * (h * p + 2 * n), 0, h * p + 2 * n, 1)
    else:
        assert tr[2].stride(2) == h * n
    assert not tr[0].is_contiguous()
    before = dict(k4.launches_by_variant)
    got = ops.ssd4(*tr, use_kernel=True, chunk=128)
    torch.cuda.synchronize()
    var = "mma" if bdt == torch.bfloat16 else "fma"
    assert k4.launches_by_variant[var] == before[var] + 1
    assert got.stride() == tr[0].stride()
    want = ref.ssd_chunked4(*[v.contiguous() for v in tr], chunk=128)
    torch.testing.assert_close(got, want, **SSD_TOL[torch.float32])


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
    with pytest.raises(ValueError, match="unit stride"):
        k4.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), la, b, c)
    with pytest.raises(TypeError):
        k4.ssd_scan(x.half(), la, b, c)
    with pytest.raises(TypeError):
        k4.ssd_scan(x, la.bfloat16(), b, c)
    with pytest.raises(TypeError):
        k4.ssd_scan(x, la, b, c.bfloat16())
    with pytest.raises(ValueError, match="shared memory"):
        k4.ssd_scan(*_ssd_inputs(1, 256, 8, 128, torch.float32,
                                 torch.float32, cuda), chunk=256)
    # a variant is named, never tried after another fails
    with pytest.raises(ValueError, match="mma variant"):
        k4.ssd_scan(x, la, b, c, variant="mma")
    xm, lm, bm, cm = _ssd_inputs(2, 20, 40, 128, torch.float32,
                                 torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="mma variant"):
        k4.ssd_scan(xm, lm, bm, cm, variant="mma")     # P % 16 != 0
    with pytest.raises(ValueError, match="variant must be"):
        k4.ssd_scan(xm, lm, bm, cm, variant="wgmma")


#: zamba2-2.7b's scan: 80 heads of P = 64 a sequence, N = 64, chunk 128
ZAMBA2_SSD = dict(h=80, p=64, n=64, chunk=128)


@pytest.mark.parametrize("t", [37, 64, 300, 2048])
def test_ssd_mma_at_zamba2_shapes(cuda, t):
    """K4 at zamba2-2.7b's widths, contiguous (80, T, 64, 64) operands:
    f32 x, bf16 b/c, the mma variant."""
    z = ZAMBA2_SSD
    x, la, b, c = _ssd_inputs(z["h"], t, z["p"], z["n"], torch.float32,
                              torch.bfloat16, cuda, seed=t)
    assert k4.variant(x, b, c) == "mma"
    before = dict(k4.launches_by_variant)
    got = k4.ssd_scan(x, la, b, c, chunk=z["chunk"])
    torch.cuda.synchronize()
    assert k4.launches_by_variant["mma"] == before["mma"] + 1
    torch.testing.assert_close(
        got, ref.ssd_chunked(x, la, b, c, chunk=z["chunk"]),
        **SSD_TOL[torch.float32])


@pytest.mark.parametrize("bsz,t", [(1, 300), (2, 64), (1, 2048)])
def test_ssd4_mma_on_zamba2_serve_views(cuda, bsz, t):
    """ops.ssd4 on the views a full-width zamba2 mamba layer hands it in
    bf16 compute: x*dt f32 seen (B,80,T,64) out of (B,T,80,64), b and c
    columns of one bf16 (B,T,5248) conv output expanded over the 80 heads;
    held against ref.ssd_chunked4 on contiguous copies."""
    z = ZAMBA2_SSD
    h, p, n = z["h"], z["p"], z["n"]
    g = torch.Generator(device=cuda).manual_seed(t)
    conv = (torch.randn(bsz, t, h * p + 2 * n, generator=g, device=cuda)
            * 0.5).bfloat16()
    xs, bs, cs = torch.split(conv, [h * p, n, n], -1)
    dt = torch.rand(bsz, t, h, generator=g, device=cuda) * 0.5 + 0.05
    x = (xs.reshape(bsz, t, h, p) * dt[..., None]).transpose(1, 2)
    la = -(dt * 0.4).transpose(1, 2).contiguous()
    b, c = [v.reshape(bsz, t, 1, n).expand(bsz, t, h, n).transpose(1, 2)
            for v in (bs, cs)]
    assert b.stride() == (t * (h * p + 2 * n), 0, h * p + 2 * n, 1)
    assert k4.variant(x, b, c) == "mma"
    before = dict(k4.launches_by_variant)
    got = ops.ssd4(x, la, b, c, use_kernel=True, chunk=z["chunk"])
    torch.cuda.synchronize()
    assert k4.launches_by_variant["mma"] == before["mma"] + 1
    want = ref.ssd_chunked4(*[v.contiguous() for v in (x, la, b, c)],
                            chunk=z["chunk"])
    torch.testing.assert_close(got, want, **SSD_TOL[torch.float32])


def test_ssd_smem_claim_matches_the_source_and_fits(cuda):
    fn = _build.entry("ssd_scan", "ssd_scan_smem_bytes", k4.SMEM_ARGTYPES)
    for l, n in ((128, 128), (64, 128), (16, 4), (100, 24), (37, 128),
                 (256, 64)):
        assert fn(0, l, n, 0) == k4.smem_bytes(l, n, variant="fma")
        if n % 16:
            continue
        for code, xdt in ((0, torch.float32), (1, torch.bfloat16)):
            assert fn(1, l, n, code) == k4.smem_bytes(l, n, x_dtype=xdt)
    assert fn(1, 128, 128, 2) == 0                  # no such x dtype
    assert k4.smem_bytes(128, 128, variant="fma") < hw.SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# K2 ame_elementwise: bit for bit against torch's own +, -, * (and relu)
# ---------------------------------------------------------------------------

BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
        torch.float16: torch.int16}
EW_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def assert_same_bits(got, want):
    """Equal shape, dtype and bits; NaN where the other is NaN (a NaN's
    payload is the hardware's, not the function's)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(BITS[got.dtype]),
                       want[~nan].view(BITS[want.dtype]))


def _ew_pair(m, c, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(m, c, generator=g, device=device).to(dtype),
            torch.randn(m, c, generator=g, device=device).to(dtype))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", EW_DTYPES, ids=str)
@pytest.mark.parametrize("kind", ["add", "sub", "mul"])
@pytest.mark.parametrize("m,c", [(128, 2048), (57, 129), (1, 8), (128, 4096),
                                 (3, 5), (1, 1), (1000, 1001), (4097, 129)])
def test_elementwise_kernel_bit_exact(cuda, m, c, kind, dtype, relu):
    a, b = _ew_pair(m, c, dtype, cuda)
    got = k2.ame_elementwise(a, b, kind=kind, relu=relu)
    torch.cuda.synchronize()
    assert_same_bits(got, ref.elementwise(kind, a, b, relu=relu))


@pytest.mark.parametrize("dtype", EW_DTYPES, ids=str)
@pytest.mark.parametrize("kind", ["add", "sub", "mul"])
def test_elementwise_kernel_specials(cuda, kind, dtype):
    """NaN passes ReLU, -0 stays -0, infinities and f32 denormals are kept
    (no fast math), on the vector path and the scalar tail."""
    a, b = _ew_pair(4, 37, dtype, cuda)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                            1e-40, -1e-40, 6e-8, -3e-39], device=cuda)
    a[0, :8] = special.to(dtype)
    a[3, -8:] = special.to(dtype)
    b[1, :8] = special.to(dtype)
    for relu in (False, True):
        got = k2.ame_elementwise(a, b, kind=kind, relu=relu)
        want = ref.elementwise(kind, a, b, relu=relu)
        assert_same_bits(got, want)
    assert torch.isnan(k2.ame_elementwise(a, b, kind=kind, relu=True)[0, 0])


@pytest.mark.parametrize("dtype", EW_DTYPES, ids=str)
def test_elementwise_kernel_misaligned_view(cuda, dtype):
    """A view that starts one element into its storage is contiguous but
    not 16-byte aligned: the kernel takes its scalar pass."""
    m, c = 33, 64
    base = torch.randn(m * c + 1, device=cuda).to(dtype)
    a = base[1:].view(m, c)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    b = _ew_pair(m, c, dtype, cuda)[1]
    for kind in ("add", "sub", "mul"):
        assert_same_bits(k2.ame_elementwise(a, b, kind=kind, relu=True),
                         ref.elementwise(kind, a, b, relu=True))
        assert_same_bits(k2.ame_elementwise(b, a, kind=kind),
                         ref.elementwise(kind, b, a))


@pytest.mark.parametrize("kind", ["add", "sub", "mul"])
@pytest.mark.parametrize("dtype", EW_DTYPES, ids=str)
def test_elementwise_pass_covers_tails_bit_exact(cuda, dtype, kind):
    """The one pass at a scalar tail, many blocks of items with a partial
    last block, and a misaligned view (the scalar pass), bit for bit."""
    base = torch.randn(4097 * 129 + 1, device=cuda).to(dtype)
    cases = [_ew_pair(57, 129, dtype, cuda), _ew_pair(4097, 129, dtype, cuda),
             (base[1:].view(4097, 129), _ew_pair(4097, 129, dtype, cuda)[1])]
    for a, b in cases:
        for relu in (False, True):
            got = k2.ame_elementwise(a, b, kind=kind, relu=relu)
            assert_same_bits(got, ref.elementwise(kind, a, b, relu=relu))


def test_elementwise_launch_counter_counts_kernel_launches_only(cuda):
    a, b = _ew_pair(4, 64, torch.float16, cuda)
    before = k2.launches
    ops.elementwise("mul", a, b, use_kernel=True)
    ops.elementwise("mul", a, b, use_kernel=False)
    ops.elementwise("mul", a.cpu(), b.cpu(), use_kernel=True)
    assert k2.launches == before + 1
    # vectors and a scalar tail are one launch
    ops.elementwise("add", *_ew_pair(57, 129, torch.float16, cuda),
                    use_kernel=True)
    assert k2.launches == before + 2


def test_elementwise_kernel_rejects_what_it_does_not_take(cuda):
    a, b = _ew_pair(8, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k2.ame_elementwise(a.t(), b.t())
    with pytest.raises(ValueError, match="CUDA"):
        k2.ame_elementwise(a, b.cpu())
    with pytest.raises(TypeError):
        k2.ame_elementwise(a, b.half())
    with pytest.raises(ValueError, match="kind"):
        k2.ame_elementwise(a, b, kind="max")


# ---------------------------------------------------------------------------
# K3 flash_attention
# ---------------------------------------------------------------------------

#: the reference's test shapes (tests/test_kernels.py:124-131)
ATTN_CASES = [(2, 64, 64, 32, True, 0), (1, 128, 128, 64, True, 0),
              (1, 100, 100, 32, True, 0), (2, 64, 64, 32, False, 0),
              (1, 128, 128, 32, True, 48), (1, 16, 128, 32, True, 0)]


#: f32: the reference's value (tests/test_kernels.py:20-22); bf16, on the
#: peaked inputs of _peaked_qkv: one bf16 ulp (2^-7 |x|) plus a floor, far
#: under the reference's 0.06 — the kernel and the plain version both
#: compute in f32 and round once
MODEL_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
             torch.bfloat16: dict(atol=2e-3, rtol=8e-3)}


def _qkv(bh, tq, tk, d, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(bh, t, d, generator=g, device=device) * 0.5)
            .to(dtype) for t in (tq, tk, tk)]


def _peaked_qkv(bh, tq, tk, d, dtype, device, seed=0):
    """q, k at scale 3^0.5 (scores of std 3, a peaked softmax) and unit v:
    outputs are O(1), so a dropped or mis-masked KV tile fails
    MODEL_TOL."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(bh, t, d, generator=g, device=device) * s)
            .to(dtype) for t, s in ((tq, 3 ** 0.5), (tk, 3 ** 0.5), (tk, 1))]


@pytest.mark.parametrize("dtype,blocks", [
    (dtype, blocks) for dtype in (torch.float32, torch.bfloat16)
    for blocks in k3.blocks_for(dtype)], ids=str)
@pytest.mark.parametrize("bh,tq,tk,d,causal,window", ATTN_CASES)
def test_attention_kernel_matches_plain(cuda, bh, tq, tk, d, causal, window,
                                        dtype, blocks):
    draw = _peaked_qkv if dtype == torch.bfloat16 else _qkv
    q, k, v = draw(bh, tq, tk, d, dtype, cuda)
    bq, bk = blocks
    got = k3.flash_attention(q, k, v, causal=causal, window=window,
                             block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(
        got.float(), ref.attention(q, k, v, causal=causal,
                                   window=window).float(), **MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype,blocks", [(torch.float32, {})] + [
    (torch.bfloat16, dict(block_q=bq, block_k=bk)) for bq, bk in
    k3.MMA_BLOCKS], ids=str)
@pytest.mark.parametrize("bh,tq,tk,d,causal,window", [
    (4, 256, 256, 128, True, 0),       # qwen3 / Mixtral head dim
    (8, 16, 1024, 128, True, 0),       # chunked decode
    (2, 512, 512, 128, True, 200),     # sliding window across tiles
    (2, 300, 300, 256, True, 0),       # gemma-2b head dim
    (2, 97, 97, 80, True, 0),          # hubert / zamba2 head dim
    (1, 64, 64, 192, False, 0),        # the MLA query width
    (2, 40, 24, 64, False, 0),         # Tq > Tk without a causal mask
    (1, 1, 333, 128, True, 0),         # one-token decode
    (2, 130, 130, 7, True, 33),        # an odd head dim and window
    (2, 256, 256, 64, True, 0),        # head dim 64, causal
    (2, 200, 200, 64, False, 0),       # head dim 64, no mask
    (4, 1, 1024, 128, True, 0),        # one query against Tk = 1024
    (4, 16, 1024, 64, True, 0),        # the short-query block at D = 64
    (4, 16, 1024, 256, True, 0),       # the short-query block at D = 256
    (2, 100, 1000, 128, True, 0),      # KV padding: Tk % block_k != 0
    (2, 77, 333, 256, False, 0),       # KV padding at D = 256
    (2, 300, 700, 128, True, 150),     # a window across tiles, Tq < Tk
])
def test_attention_kernel_at_model_shapes(cuda, bh, tq, tk, d, causal,
                                          window, dtype, blocks):
    draw = _peaked_qkv if dtype == torch.bfloat16 else _qkv
    q, k, v = draw(bh, tq, tk, d, dtype, cuda, seed=1)
    got = ops.attention(q, k, v, causal=causal, window=window,
                        use_kernel=True, **blocks)
    torch.testing.assert_close(
        got.float(), ref.attention(q, k, v, causal=causal,
                                   window=window).float(), **MODEL_TOL[dtype])


@pytest.mark.parametrize("bh,tq,tk,d,window", [
    (16, 2048, 2048, 128, 0),          # qwen3-1.7b prefill
    (64, 16, 1024, 128, 0),            # chunked decode
    (48, 8192, 8192, 128, 4096),       # Mixtral-8x22B sliding window
    (8, 2048, 2048, 256, 0),           # gemma-2b
])
def test_attention_kernel_at_full_model_size(cuda, bh, tq, tk, d, window):
    q, k, v = _peaked_qkv(bh, tq, tk, d, torch.bfloat16, cuda, seed=2)
    got = k3.flash_attention(q, k, v, window=window)
    want = ref.attention(q, k, v, window=window).float()
    assert float(want.abs().mean()) > 0.1       # O(1): the limit can fail
    torch.testing.assert_close(got.float(), want,
                               **MODEL_TOL[torch.bfloat16])


def test_attention_launch_counter_counts_kernel_launches_only(cuda):
    q, k, v = _qkv(2, 8, 8, 32, torch.float32, cuda)
    before = k3.launches
    ops.attention(q, k, v, use_kernel=True)
    ops.attention(q, k, v, use_kernel=False)
    ops.attention(q.cpu(), k.cpu(), v.cpu(), use_kernel=True)
    assert k3.launches == before + 1


def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(2, 16, 16, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="compiled"):
        k3.flash_attention(q, k, v, block_q=128, block_k=128)
    with pytest.raises(ValueError, match="see no key"):
        k3.flash_attention(q, k[:, :8].contiguous(), v[:, :8].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        k3.flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        k3.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dim"):
        k3.flash_attention(*_qkv(1, 4, 4, 320, torch.float32, cuda))


def test_attention_smem_claim_matches_the_source_and_fits(cuda):
    fn = _build.entry("flash_attention", "flash_attention_smem_bytes",
                      k3.SMEM_ARGTYPES)
    for dtype, code in k3.DTYPE_CODES.items():
        for bq, bk in k3.blocks_for(dtype):
            for d in (7, 32, 64, 80, 128, 192, 256):
                assert fn(bq, bk, d, code) == k3.smem_bytes(bq, bk, d, dtype)
                assert k3.smem_bytes(bq, bk, d, dtype) <= hw.SMEM_PER_BLOCK
    assert fn(64, 64, 257, 0) == 0
    assert fn(16, 16, 64, 1) == 0


# ---------------------------------------------------------------------------
# the decode attention kernel against chunked_attention's decode call
# ---------------------------------------------------------------------------


def _decode_case(b, clen, hkv, g, d, dtype, device, positions, seed=0):
    """q and a slot cache as the decode branch hands them over, after the
    new key was written: slot j holds position j up to the slot's own
    position, with some slots unwritten (-1); past it, stale entries of an
    earlier, longer request (position j, random K and V) or -1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, 1, hkv * g, d, generator=gen, device=device)
    k = torch.randn(b, clen, hkv, d, generator=gen, device=device)
    v = torch.randn(b, clen, hkv, d, generator=gen, device=device)
    pos = torch.as_tensor(positions, dtype=torch.long, device=device)
    kpos = torch.arange(clen, device=device).expand(b, clen).clone()
    kpos[torch.rand(b, clen, generator=gen, device=device) < 0.05] = -1
    kpos[torch.arange(b, device=device), pos] = pos
    return (q.to(dtype), k.to(dtype), v.to(dtype), kpos.to(torch.int32),
            pos)


def _ragged(b, clen, seed=0):
    """Positions 0 and clen - 1 and ragged ones between."""
    gen = torch.Generator().manual_seed(seed)
    mid = torch.randint(1, clen - 1, (b - 2,), generator=gen).tolist()
    return [0, clen - 1] + mid


def bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the scale of ``x``'s largest magnitude."""
    import math
    return 2.0 ** (math.floor(math.log2(float(x.abs().max()))) - 7)


@pytest.mark.parametrize("b,clen,hkv,g,d,dtype", [
    (32, 1312, 8, 2, 128, torch.bfloat16),     # the chat cell's decode
    (4, 600, 32, 1, 80, torch.bfloat16),       # zamba2's shared block
    (8, 1000, 1, 8, 256, torch.bfloat16),      # gemma-2b (MQA)
    (8, 700, 8, 3, 128, torch.bfloat16),       # phi4-mini-3.8b
    (4, 300, 8, 8, 128, torch.bfloat16),       # command-r, internvl2
    (3, 90, 2, 2, 32, torch.bfloat16),         # the reduced configurations
    (2, 500, 1, 16, 64, torch.bfloat16),       # a group of 16: two chunks
    (6, 257, 4, 1, 64, torch.float32),
    (5, 333, 2, 4, 128, torch.float32),
    (3, 90, 2, 2, 32, torch.float32),
    (4, 1000, 1, 8, 256, torch.float32),
], ids=str)
def test_decode_attention_matches_chunked_attention(cuda, b, clen, hkv, g,
                                                    d, dtype):
    """The kernel against chunked_attention called as the decode branch
    calls it: bf16 within one bf16 ulp of the output's scale, f32 within
    the reference's f32 tolerance (only the order of the sums differs)."""
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.models.attention import chunked_attention
    q, k, v, kpos, pos = _decode_case(b, clen, hkv, g, d, dtype, cuda,
                                      _ragged(b, clen, seed=d + g))
    before = kd.launches
    got = kd.decode_attention(q, k, v, kpos, pos)
    torch.cuda.synchronize()
    assert kd.launches == before + 1
    want = chunked_attention(q, k, v, causal=True, q_offset=pos,
                             kv_positions=kpos)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.bfloat16:
        ulp = bf16_ulp(want.float())
        err = float((got.float() - want.float()).abs().max())
        assert err <= ulp, (err, ulp)
    else:
        torch.testing.assert_close(got, want, **TOL[torch.float32])
    # the same launch again gives the same bits: the arrival counts were
    # left at zero, and no sum depends on the order the blocks ran in
    assert torch.equal(kd.decode_attention(q, k, v, kpos, pos), got)


def test_decode_attention_reads_no_key_past_the_slot(cuda):
    """Keys past a slot's position are never read: NaN there (which any
    read would spread) leaves the output finite and unchanged."""
    from repro_torch.kernels import decode_attention as kd
    q, k, v, kpos, pos = _decode_case(8, 1312, 8, 2, 128, torch.bfloat16,
                                      cuda, _ragged(8, 1312, seed=5))
    want = kd.decode_attention(q, k, v, kpos, pos)
    past = torch.arange(1312, device=cuda)[None, :] > pos[:, None]
    k[past], v[past] = float("nan"), float("nan")
    got = kd.decode_attention(q, k, v, kpos, pos)
    assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_chat_decode_step_kernel_against_chunked_attention(cuda, compute,
                                                           monkeypatch):
    """One decode step of qwen3-1.7b at published widths (4 of its 28
    layers) over the chat cell's 32 slots of 1,312 positions at ragged
    positions: the kernel's logits against the same step with the decode
    branch sent to chunked_attention (f32 within SERVE_F32_LOGITS_TOL of
    chip_smoke.py, with the same greedy tokens; bf16 within its qwen3
    serve limit of 0.25); one kernel launch a layer."""
    from repro_torch.configs import get
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.models import attention
    from repro_torch.models import model as lm
    cfg = get("qwen3-1.7b").replace(n_layers=4).with_policy(
        compute_dtype=compute, param_dtype=compute)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = lm.compute_params(lm.init(cfg, gen, device=cuda), cfg)
    b, clen = 32, 1312
    pos = torch.as_tensor(_ragged(b, clen, seed=1), device=cuda)
    caches = lm.make_caches(cfg, b, clen, cuda)
    c = caches["dense_stack"]
    c["k"].normal_(generator=gen)
    c["v"].normal_(generator=gen)
    j = torch.arange(clen, device=cuda)
    c["pos"][:] = torch.where(j[None, :] < pos[:, None], j, -1).to(
        torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (b, 1), device=cuda,
                         generator=gen)
    before = kd.launches
    with torch.no_grad():
        got, _ = lm.decode_step(params, toks, pos, {"dense_stack": {
            n: t.clone() for n, t in c.items()}}, cfg, backend="kernel")
        assert kd.launches - before == cfg.n_layers
        monkeypatch.setattr(attention, "takes_decode_kernel",
                            lambda *t: False)
        want, _ = lm.decode_step(params, toks, pos, caches, cfg,
                                 backend="kernel")
    assert kd.launches - before == cfg.n_layers
    if compute == "float32":
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    else:
        assert float((got.float() - want.float()).abs().max()) <= 0.25


def test_decode_attention_launch_counter_counts_kernel_launches_only(cuda):
    """A CUDA decode launches the kernel once a layer; a rolling cache
    (mixtral's sliding window) keeps chunked_attention and launches none."""
    from repro_torch.configs import get
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.models import model as lm
    for name, per_step in (("qwen3-1.7b", 4), ("mixtral-8x22b", 0),
                           ("gemma-2b", 4)):
        cfg = get(name).reduced()
        params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
        toks = torch.randint(0, cfg.vocab_size, (2, 20), device=cuda)
        with torch.no_grad():
            lg, caches = lm.prefill(params, {"tokens": toks}, cfg, 24)
            before = kd.launches
            pos = torch.full((2,), 20, device=cuda)
            lm.decode_step(params, lg.argmax(-1)[:, None], pos, caches, cfg)
        assert kd.launches - before == per_step, name


def test_decode_attention_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import decode_attention as kd
    q, k, v, kpos, pos = _decode_case(2, 64, 2, 2, 64, torch.bfloat16, cuda,
                                      [10, 63])
    before = kd.launches
    with pytest.raises(ValueError, match="head dim"):
        kd.decode_attention(*_decode_case(2, 64, 2, 2, 96, torch.bfloat16,
                                          cuda, [10, 63]))
    with pytest.raises(TypeError):
        kd.decode_attention(q, k.float(), v, kpos, pos)
    with pytest.raises(TypeError):
        kd.decode_attention(q.half(), k.half(), v.half(), kpos, pos)
    with pytest.raises(ValueError, match="int32"):
        kd.decode_attention(q, k, v, kpos.long(), pos)
    with pytest.raises(ValueError, match="int32"):
        kd.decode_attention(q, k, v, kpos, pos.float())
    with pytest.raises(ValueError, match=r"\(B,1,H,D\)"):
        kd.decode_attention(q.expand(2, 3, 4, 64), k, v, kpos, pos)
    with pytest.raises(ValueError, match="groups"):
        kd.decode_attention(q[:, :, :3].contiguous(), k, v, kpos, pos)
    with pytest.raises(ValueError, match="contiguous"):
        kd.decode_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                            v, kpos, pos)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
        kd.decode_attention(flat[1:].view(q.shape), k, v, kpos, pos)
    with pytest.raises(ValueError, match="CUDA"):
        kd.decode_attention(q, k, v, kpos, pos.cpu())
    with pytest.raises(RuntimeError, match="forward-only"):
        kd.decode_attention(q.float().requires_grad_(), k.float(), v.float(),
                            kpos, pos)
    assert kd.launches == before


# ---------------------------------------------------------------------------
# MLA's decode kernel against the decode branch's cat + chunked_attention
# ---------------------------------------------------------------------------


def _mla_case(b, clen, h, r, rd, device, positions, seed=0):
    """qq and a bf16 latent cache as MLA's decode branch hands them over:
    every position of the cache written (stale entries past a slot's
    position included), the positions ragged."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qq = torch.randn(b, 1, h, r + rd, generator=gen, device=device)
    ckv = torch.randn(b, clen, r, generator=gen, device=device)
    kr = torch.randn(b, clen, rd, generator=gen, device=device)
    pos = torch.as_tensor(positions, dtype=torch.long, device=device)
    return qq.bfloat16(), ckv.bfloat16(), kr.bfloat16(), pos


@pytest.mark.parametrize("b,clen,h,r,rd", [
    (64, 1312, 128, 512, 64),      # the cell deepseek-v3.chat-64's step
    (8, 64, 128, 512, 64),         # a short cache: one split a slot
    (3, 90, 4, 32, 16),            # the reduced configurations
    (5, 700, 100, 512, 64),        # heads that do not fill a block
], ids=str)
def test_mla_decode_matches_its_plain_version(cuda, b, clen, h, r, rd):
    """The kernel against ``cat`` + chunked_attention, as the decode
    branch computed it, at ragged positions with 0 and clen - 1 among
    them: within one bf16 ulp of the output's scale (only the order of
    the sums differs); the same launch again gives the same bits."""
    from repro_torch.kernels import mla_decode as km
    args = _mla_case(b, clen, h, r, rd, cuda, _ragged(b, clen, seed=b + h))
    before = km.launches
    got = km.mla_decode(*args)
    torch.cuda.synchronize()
    assert km.launches == before + 1
    want = km.plain(*args)
    assert got.shape == want.shape == (b, 1, h, r)
    assert got.dtype == want.dtype == torch.bfloat16
    ulp = bf16_ulp(want.float())
    err = float((got.float() - want.float()).abs().max())
    assert err <= ulp, (err, ulp)
    # the arrival counts were left at zero, and no sum depends on the
    # order the blocks ran in
    assert torch.equal(km.mla_decode(*args), got)


def test_mla_decode_reads_no_key_past_the_slot(cuda):
    """Latents past a slot's position are never read: NaN there (which
    any read would spread) leaves the output finite and unchanged."""
    from repro_torch.kernels import mla_decode as km
    qq, ckv, kr, pos = _mla_case(16, 1312, 128, 512, 64, cuda,
                                 _ragged(16, 1312, seed=3))
    want = km.mla_decode(qq, ckv, kr, pos)
    past = torch.arange(1312, device=cuda)[None, :] > pos[:, None]
    ckv[past], kr[past] = float("nan"), float("nan")
    got = km.mla_decode(qq, ckv, kr, pos, out=torch.empty_like(want))
    assert torch.isfinite(got).all() and torch.equal(got, want)


def _mla_serve(cfg, params, device, spans=None):
    from repro_torch.serve.loop import Request, Server
    import numpy as np
    srv = Server(cfg, params, slots=3, cache_len=48, backend="kernel",
                 device=device, spans=spans)
    rng = np.random.default_rng(0)
    for uid in range(5):
        srv.submit(Request(uid=uid, prompt=rng.integers(
            0, cfg.vocab_size, 6 + 4 * uid).astype(np.int32), max_new=7))
    srv.run_until_drained()
    return srv


def test_mla_decode_launch_counter_counts_kernel_launches_only(cuda):
    """A bf16 MLA decode on the card launches the kernel once a layer; an
    f32 one and a GQA model's launch none."""
    from repro_torch.configs import get
    from repro_torch.kernels import mla_decode as km
    from repro_torch.models import model as lm
    for name, dtype, per_step in (("deepseek-v3-671b", "bfloat16", 4),
                                  ("deepseek-v3-671b", "float32", 0),
                                  ("qwen3-1.7b", "bfloat16", 0)):
        cfg = get(name).reduced().with_policy(compute_dtype=dtype,
                                              param_dtype=dtype)
        params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
        toks = torch.randint(0, cfg.vocab_size, (2, 20), device=cuda)
        with torch.no_grad():
            lg, caches = lm.prefill(params, {"tokens": toks}, cfg, 24)
            before = km.launches
            pos = torch.full((2,), 20, device=cuda)
            lm.decode_step(params, lg.argmax(-1)[:, None], pos, caches, cfg)
        assert km.launches - before == per_step, (name, dtype)


def test_a_reduced_deepseek_server_serves_the_same_tokens_replayed(
        cuda, monkeypatch):
    """A reduced bf16 DeepSeek-V3 ``Server`` on the card, its decode steps
    replayed from their CUDA graphs with the MLA kernel launched between
    the pieces, serves the tokens it serves with every step eager; the
    kernel runs once a layer of every decode step either way."""
    from repro_torch.configs import get
    from repro_torch.kernels import mla_decode as km
    from repro_torch.models import decode_graph as dg
    from repro_torch.models import model as lm
    cfg = get("deepseek-v3-671b").reduced().with_policy(
        compute_dtype="bfloat16", param_dtype="bfloat16")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    served = []
    for graphs in (True, False):
        with monkeypatch.context() as mp:
            if not graphs:
                mp.setattr(dg, "engages", lambda ts: False)
            before, replays = km.launches, dg.replays
            srv = _mla_serve(cfg, params, cuda)
            assert km.launches - before == cfg.n_layers * srv.decode_steps
            assert (dg.replays - replays > 0) == graphs
        served.append({r.uid: r.out_tokens for r in srv.completed})
    assert served[0] == served[1] and len(served[0]) == 5


def test_mla_decode_records_one_launch_a_layer(cuda):
    """Under a span recorder every decode step of a reduced bf16
    DeepSeek-V3 carries one ``mla_decode`` record a layer, naming the
    slots, heads, widths and cache; a prefill carries none."""
    from repro_torch.configs import get
    from repro_torch.kernels import mla_decode as km
    from repro_torch.models import model as lm
    from repro_torch.obs import SpanRecorder
    cfg = get("deepseek-v3-671b").reduced().with_policy(
        compute_dtype="bfloat16", param_dtype="bfloat16")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    before = km.launches
    srv = _mla_serve(cfg, params, cuda, spans=SpanRecorder())
    recs = srv.spans.records()
    by_id = {s["id"]: s for s in recs["spans"]}
    mine = [ln for ln in recs["launches"] if ln["kernel"] == "mla_decode"]
    assert len(mine) == km.launches - before \
        == cfg.n_layers * srv.decode_steps > 0
    per = {}
    for ln in mine:
        at = by_id[ln["span"]]
        while at["name"] != "model.decode_step":
            assert at["name"] != "model.prefill"
            at = by_id[at["parent"]]
        per[at["id"]] = per.get(at["id"], 0) + 1
        m = cfg.mla
        assert (ln["b"], ln["h"], ln["r"], ln["rd"], ln["clen"],
                ln["in_bytes"]) == (3, cfg.n_heads, m.kv_lora_rank,
                                    m.qk_rope_dim, 48, 2)
    steps = [s for s in recs["spans"] if s["name"] == "model.decode_step"]
    assert len(steps) == srv.decode_steps
    assert all(per.get(s["id"]) == cfg.n_layers for s in steps)


# ---------------------------------------------------------------------------
# the PIM runtime: numerics on the card, bit for bit with the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("placement", ["row-striped", "2d-block",
                                       "balanced"])
@pytest.mark.parametrize("channels", [1, 2, 16])
def test_pim_gemm_on_the_card_is_bit_exact_with_the_cpu(cuda, channels,
                                                        placement):
    """quickstart's pim_gemm 256x192x96 (and a K-split GEMV under
    balanced) numeric on the card, against the port on the CPU: float16
    outputs equal bit for bit, reports and command traces equal."""
    import dataclasses

    import numpy as np
    from repro_torch.runtime import PIMRuntime, emit_trace
    rng = np.random.default_rng(channels)
    a = (rng.standard_normal((256, 192)) * 0.2).astype(np.float16)
    b = (rng.standard_normal((192, 96)) * 0.2).astype(np.float16)
    x = (rng.standard_normal(192) * 0.2).astype(np.float16)
    runs = []
    for device in ("cpu", cuda):
        rt = PIMRuntime(channels=channels, device=device)
        out, rep = rt.gemm(a, b, placement=placement)
        y, rep_v = rt.gemv(a[:128], x, placement=placement)
        assert out.device.type == torch.device(device).type
        runs.append((out.cpu(), y.cpu(), dataclasses.asdict(rep),
                     dataclasses.asdict(rep_v), emit_trace(rt.stack)))
    (o0, y0, *rest0), (o1, y1, *rest1) = runs
    assert o1.dtype == y1.dtype == torch.float16
    assert torch.equal(o0.view(torch.int16), o1.view(torch.int16))
    assert torch.equal(y0.view(torch.int16), y1.view(torch.int16))
    assert rest0 == rest1


def test_quickstart_on_the_card_prints_the_cpu_lines(cuda):
    """``repro_torch.quickstart.main()`` (the card by default) against
    ``main("cpu")``: every line ``==`` but the kernel line, which names
    K1's fma variant (f32 operands; ``main`` raises if K1 is not within
    the f32 TOL of ``ref.gemm``); one K1 launch, on fma."""
    import contextlib
    import io

    from repro_torch import quickstart

    def lines(device):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert quickstart.main(device) == 0
        return buf.getvalue().splitlines()
    before = dict(k1.launches_by_variant)
    card = lines(None)
    after = dict(k1.launches_by_variant)
    cpu = lines("cpu")
    assert {v: after[v] - before[v] for v in after} == {"mma": 0, "fma": 1}
    kernel = [i for i, line in enumerate(card) if line.startswith("ame_gemm (")]
    assert len(kernel) == 1
    line = card.pop(kernel[0])
    assert cpu.pop(kernel[0]).startswith("ame_gemm (plain version, CPU)")
    assert card == cpu and card[-1] == "quickstart OK"
    assert line.startswith("ame_gemm (hand-written CUDA kernel K1, fma ")


# ---------------------------------------------------------------------------
# the numeric decode offload: on the card, equal to the CPU
# ---------------------------------------------------------------------------

#: error maxima of a numeric StepRecord on the card against the CPU: both
#: hold the same FP16 PIM outputs against an FP32 reference summed in
#: another order (cuBLAS vs the CPU's, TF32 off), and the runtime's FP32
#: softmax may round a probability one FP16 ulp apart
OFFLOAD_ERR_TOL = 1e-5


def _uids_by_appearance(text):
    """``text`` with every ``uid=N`` renumbered by first appearance: tensor
    uids count per process, so two runs in one process label the same
    tensors with other numbers."""
    import re
    seen = {}
    return re.sub(r"uid=(\d+)", lambda m: "uid=%d" % seen.setdefault(
        m.group(1), len(seen)), text)


@pytest.mark.parametrize("async_mode", [False, True],
                         ids=["serialized", "async"])
def test_numeric_offload_on_the_card_matches_the_cpu(cuda, async_mode):
    """serve_lm's reduced qwen3 sidecar (numeric, KV offload, a channel
    kill) on the card and on the CPU: logits bit for bit, step records
    equal (error maxima within OFFLOAD_ERR_TOL and NUMERIC_ATOL), ledgers
    and command traces byte for byte, and the Chrome traces too once tensor
    uids are numbered by appearance."""
    import dataclasses
    import json

    from repro_torch.configs import get
    from repro_torch.obs import export_chrome_trace
    from repro_torch.runtime import emit_trace
    from repro_torch.serve.offload import NUMERIC_ATOL, DecodeOffload
    cfg = get("qwen3-1.7b").reduced().replace(
        n_layers=4, d_model=256, d_ff=512, vocab_size=1024)
    runs = []
    for device in ("cpu", cuda):
        off = DecodeOffload(cfg, channels=4, stacks=2, numeric=True,
                            kv_offload=True, async_mode=async_mode,
                            faults="kill channel 1 @ 30000", device=device)
        for rid, n in ((0, 20), (1, 140)):
            off.kv_prefill(rid, n)
        for _ in range(3):
            off.step(2, request_ids=[0, 1])
        assert off.last_logits.device.type == torch.device(device).type
        runs.append(dict(
            logits=off.last_logits.cpu(),
            steps=[dataclasses.asdict(s) for s in off.steps],
            xfer=[dataclasses.asdict(d.xfer) for d in off.rt.stack],
            trace=emit_trace(off.rt.stack),
            chrome=_uids_by_appearance(json.dumps(
                export_chrome_trace(off.rt))) if async_mode else None,
            faults=off.rt.faults.counters, kv=off.kv.summary()))
    cpu, card = runs
    assert torch.equal(cpu["logits"].view(torch.int16),
                       card["logits"].view(torch.int16))
    for a, b in zip(cpu["steps"], card["steps"]):
        for f in ("numeric_max_err", "logits_max_err", "attn_max_err"):
            assert b[f] < NUMERIC_ATOL
            assert abs(a.pop(f) - b.pop(f)) <= OFFLOAD_ERR_TOL, f
        assert a == b
    for key in ("xfer", "trace", "chrome", "faults", "kv"):
        assert cpu[key] == card[key], key
    assert card["faults"]["channel_failures"] == 1


# ---------------------------------------------------------------------------
# the MoE and MLA families on the card
# ---------------------------------------------------------------------------

#: (k, n) of the K1 calls of a mixtral-8x22b layer (q, k/v, o) and of a
#: deepseek-v3-671b layer (MLA's wdq, wuq, wdkv, wkr, wo; the dense MLP's
#: up/gate and down; the shared expert's up/gate and down)
MOE_KN = [(6144, 6144), (6144, 1024),
          (7168, 1536), (1536, 24576), (7168, 512), (7168, 64),
          (16384, 7168), (7168, 18432), (18432, 7168), (7168, 2048),
          (2048, 7168)]


@pytest.mark.parametrize("k,n", MOE_KN)
@pytest.mark.parametrize("m", [4, 64])
def test_mma_kernel_at_moe_shapes(cuda, m, k, n):
    """The MoE models' projections, as served in bf16, take the
    tensor-core variant and match the plain version."""
    a, b = _pair(m, k, n, torch.bfloat16, cuda, seed=k + n)
    assert k1.variant(a, b) == "mma"
    before = dict(k1.launches_by_variant)
    got = k1.ame_gemm(a, b)
    torch.cuda.synchronize()
    assert k1.launches_by_variant["mma"] == before["mma"] + 1
    torch.testing.assert_close(got.float(), ref.gemm(a, b).float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("name", ["mixtral-8x22b", "deepseek-v3-671b"])
def test_reduced_moe_models_kernel_vs_torch_on_the_card(cuda, name):
    """Reduced mixtral-8x22b and deepseek-v3-671b (f32) on the card: the
    kernel backend's prefill and four decode steps against the torch
    backend's on the same card and against the CPU's plain run, each K1
    call counted (32 and 32 a forward at their full-width depths; 16 and
    32 at reduced depth)."""
    from repro_torch.configs import get
    from repro_torch.models import model as lm
    cfg = get(name).reduced()
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    runs = {}
    for label, params, dev, be in (("cpu", cpu, "cpu", "torch"),
                                   ("torch", to(cpu, cuda), cuda, "torch"),
                                   ("kernel", to(cpu, cuda), cuda,
                                    "kernel")):
        before = k1.launches
        lg, c = lm.prefill(params, {"tokens": toks.to(dev)}, cfg, 20,
                           backend=be)
        seq = [lg.cpu()]
        pos = torch.full((2,), 12, device=dev)
        for _ in range(4):
            lg, c = lm.decode_step(params, seq[-1].argmax(-1).to(dev)[:, None],
                                   pos, c, cfg, backend=be)
            seq.append(lg.cpu())
            pos = pos + 1
        runs[label] = (torch.stack(seq), k1.launches - before)
    per_forward = {"mixtral-8x22b": 4 * cfg.n_layers,
                   "deepseek-v3-671b": 8 * cfg.n_layers}[name]
    assert runs["kernel"][1] == 5 * per_forward
    assert runs["torch"][1] == runs["cpu"][1] == 0
    for label in ("torch", "cpu"):
        torch.testing.assert_close(runs["kernel"][0], runs[label][0],
                                   atol=1e-4, rtol=1e-4)


def test_cluster_device_accessor_on_a_card_cluster(cuda):
    """``PIMCluster.device(stack, channel)`` on a cluster whose engines
    compute on the card is the device at those coordinates."""
    from repro_torch.runtime import PIMCluster
    cluster = PIMCluster(2, 4, device=cuda)
    assert cluster.torch_device.type == "cuda"
    for s in range(2):
        for c in range(4):
            dev = cluster.device(s, c)
            assert dev is cluster.stacks[s].devices[c]
            assert dev.channel_id == s * 4 + c
            assert dev.engine.device.type == "cuda"


# -- training on the card ------------------------------------------------------


def _train_setup(device, name="qwen3-1.7b"):
    """Reduced ``name`` (f32) with parameters requiring grad on ``device``,
    seeded on the CPU, and one SyntheticLM batch."""
    from repro_torch.configs import SHAPES, get
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.train.loop import trainable
    cfg = get(name).reduced()
    cpu = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = trainable(adamw.tree_map(lambda p: p.to(device), cpu))
    batch = SyntheticLM(cfg, SHAPES["train_4k"], seed=1, batch_override=2,
                        seq_override=32).batch(0)
    return cfg, params, batch


@pytest.mark.parametrize("name", ["qwen3-1.7b", "hubert-xlarge",
                                  "internvl2-76b", "mamba2-370m"])
def test_loss_and_grads_on_the_card_match_the_cpu(cuda, name):
    """``loss_fn`` (torch backend, f32, TF32 off) and every gradient on the
    card against the same on the CPU: only the order of sums differs."""
    from repro_torch.models import convert
    from repro_torch.models import model as lm
    from repro_torch.train.loop import batch_to, grad_tree
    out = {}
    for dev in ("cpu", cuda):
        cfg, params, batch = _train_setup(dev, name)
        loss, mets = lm.loss_fn(params, batch_to(batch, dev), cfg)
        out[str(dev)] = loss.detach().cpu(), {
            k: g.cpu() for k, g in convert.leaves(grad_tree(loss, params))}
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(lg, lc, atol=1e-5, rtol=1e-5)
    for path, g in gc.items():
        scale = float(g.abs().max()) + 1e-12
        assert float((gg[path] - g).abs().max()) <= 1e-4 * scale, path


def test_kernel_backend_refuses_a_gradient_on_the_card(cuda):
    """On CUDA tensors the kernel path would drop the gradient (its outputs
    are filled through ctypes): it raises, and under ``no_grad`` its loss
    is the torch backend's within the f32 tolerance."""
    from repro_torch.models import model as lm
    from repro_torch.train.loop import batch_to
    cfg, params, batch = _train_setup(cuda)
    b = batch_to(batch, cuda)
    before = k1.launches
    with pytest.raises(RuntimeError, match="forward-only"):
        lm.loss_fn(params, b, cfg, backend="kernel")
    assert k1.launches == before                 # refused before a launch
    with torch.no_grad():
        lk, _ = lm.loss_fn(params, b, cfg, backend="kernel")
        lt, _ = lm.loss_fn(params, b, cfg, backend="torch")
    assert k1.launches - before == 7 * cfg.n_layers
    torch.testing.assert_close(lk, lt, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("moment_dtype,factored", [("float32", False),
                                                   ("int8", False),
                                                   ("float32", True)])
def test_adamw_step_on_the_card_matches_the_cpu(cuda, moment_dtype,
                                                factored):
    from repro_torch.models import convert
    from repro_torch.optim import adamw
    c = adamw.AdamWConfig(warmup_steps=1, moment_dtype=moment_dtype,
                          factored_v=factored)
    g = torch.Generator().manual_seed(3)
    out = {}
    for dev in ("cpu", cuda):
        _, params, _ = _train_setup(dev)
        grads = adamw.tree_map(
            lambda p: (torch.randn(p.shape, generator=g) * 0.01).to(dev),
            params)
        g.manual_seed(3)
        params, state, m = adamw.apply(params, grads, adamw.init(params, c),
                                       c)
        out[str(dev)] = ({k: v.detach().cpu()
                          for k, v in convert.leaves(params)},
                         {k: v.cpu() for k, v in convert.leaves(state)}, m)
    (pc, sc, mc), (pg, sg, mg) = out["cpu"], out[str(cuda)]
    assert float(mg["lr"]) == float(mc["lr"])
    torch.testing.assert_close(mg["grad_norm"].cpu(), mc["grad_norm"],
                               rtol=1e-6, atol=0)
    for path in pc:
        torch.testing.assert_close(pg[path], pc[path], rtol=1e-6, atol=1e-7)
    for path in sc:
        if sc[path].dtype == torch.int8:       # a rounding edge may flip
            assert float((sg[path].float() - sc[path].float()).abs().max()) \
                <= 1, path
        else:
            torch.testing.assert_close(sg[path], sc[path], rtol=1e-5,
                                       atol=1e-9)


MESH_SCRIPT = """
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import ame_gemm as k1
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as lm
from repro_torch.sharding import rules
dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
dev = torch.device("cuda", 0)
mesh = make_debug_mesh((1, 1), device="cuda")
cfg = get("qwen3-1.7b").reduced().with_policy(compute_dtype="bfloat16")
pf, _, psp = steps.make_prefill_step(cfg, mesh, ShapeSpec("p", 24, 2, "prefill"),
                                     backend="kernel")
df, _, dsp = steps.make_decode_step(cfg, mesh, ShapeSpec("d", 24, 2, "decode"),
                                    backend="kernel")
gen = torch.Generator(device=dev).manual_seed(0)
params = lm.compute_params(lm.init(cfg, gen, device=dev), cfg)
dp = rules.distribute(params, psp[0], mesh)
tok = torch.randint(0, cfg.vocab_size, (2, 16), device=dev, generator=gen)
with torch.no_grad():
    want, caches = lm.prefill(params, {"tokens": tok}, cfg, cache_len=24,
                              backend="kernel")
k1.launches = 0
got, dc = pf(dp, rules.distribute({"tokens": tok}, psp[1], mesh))
torch.cuda.synchronize()
assert k1.launches == 7 * cfg.n_layers, k1.launches
assert isinstance(got, DTensor) and torch.equal(got.full_tensor(), want)
nt = want.argmax(-1)
# both steps attend with the decode kernel, the sharded one on its DTensor
# caches' local shards: one launch a layer each
from repro_torch.kernels import decode_attention as kd
# the unsharded step captures its CUDA graphs in its second call and
# replays them after; the sharded one (DTensors) runs eagerly every time
from repro_torch.models import decode_graph as dg
counts = (dg.eager, dg.captures, dg.replays)
for i in range(6):
    pos = torch.full((2,), 16 + i, dtype=torch.long, device=dev)
    before = kd.launches
    with torch.no_grad():
        want, caches = lm.decode_step(params, nt[:, None], pos, caches, cfg,
                                      backend="kernel")
    assert kd.launches - before == cfg.n_layers, kd.launches - before
    got, dc = df(dp, rules.distribute(nt[:, None], dsp[1], mesh),
                 rules.distribute(pos, dsp[2], mesh), dc)
    torch.cuda.synchronize()
    assert kd.launches - before == 2 * cfg.n_layers, kd.launches - before
    assert torch.equal(got.full_tensor(), want), i
    nt = want.argmax(-1)
rise = tuple(a - b for a, b in zip((dg.eager, dg.captures, dg.replays),
                                   counts))
assert rise == (1 + 6, 1, 4), rise
dist.destroy_process_group()
print("mesh OK")
"""


def test_sharded_serve_on_a_one_card_mesh_equals_the_unsharded(cuda):
    """A 1-rank nccl world and a 1x1 mesh (its own process: a process
    group is global to its process): the sharded prefill launches K1 once
    per projection, and its logits and 6 decode steps' are ``torch.equal``
    to the unsharded serve's (the same kernels at the same shapes; both
    decodes launch the decode attention kernel once a layer, the sharded
    one on its caches' local shards); the unsharded decode captures its
    CUDA graphs in its second step and replays them after, the sharded
    one stays eager."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", MESH_SCRIPT], cwd=root,
                       env=dict(os.environ, PYTHONPATH=str(root / "src")),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and "mesh OK" in r.stdout, r.stderr[-3000:]


# ---------------------------------------------------------------------------
# the serve path's span recorder on the card
# ---------------------------------------------------------------------------


def test_span_recorder_records_every_k1_launch_on_the_card(cuda):
    """A reduced bf16 qwen3 served on the card with ``Server(spans=...)``
    and without: the same tokens; the K1 records equal the rise in
    ``ame_gemm.launches``, 7 a layer under each ``model.decode_step`` and
    ``model.prefill``, each under its block's span, or directly under a
    decode step run from its CUDA graphs (``graph`` noted), every launch
    on ``mma``; no recorder is active afterwards."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.models import model as lm
    from repro_torch.obs import SpanRecorder, spans
    from repro_torch.serve.loop import Request, Server
    cfg = get("qwen3-1.7b").reduced().with_policy(compute_dtype="bfloat16")
    params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0),
                     device=cuda)
    runs = []
    for rec in (None, SpanRecorder()):
        srv = Server(cfg, params, slots=3, cache_len=48, backend="kernel",
                     device=cuda, spans=rec)
        rng = np.random.default_rng(0)
        for uid in range(5):
            srv.submit(Request(uid=uid, prompt=rng.integers(
                0, cfg.vocab_size, 6 + 4 * uid).astype(np.int32), max_new=5))
        before, mma = k1.launches, k1.launches_by_variant["mma"]
        srv.run_until_drained()
        runs.append(({r.uid: r.out_tokens for r in srv.completed},
                     k1.launches - before, srv))
        assert k1.launches_by_variant["mma"] - mma == runs[-1][1]
    (off, rise_off, _), (on, rise_on, srv) = runs
    assert on == off and rise_on == rise_off
    assert spans.ACTIVE is None
    recs = srv.spans.records()
    by_id = {s["id"]: s for s in recs["spans"]}
    k1s = [ln for ln in recs["launches"] if ln["kernel"] == "k1"]
    assert len(k1s) == rise_on
    per = {}
    for ln in k1s:
        span = by_id[ln["span"]]
        assert ln["in_bytes"] == 2
        if span["name"] == "model.decode_step":
            assert span["attrs"]["graph"] in ("capture", "replay")
            top = span
        else:
            assert span["name"] in ("model.attention", "model.mlp")
            top = by_id[span["parent"]]
        per[top["id"]] = per.get(top["id"], 0) + 1
    tops = [s for s in recs["spans"]
            if s["name"] in ("model.decode_step", "model.prefill")]
    assert len(tops) == srv.decode_steps + srv.prefills
    assert all(per[s["id"]] == 7 * cfg.n_layers for s in tops)


def test_deepseek_v3_at_published_widths_serves_within_the_cell_limits(cuda):
    """The benchmark's DeepSeek-V3 configuration at its published widths,
    cut to its 3 dense layers and 1 MoE layer (8 of 256 experts held):
    four requests prefill and decode through the latent cache on the
    kernel backend, and every served token's gap to the plain reference
    (``portbench/reference/mla_moe.py``, f32) stays within the limits of
    the cell ``deepseek-v3.chat-64``; every expert product ran on K1."""
    import json
    import sys
    from pathlib import Path

    import numpy as np
    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from portbench import check, port, weights
    cfg = json.loads((root / "portbench" / "configs" / "deepseek-v3.json")
                     .read_text())
    lim = json.loads((root / "portbench" / "cells"
                      / "deepseek-v3.chat-64.json").read_text())["at_most"]
    cfg["n_layers"] = 4
    a = port.arch(cfg)
    w = weights.make(port.meta_params(a), 2718281829, cuda)
    srv = port.server(a, w, dict(slots=4, cache_len=512), cuda)
    rng = np.random.default_rng(1)
    for uid, n in enumerate((37, 180, 64, 300)):
        srv.submit(port.request(uid, rng.integers(
            0, cfg["vocab_size"], n).astype(np.int32), 8))
    before = k1.launches_by_variant["mma"]
    done = srv.run_until_drained()
    launched = k1.launches_by_variant["mma"] - before
    del srv
    torch.cuda.empty_cache()
    assert sorted(len(r.out_tokens) for r in done) == [8] * 4
    # per decode step: 5 MLA products a layer, 3 a dense MLP, the shared
    # expert's 3 and 3 for each of the 8 held experts
    assert launched >= 7 * (4 * 5 + 3 * 3 + 3 + 8 * 3)
    got = check.gaps(w, cfg, done, [], cuda)
    for k, v in lim.items():
        assert got[k] <= v, (k, got[k], v)
    assert got["compared"] == 32
