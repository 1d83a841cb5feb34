// ame_gemm — reduction-free, output-stationary GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ame_gemm.py:_gemm_kernel
// (pallas_call at ame_gemm.py:78): C = A(m,k) @ B(k,n), f32 accumulation
// resident for the whole K walk, one cast to the output type at the end.
//
// Two variants, chosen by the wrapper (kernels/ame_gemm.py:variant) from
// dtype, shape and alignment before the launch:
//
// "mma" — bf16 / f16 operands whose rows start on 16 bytes (n and k
// multiples of 8, 16-byte aligned pointers): every shape of the serving
// paths.  At serving batch (m = live slots or prompt tokens, 1..300) every
// shape is at or below the card's balance of ~295 FLOP per byte, because
// each weight byte is used only m times: the bound is reading B once.  So
// the design is for bandwidth:
//   * Narrow N tiles (8..64 columns) so the serving shapes put 64 to 400
//     blocks on the 132 SMs; the wrapper picks the tile from (m, n).
//   * A and B arrive through a ring of 3-6 stages of 16-byte cp.async
//     copies (20-60 KB in flight per block).  Rows of A past m are zeroed
//     once and never copied (exact for a product); K and N edges are
//     zero-filled by the copy.
//   * The math is mma.sync.m16n8k16 on bf16 / f16 with f32 accumulators in
//     registers: A fragments by ldmatrix, B (row-major (K, N)) by
//     ldmatrix.trans.  Tensor cores only keep arithmetic from ever being
//     the limit (at m = 64, f32 FMA would cap at a third of the bytes
//     rate).  No wgmma: no main-path shape is compute-bound; wgmma's
//     64-row warpgroup tiles would pay only from m of about 300 up.
//   * Output-stationary: a block owns its BM x BN outputs for the whole K
//     walk.  Its 4 warps split the tile's rows and columns (prefill tiles)
//     or each stage's K rows (decode tiles, 16 rows, where there is nothing
//     else to split); K-split partial tiles are summed once in shared
//     memory before the single store of each output element.  No partial
//     sum goes to device memory — no split-K across blocks, no atomics —
//     so the paper's reduction-free MAC-PEP dataflow holds at block level.
//   * What holds it back: a strip of B 16-32 bytes wide streams through
//     cp.async more slowly than whole rows do, and every block copies its
//     own A rows; a split-K kernel, which reads whole rows of B, is faster
//     at decode (PERF.md has both times).
// "fma" — the general kernel: f32 operands (FP32 FMA, never TF32) and any
// shape or alignment the mma variant cannot copy in 16-byte pieces.  Each
// block owns one BM x BN tile, stages A and B through shared memory
// element by element and walks all of K with the f32 accumulator in
// registers; edges are masked, so any m, n, k >= 1 is accepted.
//
// C interface (bound with ctypes):
//   int ame_gemm(a, b, c, m, n, k, in_dtype, out_dtype,
//                block_m, block_n, block_k, stream)       — the fma variant
//   int ame_gemm_mma(a, b, c, m, n, k, in_dtype, out_dtype,
//                    block_m, block_n, block_k, stream)   — the mma variant
//   int ame_gemm_mma_smem_bytes(block_m, block_n, block_k) — its dynamic
//     shared memory (0 for a block that is not compiled in)
// dtype codes: 0 float32, 1 bfloat16, 2 float16.  A launch returns the
// cudaGetLastError() value right after it (0 on success), or
// cudaErrorInvalidValue for an unsupported dtype or block configuration.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// ---------------------------------------------------------------------------
// fma: the general kernel
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;  // a 16 x 16 thread grid over the output tile

// Thread (ty, tx) owns rows ty + 16*i and columns tx + 16*j of the tile, so
// a warp's shared-memory reads of B and its global stores of C fall on
// consecutive columns, and its reads of A are broadcasts.
template <int BM, int BN, int BK, typename TI, typename TO>
__global__ void __launch_bounds__(kFmaThreads)
ame_gemm_kernel(const TI* __restrict__ a, const TI* __restrict__ b,
                TO* __restrict__ c, int m, int n, int k) {
  static_assert(BM % 16 == 0 && BN % 16 == 0, "tile must split over 16 x 16 threads");
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  __shared__ TI sa[BM][BK];
  __shared__ TI sb[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const TI zero = from_f32<TI>(0.0f);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += kFmaThreads) {
      const int r = idx / BK, col = idx % BK;
      const int gm = m0 + r, gk = k0 + col;
      sa[r][col] = (gm < m && gk < k) ? a[static_cast<size_t>(gm) * k + gk] : zero;
    }
    for (int idx = tid; idx < BK * BN; idx += kFmaThreads) {
      const int r = idx / BN, col = idx % BN;
      const int gk = k0 + r, gn = n0 + col;
      sb[r][col] = (gk < k && gn < n) ? b[static_cast<size_t>(gk) * n + gn] : zero;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = to_f32(sa[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = to_f32(sb[kk][tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n) c[static_cast<size_t>(gm) * n + gn] = from_f32<TO>(acc[i][j]);
    }
  }
}

template <int BM, int BN, int BK, typename TI, typename TO>
cudaError_t launch_fma(const void* a, const void* b, void* c, int m, int n, int k,
                       cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  ame_gemm_kernel<BM, BN, BK, TI, TO><<<grid, kFmaThreads, 0, stream>>>(
      static_cast<const TI*>(a), static_cast<const TI*>(b), static_cast<TO*>(c), m, n, k);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, typename TI>
cudaError_t fma_by_out(int out_dtype, const void* a, const void* b, void* c, int m, int n,
                       int k, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return launch_fma<BM, BN, BK, TI, float>(a, b, c, m, n, k, stream);
    case 1: return launch_fma<BM, BN, BK, TI, __nv_bfloat16>(a, b, c, m, n, k, stream);
    case 2: return launch_fma<BM, BN, BK, TI, __half>(a, b, c, m, n, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int BM, int BN, int BK>
cudaError_t fma_by_in(int in_dtype, int out_dtype, const void* a, const void* b, void* c,
                      int m, int n, int k, cudaStream_t stream) {
  switch (in_dtype) {
    case 0: return fma_by_out<BM, BN, BK, float>(out_dtype, a, b, c, m, n, k, stream);
    case 1: return fma_by_out<BM, BN, BK, __nv_bfloat16>(out_dtype, a, b, c, m, n, k, stream);
    case 2: return fma_by_out<BM, BN, BK, __half>(out_dtype, a, b, c, m, n, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// mma: the tensor-core kernel for bf16 / f16
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;  // a WM x WN x WK grid of warps per block
constexpr int kMmaThreads = 32 * kMmaWarps;

// Shared-memory layout of one ring stage, in elements: A as BM rows of
// BK + 8 (the 16-byte pad puts the 8 rows of an ldmatrix on 8 different
// bank groups), then B as BN / 8 column groups of BK rows x 8 (each row of
// a group is 16 contiguous bytes, so ldmatrix.trans reads 128 contiguous
// bytes).  After the walk the ring is reused for the WK partial f32 tiles.
template <int BM, int BN, int BK, int STAGES, int WK> struct MmaTile {
  static constexpr int kLda = BK + 8;
  static constexpr int kA = BM * kLda;
  static constexpr int kStage = kA + BK * BN;
  static constexpr size_t kRing = static_cast<size_t>(STAGES) * kStage * 2;
  static constexpr size_t kReduce = static_cast<size_t>(WK) * BM * BN * 4;
  static constexpr size_t kSmem = kRing > kReduce ? kRing : kReduce;
};

__device__ __forceinline__ void store_out(void* c, size_t at, float x, int out_dtype) {
  switch (out_dtype) {
    case 0: static_cast<float*>(c)[at] = x; break;
    case 1: static_cast<__nv_bfloat16*>(c)[at] = __float2bfloat16_rn(x); break;
    default: static_cast<__half*>(c)[at] = __float2half_rn(x); break;
  }
}

// The 4 warps of a block form a WM x WN x WK grid: a warp owns rows
// (BM / WM), columns (BN / WN) and one WK-th of each stage's k16 steps.
// Decode tiles (BM = 16) split K 4 ways; prefill tiles split M and N.
//
// Precision: the tensor core adds the products of one mma into its f32
// accumulator with truncation, not round-to-nearest, so a long chain of
// mmas drifts from the exact sum, and more bf16 outputs round the other
// way than with f32 FMA.  Each warp therefore sums one stage's k16 steps
// in a fresh fragment and adds that to its accumulator with an ordinary
// f32 add, once per stage.
template <int BM, int BN, int BK, int STAGES, int WM, int WN, typename T>
__global__ void __launch_bounds__(kMmaThreads)
ame_gemm_mma_kernel(const T* __restrict__ a, const T* __restrict__ b, void* __restrict__ c,
                    int m, int n, int k, int out_dtype) {
  constexpr int WK = kMmaWarps / (WM * WN);
  using L = MmaTile<BM, BN, BK, STAGES, WK>;
  static_assert(WM * WN * WK == kMmaWarps, "4 warps");
  static_assert(BM % (16 * WM) == 0 && BN % (8 * WN) == 0, "m16n8 fragments");
  static_assert(BK % (16 * WK) == 0, "each warp takes whole k16 steps of a stage");
  constexpr int MF = BM / WM / 16;              // m16 fragments per warp
  constexpr int NF = BN / WN / 8;               // n8 fragments per warp
  constexpr int KW = BK / 16 / WK;              // k16 steps per warp per stage
  constexpr int ACH = BK / 8;                   // 16-byte chunks of an A row
  constexpr int BCH = BN / 8;                   // 16-byte chunks of a B row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % WM, wn = (warp / WM) % WN, wk = warp / (WM * WN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int rows = min(BM, m - m0);             // live rows of A in this tile
  const int nk = (k + BK - 1) / BK;

  // rows of A past m are never copied: zero them once in every stage
  if (rows < BM) {
    for (int s = 0; s < STAGES; ++s) {
      uint4* pa = reinterpret_cast<uint4*>(smem + s * L::kStage + rows * L::kLda);
      const int chunks = (BM - rows) * L::kLda / 8;
      for (int i = tid; i < chunks; i += kMmaThreads) pa[i] = make_uint4(0, 0, 0, 0);
    }
  }

  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * BK;
    T* sa = smem + slot * L::kStage;
    T* sb = sa + L::kA;
    for (int i = tid; i < rows * ACH; i += kMmaThreads) {
      const int r = i / ACH, ch = i % ACH;
      const int gk = k0 + ch * 8;
      const bool in = gk < k;
      const T* src = a + (static_cast<size_t>(m0 + r) * k + (in ? gk : 0));
      cp_async16(smem_addr(sa + r * L::kLda + ch * 8), src, in);
    }
    for (int i = tid; i < BK * BCH; i += kMmaThreads) {
      const int r = i / BCH, gr = i % BCH;
      const int gk = k0 + r, gn = n0 + gr * 8;
      const bool in = gk < k && gn < n;
      const T* src = b + (in ? static_cast<size_t>(gk) * n + gn : 0);
      cp_async16(smem_addr(sb + (gr * BK + r) * 8), src, in);
    }
  };

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1's slot is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const T* sa = smem + (kt % STAGES) * L::kStage + wm * MF * 16 * L::kLda;
    const T* sb = smem + (kt % STAGES) * L::kStage + L::kA + wn * NF * BK * 8;
    float part[MF][NF][4];
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KW; ++ks) {
      const int kk = (wk * KW + ks) * 16;       // this warp's k16 step
      uint32_t bf[NF][2];
#pragma unroll
      for (int j = 0; j < NF; ++j)
        ldmatrix_x2_trans(bf[j], smem_addr(sb + (j * BK + kk + lane % 16) * 8));
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_addr(sa + (i * 16 + lane % 16) * L::kLda + kk + (lane / 16) * 8));
#pragma unroll
        for (int j = 0; j < NF; ++j) Mma<T>::run(part[i][j], af, bf[j][0], bf[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the partial tiles

  // thread (g, t) of a warp holds rows g and g + 8, columns 2t and 2t + 1
  // of each m16n8 fragment
  float* red = reinterpret_cast<float*>(smem_raw);
  float* mine = red + wk * BM * BN;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int r = (wm * MF + i) * 16 + g, col = (wn * NF + j) * 8 + 2 * t;
      mine[r * BN + col] = acc[i][j][0];
      mine[r * BN + col + 1] = acc[i][j][1];
      mine[(r + 8) * BN + col] = acc[i][j][2];
      mine[(r + 8) * BN + col + 1] = acc[i][j][3];
    }
  __syncthreads();
  for (int idx = tid; idx < rows * BN; idx += kMmaThreads) {
    const int r = idx / BN, col = idx % BN;
    const int gn = n0 + col;
    if (gn >= n) continue;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < WK; ++w) sum += red[w * BM * BN + idx];
    store_out(c, static_cast<size_t>(m0 + r) * n + gn, sum, out_dtype);
  }
}

template <int BM, int BN, int BK, int STAGES, int WM, int WN, typename T>
cudaError_t launch_mma(const void* a, const void* b, void* c, int m, int n, int k,
                       int out_dtype, cudaStream_t stream) {
  static unsigned done = 0;
  constexpr size_t smem = MmaTile<BM, BN, BK, STAGES, kMmaWarps / (WM * WN)>::kSmem;
  auto kernel = ame_gemm_mma_kernel<BM, BN, BK, STAGES, WM, WN, T>;
  const cudaError_t err = allow_smem(kernel, smem, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  kernel<<<grid, kMmaThreads, smem, stream>>>(static_cast<const T*>(a),
                                              static_cast<const T*>(b), c, m, n, k, out_dtype);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, int STAGES, int WM, int WN>
cudaError_t mma_by_in(int in_dtype, int out_dtype, const void* a, const void* b, void* c,
                      int m, int n, int k, cudaStream_t s) {
  if (out_dtype < 0 || out_dtype > 2) return cudaErrorInvalidValue;
  switch (in_dtype) {
    case 1:
      return launch_mma<BM, BN, BK, STAGES, WM, WN, __nv_bfloat16>(a, b, c, m, n, k, out_dtype,
                                                                     s);
    case 2: return launch_mma<BM, BN, BK, STAGES, WM, WN, __half>(a, b, c, m, n, k, out_dtype, s);
    default: return cudaErrorInvalidValue;
  }
}

// The mma blocks compiled in (kernels/ame_gemm.py:MMA_BLOCKS lists the same
// ones), each with its ring depth and warp grid WM x WN (WK = 4 / (WM WN)).
#define AME_MMA_BLOCKS(X)   \
  X(16, 8, 256, 6, 1, 1)    \
  X(16, 16, 256, 4, 1, 1)   \
  X(64, 16, 128, 4, 2, 2)   \
  X(64, 64, 64, 4, 2, 2)    \
  X(128, 32, 64, 4, 4, 1)   \
  X(128, 64, 64, 3, 2, 2)

}  // namespace

// The fma blocks compiled in; kernels/ame_gemm.py:BLOCKS lists the same
// three.
extern "C" int ame_gemm(const void* a, const void* b, void* c, int m, int n, int k,
                        int in_dtype, int out_dtype, int block_m, int block_n,
                        int block_k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (block_m == 64 && block_n == 64 && block_k == 32) {
    err = fma_by_in<64, 64, 32>(in_dtype, out_dtype, a, b, c, m, n, k, s);
  } else if (block_m == 32 && block_n == 32 && block_k == 32) {
    err = fma_by_in<32, 32, 32>(in_dtype, out_dtype, a, b, c, m, n, k, s);
  } else if (block_m == 16 && block_n == 16 && block_k == 64) {
    err = fma_by_in<16, 16, 64>(in_dtype, out_dtype, a, b, c, m, n, k, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int ame_gemm_mma(const void* a, const void* b, void* c, int m, int n, int k,
                            int in_dtype, int out_dtype, int block_m, int block_n,
                            int block_k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AME_MMA_CASE(BM, BN, BK, ST, WM, WN)                                  \
  if (block_m == BM && block_n == BN && block_k == BK)                        \
    return static_cast<int>(                                                  \
        mma_by_in<BM, BN, BK, ST, WM, WN>(in_dtype, out_dtype, a, b, c, m, n, k, s));
  AME_MMA_BLOCKS(AME_MMA_CASE)
#undef AME_MMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ame_gemm_mma_smem_bytes(int block_m, int block_n, int block_k) {
#define AME_MMA_SMEM(BM, BN, BK, ST, WM, WN)                                 \
  if (block_m == BM && block_n == BN && block_k == BK)                       \
    return static_cast<int>(MmaTile<BM, BN, BK, ST, kMmaWarps / (WM * WN)>::kSmem);
  AME_MMA_BLOCKS(AME_MMA_SMEM)
#undef AME_MMA_SMEM
  return 0;
}
