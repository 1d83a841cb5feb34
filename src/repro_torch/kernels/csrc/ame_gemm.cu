// ame_gemm — reduction-free, output-stationary GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ame_gemm.py:_gemm_kernel
// (pallas_call at ame_gemm.py:78): C = A(m,k) @ B(k,n), f32 accumulation
// resident for the whole K walk, one cast to the output type at the end.
//
// Design.  Each thread block owns one BM x BN output tile and walks all of
// K in a loop inside the block (the TPU's sequential K grid axis becomes
// that loop), staging BM x BK tiles of A and BK x BN tiles of B through
// shared memory.  The f32 accumulator lives in registers for the whole walk
// and is stored once: no split-K, no partial sums in device memory — the
// paper's MAC-PEP dataflow.  Ragged edges are masked in the kernel (loads
// read zero past the edge, which is exact for a product; stores are
// skipped), so any m, n, k >= 1 is accepted without padding copies.
//
// Bound on this card.  At serving batch (m = live slots or prompt tokens)
// the work is bandwidth-bound: every weight byte is read once per call and
// each is used only m times.  This first version is a simple CUDA-core
// kernel (FP32 FMA; f32 inputs never touch TF32): it reads B once per
// M-tile with no cp.async/TMA pipeline and no tensor cores.  wgmma, TMA and
// a deeper pipeline are later work.
//
// C interface (bound with ctypes):
//   int ame_gemm(a, b, c, m, n, k, in_dtype, out_dtype,
//                block_m, block_n, block_k, stream)
// dtype codes: 0 float32, 1 bfloat16, 2 float16.  Returns the
// cudaGetLastError() value right after the launch (0 on success), or
// cudaErrorInvalidValue for an unsupported dtype or block configuration.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid over the output tile

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

// Thread (ty, tx) owns rows ty + 16*i and columns tx + 16*j of the tile, so
// a warp's shared-memory reads of B and its global stores of C fall on
// consecutive columns, and its reads of A are broadcasts.
template <int BM, int BN, int BK, typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
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
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int r = idx / BK, col = idx % BK;
      const int gm = m0 + r, gk = k0 + col;
      sa[r][col] = (gm < m && gk < k) ? a[static_cast<size_t>(gm) * k + gk] : zero;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
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
cudaError_t launch(const void* a, const void* b, void* c, int m, int n, int k,
                   cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  ame_gemm_kernel<BM, BN, BK, TI, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const TI*>(a), static_cast<const TI*>(b), static_cast<TO*>(c), m, n, k);
  return cudaGetLastError();
}

template <int BM, int BN, int BK, typename TI>
cudaError_t by_out(int out_dtype, const void* a, const void* b, void* c, int m, int n,
                   int k, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return launch<BM, BN, BK, TI, float>(a, b, c, m, n, k, stream);
    case 1: return launch<BM, BN, BK, TI, __nv_bfloat16>(a, b, c, m, n, k, stream);
    case 2: return launch<BM, BN, BK, TI, __half>(a, b, c, m, n, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int BM, int BN, int BK>
cudaError_t by_in(int in_dtype, int out_dtype, const void* a, const void* b, void* c,
                  int m, int n, int k, cudaStream_t stream) {
  switch (in_dtype) {
    case 0: return by_out<BM, BN, BK, float>(out_dtype, a, b, c, m, n, k, stream);
    case 1: return by_out<BM, BN, BK, __nv_bfloat16>(out_dtype, a, b, c, m, n, k, stream);
    case 2: return by_out<BM, BN, BK, __half>(out_dtype, a, b, c, m, n, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The block configurations compiled in; kernels/ame_gemm.py:BLOCKS lists
// the same three.
extern "C" int ame_gemm(const void* a, const void* b, void* c, int m, int n, int k,
                        int in_dtype, int out_dtype, int block_m, int block_n,
                        int block_k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (block_m == 64 && block_n == 64 && block_k == 32) {
    err = by_in<64, 64, 32>(in_dtype, out_dtype, a, b, c, m, n, k, s);
  } else if (block_m == 32 && block_n == 32 && block_k == 32) {
    err = by_in<32, 32, 32>(in_dtype, out_dtype, a, b, c, m, n, k, s);
  } else if (block_m == 16 && block_n == 16 && block_k == 64) {
    err = by_in<16, 16, 64>(in_dtype, out_dtype, a, b, c, m, n, k, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
