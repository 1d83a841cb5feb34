// ssd_scan — Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py:_ssd_kernel
// (pallas_call at ssd_scan.py:170).  Per row (one batch x head) and chunk
// of L steps, with cum the inclusive prefix sum of log_a inside the chunk:
//
//   y_chunk = (C * exp(cum)) @ S  +  tril((C @ B^T) * exp(cum_i - cum_j)) @ X
//   S       = exp(cum_L) * S      +  (B * exp(cum_L - cum))^T @ X
//
// with the (N, P) f32 state S resident on chip for the whole time walk —
// the rank-1 outer-product accumulation of the paper's dataflow.
//
// Design.  The TPU grid (BH, T/L) walks the chunk axis in order and keeps S
// in VMEM scratch across grid steps; Hopper blocks run in no order, so one
// block walks every chunk of its row in a loop with S in shared memory,
// zeroed inside the block.  S's columns are independent (y[:, p] needs only
// S[:, p] and X[:, p]), so the grid is (BH, ceil(P / kBlockP)): each block
// owns kBlockP = 16 columns of S and y and recomputes the (L, L) score block
// G.  That keeps shared memory under the 227 KB a block may use at L = 128,
// N = 128 (S 8 KiB, X 8 KiB, B and C 2 x 64.5 KiB, G 64.5 KiB, all f32), and
// puts 4x more blocks on the card (a one-sequence prefill has BH = 32).
// The chunk length L = min(chunk, T) is a runtime value; rows of the last
// chunk past T are staged as log_a = 0, b = c = x = 0, which is exactly the
// reference's neutral padding, and their outputs are not stored.  Scores
// with j > i are skipped before exp (cum_i - cum_j > 0 there).  All sums and
// the prefix sum are f32 with expf (not __expf).
//
// Bound on this card.  The function needs about 5 N P f32 FLOPs per row
// and step (the recurrence: decay S, add b x^T, read out c S; the causal
// half of the chunked form costs about as much); at the serving shapes
// (BH 32, T <= 2048, P 64, N 128) that is above the bytes term at the f32
// CUDA-core rate, so the bound is operations.  This kernel computes the
// whole causal score block in every one of a row's P / kBlockP blocks.
// This first version is a plain CUDA-core kernel: every
// product reads both operands from shared memory (row strides padded by one
// float so a warp's column reads hit 32 banks) and no tensor cores.
// Register tiling and mma.sync / wgmma for C B^T, G X and B^T X are later
// work.
//
// C interface (bound with ctypes):
//   int ssd_scan(x, log_a, b, c, y, bh, t, p, n, l, x_dtype, bc_dtype, stream)
//     x, y (bh, t, p) in x_dtype; log_a (bh, t) f32; b, c (bh, t, n) in
//     bc_dtype; dtype codes 0 float32, 1 bfloat16.  Returns the
//     cudaGetLastError() value right after the launch (0 on success), or
//     cudaErrorInvalidValue for an unsupported dtype or shape.
//   int ssd_scan_smem_bytes(l, n) — the dynamic shared memory of one block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockP = 16;  // columns of S and y owned by one block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// S (N, BP), X (L, BP), B and C (L, N+1), G (L, L+1), cum (L), w (L)
size_t smem_floats(int l, int n) {
  const size_t L = l, N = n;
  return N * kBlockP + L * kBlockP + 2 * L * (N + 1) + L * (L + 1) + 2 * L;
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ log_a,
                const TB* __restrict__ b, const TB* __restrict__ c,
                TX* __restrict__ y, int t, int p, int n, int l) {
  extern __shared__ float smem[];
  const int ldb = n + 1;  // padded row strides: no bank conflicts on columns
  const int ldg = l + 1;
  float* s_state = smem;                 // (N, BP)
  float* s_x = s_state + n * kBlockP;    // (L, BP)
  float* s_b = s_x + l * kBlockP;        // (L, N+1)
  float* s_c = s_b + l * ldb;            // (L, N+1)
  float* s_g = s_c + l * ldb;            // (L, L+1), lower triangle used
  float* s_cum = s_g + l * ldg;          // (L)
  float* s_w = s_cum + l;                // (L)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.y * kBlockP;
  const size_t xrow = static_cast<size_t>(blockIdx.x) * t * p;
  const size_t brow = static_cast<size_t>(blockIdx.x) * t * n;
  const size_t arow = static_cast<size_t>(blockIdx.x) * t;

  for (int e = tid; e < n * kBlockP; e += kThreads) s_state[e] = 0.0f;

  for (int t0 = 0; t0 < t; t0 += l) {
    // 1. stage the chunk in f32; rows past T are the neutral padding
    for (int e = tid; e < l * kBlockP; e += kThreads) {
      const int gt = t0 + e / kBlockP, gp = p0 + e % kBlockP;
      s_x[e] = (gt < t && gp < p) ? to_f32(x[xrow + static_cast<size_t>(gt) * p + gp]) : 0.0f;
    }
    for (int e = tid; e < l * n; e += kThreads) {
      const int r = e / n, k = e % n, gt = t0 + r;
      const size_t at = brow + static_cast<size_t>(gt) * n + k;
      s_b[r * ldb + k] = gt < t ? to_f32(b[at]) : 0.0f;
      s_c[r * ldb + k] = gt < t ? to_f32(c[at]) : 0.0f;
    }
    for (int i = tid; i < l; i += kThreads) s_cum[i] = t0 + i < t ? log_a[arow + t0 + i] : 0.0f;
    __syncthreads();

    // 2. inclusive prefix sum of the log decay, in time order
    if (tid == 0) {
      float acc = 0.0f;
      for (int i = 0; i < l; ++i) {
        acc += s_cum[i];
        s_cum[i] = acc;
      }
    }
    __syncthreads();

    // 3. state weights w_j = exp(cum_L - cum_j) and the causal score block
    const float cum_last = s_cum[l - 1];
    for (int i = tid; i < l; i += kThreads) s_w[i] = expf(cum_last - s_cum[i]);
    for (int e = tid; e < l * l; e += kThreads) {
      const int i = e / l, j = e % l;
      if (j > i) continue;  // masked before exp
      const float* ci = s_c + i * ldb;
      const float* bj = s_b + j * ldb;
      float dot = 0.0f;
      for (int k = 0; k < n; ++k) dot = fmaf(ci[k], bj[k], dot);
      s_g[i * ldg + j] = dot * expf(s_cum[i] - s_cum[j]);
    }
    __syncthreads();

    // 4. y_i = exp(cum_i) (c_i @ S) + sum_{j <= i} G[i][j] x_j
    for (int e = tid; e < l * kBlockP; e += kThreads) {
      const int i = e / kBlockP, col = e % kBlockP;
      const int gt = t0 + i, gp = p0 + col;
      if (gt >= t || gp >= p) continue;
      const float* ci = s_c + i * ldb;
      float inter = 0.0f;
      for (int k = 0; k < n; ++k) inter = fmaf(ci[k], s_state[k * kBlockP + col], inter);
      const float* gi = s_g + i * ldg;
      float intra = 0.0f;
      for (int j = 0; j <= i; ++j) intra = fmaf(gi[j], s_x[j * kBlockP + col], intra);
      y[xrow + static_cast<size_t>(gt) * p + gp] = from_f32<TX>(fmaf(expf(s_cum[i]), inter, intra));
    }
    __syncthreads();

    // 5. S = exp(cum_L) S + sum_j (w_j b_j) (outer) x_j
    const float decay = expf(cum_last);
    for (int e = tid; e < n * kBlockP; e += kThreads) {
      const int k = e / kBlockP, col = e % kBlockP;
      float acc = 0.0f;
      for (int j = 0; j < l; ++j) acc = fmaf(s_w[j] * s_b[j * ldb + k], s_x[j * kBlockP + col], acc);
      s_state[e] = fmaf(decay, s_state[e], acc);
    }
    __syncthreads();
  }
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const void* log_a, const void* b, const void* c, void* y,
                   int bh, int t, int p, int n, int l, cudaStream_t stream) {
  const size_t smem = smem_floats(l, n) * sizeof(float);
  auto kernel = ssd_scan_kernel<TX, TB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the caller raises on the return value
      return err;
    }
  }
  const dim3 grid(bh, (p + kBlockP - 1) / kBlockP);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(log_a), static_cast<const TB*>(b),
      static_cast<const TB*>(c), static_cast<TX*>(y), t, p, n, l);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t by_bc(int bc_dtype, const void* x, const void* log_a, const void* b, const void* c,
                  void* y, int bh, int t, int p, int n, int l, cudaStream_t stream) {
  switch (bc_dtype) {
    case 0: return launch<TX, float>(x, log_a, b, c, y, bh, t, p, n, l, stream);
    case 1: return launch<TX, __nv_bfloat16>(x, log_a, b, c, y, bh, t, p, n, l, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ssd_scan_smem_bytes(int l, int n) {
  return static_cast<int>(smem_floats(l, n) * sizeof(float));
}

extern "C" int ssd_scan(const void* x, const void* log_a, const void* b, const void* c, void* y,
                        int bh, int t, int p, int n, int l, int x_dtype, int bc_dtype,
                        void* stream) {
  if (bh < 1 || t < 1 || p < 1 || n < 1 || l < 1 || l > t || (p + kBlockP - 1) / kBlockP > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (x_dtype) {
    case 0: err = by_bc<float>(bc_dtype, x, log_a, b, c, y, bh, t, p, n, l, s); break;
    case 1: err = by_bc<__nv_bfloat16>(bc_dtype, x, log_a, b, c, y, bh, t, p, n, l, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
