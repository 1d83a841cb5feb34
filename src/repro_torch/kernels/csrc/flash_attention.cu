// flash_attention — online-softmax attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/attention.py:_attn_kernel
// (pallas_call at attention.py:87).  q (BH, Tq, D), k and v (BH, Tk, D) ->
// o (BH, Tq, D) in q's dtype, with s = (q k^T) * scale in f32.  Query row i
// sits at position i + (Tk - Tq) (end-aligned, so one kernel serves prefill
// and chunked decode).  A score is kept where kpos < Tk and, if causal,
// kpos <= qpos and, if window > 0, kpos > qpos - window; masked scores are
// -1e30 after scaling.  The running max m, sum l and accumulator acc are f32:
//
//   m_new = max(m, rowmax(s)),  p = exp(s - m_new),  corr = exp(m - m_new)
//   l = l * corr + rowsum(p),   acc = acc * corr + p @ v
//
// and the output is acc / max(l, 1e-30), cast to q's dtype.
//
// Design.  The TPU grid (BH, Tq/bq, Tk/bk) walks its KV axis in order
// ("arbitrary") with m, l, acc in VMEM scratch across grid steps; Hopper
// blocks run in no order, so one block owns BQ query rows of one (batch x
// head) row and walks every KV tile it needs in a loop, m and l in shared
// memory and acc in registers for the whole walk, and stores once.  Grid
// (ceil(Tq / BQ), BH).  Per KV tile of BK keys the block stages K and V
// (f32) beside its Q tile, computes the BQ x BK scores on a 16 x 16 thread
// grid, masks them, lets each warp update the statistics of its rows
// (warp-shuffle max and sum, expf and not __expf) and then scales and adds
// p @ v into the accumulator.  KV tiles wholly masked for every row of the
// block (past the causal edge, or before the window of the block's first
// row) are skipped; that is exact for any row that sees at least one key,
// because the reference's corr = exp(-1e30 - m) = 0 wipes whatever such a
// row gathered before its first visible key.
//
// Head dims.  DP, the staged width, is a template value in {64, 128, 256};
// a head dim d <= 256 runs at the smallest DP >= d with the columns past d
// staged as zeros (exact for q k^T, and never stored), so every head dim of
// the configurations the repository carries fits (32 and 64 in the tests,
// 80 hubert / zamba2, 128 qwen3 / Mixtral, 192 the MLA query, 256 gemma).
// Row strides of the staged tiles are padded by one float so a warp's reads
// down a column hit 32 banks.
//
// Bound on this card.  4 D FLOPs per visible (query, key) pair against
// (q, k, v, o) bytes read or written once: at prefill lengths the work is
// far above the card's balance, so the bound is operations at the bf16
// tensor-core peak.  This first version runs both products on f32 CUDA-core
// FMA, as the reference's astype(float32) matmuls do, with every operand
// read from shared memory; mma.sync / wgmma with the statistics in
// registers is later work.
//
// C interface (bound with ctypes):
//   int flash_attention(q, k, v, o, bh, tq, tk, d, scale, causal, window,
//                       dtype, block_q, block_k, stream)
//     dtype codes 0 float32, 1 bfloat16.  Returns the cudaGetLastError()
//     value right after the launch (0 on success), or cudaErrorInvalidValue
//     for an unsupported dtype, head dim or block configuration.
//   int flash_attention_smem_bytes(block_q, block_k, d) — the dynamic shared
//     memory of one block (0 if d is not supported).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 thread grid; 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the staged head width for head dim d (0 when d is not supported)
int padded_dim(int d) {
  if (d < 1) return 0;
  if (d <= 64) return 64;
  if (d <= 128) return 128;
  if (d <= 256) return 256;
  return 0;
}

// Q (BQ, DP+1), K and V (BK, DP+1), S (BQ, BK+1), m, l, corr (BQ), all f32
size_t smem_floats(int bq, int bk, int dp) {
  const size_t ld = dp + 1;
  return bq * ld + 2 * bk * ld + static_cast<size_t>(bq) * (bk + 1) + 3 * bq;
}

template <int BQ, int BK, int DP, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int tq, int tk, int d,
                       float scale, int causal, int window) {
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && DP % 16 == 0, "16 x 16 thread grid");
  constexpr int LD = DP + 1;
  constexpr int LDS = BK + 1;
  constexpr int TI = BQ / 16;   // rows of the tile per thread
  constexpr int TJ = BK / 16;   // score columns per thread
  constexpr int TD = DP / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;             // (BQ, LD)
  float* sk = sq + BQ * LD;     // (BK, LD)
  float* sv = sk + BK * LD;     // (BK, LD)
  float* ss = sv + BK * LD;     // (BQ, LDS): scores, then p
  float* sm = ss + BQ * LDS;    // running max
  float* sl = sm + BQ;          // running sum
  float* sc = sl + BQ;          // this tile's corr

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const size_t row = blockIdx.y;
  const T* qr = q + row * tq * d;
  const T* kr = k + row * tk * d;
  const T* vr = v + row * tk * d;
  const int off = tk - tq;      // query i sits at position i + off

  for (int idx = tid; idx < BQ * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    const int gq = q0 + r;
    sq[r * LD + c] = (gq < tq && c < d) ? to_f32(qr[static_cast<size_t>(gq) * d + c]) : 0.0f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    sm[r] = kNeg;
    sl[r] = 0.0f;
  }

  float acc[TI][TD];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.0f;

  // the keys any row of this block can see
  const int last = (q0 + BQ < tq ? q0 + BQ : tq) - 1;
  int kend = tk;
  if (causal && last + off + 1 < kend) kend = last + off + 1;
  int kbeg = 0;
  if (window > 0 && q0 + off - window + 1 > 0) kbeg = (q0 + off - window + 1) / BK * BK;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and p are consumed
    for (int idx = tid; idx < BK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      const int gk = k0 + r;
      const bool in = gk < tk && c < d;
      const size_t at = static_cast<size_t>(gk) * d + c;
      sk[r * LD + c] = in ? to_f32(kr[at]) : 0.0f;
      sv[r * LD + c] = in ? to_f32(vr[at]) : 0.0f;
    }
    __syncthreads();

    float s[TI][TJ];
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float qv[TI], kv[TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i) qv[i] = sq[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < TJ; ++j) kv[j] = sk[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r + off;
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        bool keep = kpos < tk;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        ss[r * LDS + c] = keep ? s[i][j] * scale : kNeg;
      }
    }
    __syncthreads();

    // each warp updates the statistics of rows warp, warp + 8, ...
    for (int r = warp; r < BQ; r += kWarps) {
      float mx = kNeg;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, ss[r * LDS + c]);
#pragma unroll
      for (int w = 16; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(ss[r * LDS + c] - m_new);
        ss[r * LDS + c] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sl[r] = sl[r] * corr + sum;
        sm[r] = m_new;
        sc[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const float corr = sc[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[TI], vv[TD];
#pragma unroll
      for (int i = 0; i < TI; ++i) pv[i] = ss[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) vv[j] = sv[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* orow = o + row * tq * d;
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int r = ty + 16 * i;
    const int gq = q0 + r;
    if (gq >= tq) continue;
    const float l = fmaxf(sl[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[static_cast<size_t>(gq) * d + c] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <int BQ, int BK, int DP, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                   int tk, int d, float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_floats(BQ, BK, DP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<BQ, BK, DP, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  flash_attention_kernel<BQ, BK, DP, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), tq, tk, d, scale, causal, window);
  return cudaGetLastError();
}

template <int BQ, int BK, typename T>
cudaError_t by_dim(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                   int tk, int d, float scale, int causal, int window, cudaStream_t s) {
  switch (padded_dim(d)) {
    case 64: return launch<BQ, BK, 64, T>(q, k, v, o, bh, tq, tk, d, scale, causal, window, s);
    case 128: return launch<BQ, BK, 128, T>(q, k, v, o, bh, tq, tk, d, scale, causal, window, s);
    case 256: return launch<BQ, BK, 256, T>(q, k, v, o, bh, tq, tk, d, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int BQ, int BK>
cudaError_t by_dtype(int dtype, const void* q, const void* k, const void* v, void* o, int bh,
                     int tq, int tk, int d, float scale, int causal, int window,
                     cudaStream_t s) {
  switch (dtype) {
    case 0: return by_dim<BQ, BK, float>(q, k, v, o, bh, tq, tk, d, scale, causal, window, s);
    case 1:
      return by_dim<BQ, BK, __nv_bfloat16>(q, k, v, o, bh, tq, tk, d, scale, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The block configurations compiled in; kernels/attention.py:BLOCKS lists
// the same four.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int bh,
                               int tq, int tk, int d, float scale, int causal, int window,
                               int dtype, int block_q, int block_k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (block_q == 64 && block_k == 64) {
    err = by_dtype<64, 64>(dtype, q, k, v, o, bh, tq, tk, d, scale, causal, window, s);
  } else if (block_q == 64 && block_k == 32) {
    err = by_dtype<64, 32>(dtype, q, k, v, o, bh, tq, tk, d, scale, causal, window, s);
  } else if (block_q == 32 && block_k == 32) {
    err = by_dtype<32, 32>(dtype, q, k, v, o, bh, tq, tk, d, scale, causal, window, s);
  } else if (block_q == 16 && block_k == 16) {
    err = by_dtype<16, 16>(dtype, q, k, v, o, bh, tq, tk, d, scale, causal, window, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int flash_attention_smem_bytes(int block_q, int block_k, int d) {
  const int dp = padded_dim(d);
  if (dp == 0) return 0;
  return static_cast<int>(smem_floats(block_q, block_k, dp) * sizeof(float));
}
