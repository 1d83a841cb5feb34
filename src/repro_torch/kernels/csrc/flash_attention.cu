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
// The TPU grid (BH, Tq/bq, Tk/bk) walks its KV axis in order ("arbitrary")
// with m, l, acc in VMEM scratch across grid steps; Hopper blocks run in no
// order, so one block owns block_q query rows of one (batch x head) row,
// walks every KV tile those rows can see in a loop and stores once.  KV
// tiles wholly masked for every row of the block (past the causal edge, or
// before the window of its first row) are skipped; that is exact for any
// row that sees at least one key, because corr = exp(-1e30 - m) = 0 wipes
// whatever such a row gathered before its first visible key.
//
// Bound on this card.  4 D FLOPs per visible (query, key) pair against
// (q, k, v, o) bytes read or written once: at prefill lengths far above the
// card's balance, so the bound is operations at the bf16 tensor-core peak;
// a chunked decode (Tq = 16) is bound by reading K and V.
//
// Two kernels, chosen by dtype before the launch:
//
// bf16 — FlashAttention-2 on the tensor cores.  A block of block_q / 16
// warps (4 for block_q = 64, one for block_q = 16, the short-query block
// of chunked decode) owns block_q rows, 16 per warp; Q is staged once in
// shared memory, K and V tiles of block_k keys arrive through a cp.async
// double buffer, so tile j + 1 loads while tile j computes.  S = Q K^T runs
// on mma.sync.m16n8k16 (bf16 in, f32 accumulators in registers), masks are
// applied on the fragments from each element's (qpos, kpos), and the row
// max and sum stay in registers, reduced across the quad of lanes that
// share a row with shuffles — no shared-memory statistics, no barrier
// between scores, softmax and PV.  P is reused from the S fragments as the
// A operand of the PV mma, with V read by ldmatrix.trans.  P's precision:
// the reference multiplies P in f32; P rounded to bf16 (as FA2 and SDPA
// do) moves outputs by up to ~2^-9 of sum(p |v|) / l, past one bf16 ulp on
// peaked gemma-2b rows, so P is split into P_hi + P_lo, both bf16, and two
// PV mmas keep ~16 bits of P for 1.5x the FLOPs.  Rows are padded by 16
// bytes so the 8 rows an ldmatrix reads fall on 8 bank groups; block
// rows are walked in reverse so causal blocks with the most tiles start
// first.  Operands whose head dim is not a multiple of 8 (or whose
// pointers are not 16-byte aligned) are staged by plain loads instead of
// cp.async, in the same kernel.
//
// f32 — the CUDA-core kernel: f32 staging of Q, K, V in shared memory, the
// products on FP32 FMA (the reference's f32 tolerance of 2e-5 is beyond
// TF32 and bf16), m and l in shared memory, acc in registers.
//
// Head dims.  DP, the staged width, is a template value in {64, 128, 256};
// a head dim d <= 256 runs at the smallest DP >= d with the columns past d
// staged as zeros (exact for q k^T, and never stored), so every head dim of
// the configurations the repository carries fits (32 and 64 in the tests,
// 80 hubert / zamba2, 128 qwen3 / Mixtral, 192 the MLA query, 256 gemma).
//
// C interface (bound with ctypes):
//   int flash_attention(q, k, v, o, bh, tq, tk, d, scale, causal, window,
//                       dtype, block_q, block_k, stream)
//     dtype codes 0 float32, 1 bfloat16.  Returns the cudaGetLastError()
//     value right after the launch (0 on success), or cudaErrorInvalidValue
//     for an unsupported dtype, head dim or block configuration.
//   int flash_attention_smem_bytes(block_q, block_k, d, dtype) — the dynamic
//     shared memory of one block (0 if the block or d is not supported).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float kNeg = -1e30f;

// the staged head width for head dim d (0 when d is not supported)
int padded_dim(int d) {
  if (d < 1) return 0;
  if (d <= 64) return 64;
  if (d <= 128) return 128;
  if (d <= 256) return 256;
  return 0;
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // a 16 x 16 thread grid; 8 warps
constexpr int kWarps = kThreads / 32;

// Q (BQ, DP+1), K and V (BK, DP+1), S (BQ, BK+1), m, l, corr (BQ), all f32
size_t smem_floats(int bq, int bk, int dp) {
  const size_t ld = dp + 1;
  return bq * ld + 2 * bk * ld + static_cast<size_t>(bq) * (bk + 1) + 3 * bq;
}

// Per KV tile of BK keys the block stages K and V beside its Q tile (row
// strides padded by one float so a warp's reads down a column hit 32
// banks), computes the BQ x BK scores on a 16 x 16 thread grid, masks
// them, lets each warp update the statistics of its rows (warp-shuffle max
// and sum, expf and not __expf) and then scales and adds p @ v into the
// accumulator.
template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int tq, int tk,
                       int d, float scale, int causal, int window) {
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
  const float* qr = q + row * tq * d;
  const float* kr = k + row * tk * d;
  const float* vr = v + row * tk * d;
  const int off = tk - tq;      // query i sits at position i + off

  for (int idx = tid; idx < BQ * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    const int gq = q0 + r;
    sq[r * LD + c] = (gq < tq && c < d) ? qr[static_cast<size_t>(gq) * d + c] : 0.0f;
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
      sk[r * LD + c] = in ? kr[at] : 0.0f;
      sv[r * LD + c] = in ? vr[at] : 0.0f;
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

  float* orow = o + row * tq * d;
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    const int r = ty + 16 * i;
    const int gq = q0 + r;
    if (gq >= tq) continue;
    const float l = fmaxf(sl[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      const int c = tx + 16 * j;
      if (c < d) orow[static_cast<size_t>(gq) * d + c] = acc[i][j] / l;
    }
  }
}

template <int BQ, int BK, int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                       int tk, int d, float scale, int causal, int window, cudaStream_t stream) {
  static unsigned done = 0;
  const size_t smem = smem_floats(BQ, BK, DP) * sizeof(float);
  auto kernel = flash_attention_kernel<BQ, BK, DP>;
  const cudaError_t err = allow_smem(kernel, smem, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), tq, tk, d, scale, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: FlashAttention-2 on mma.sync
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Shared memory of one bf16 block: Q (BQ rows) and two buffers each of K
// and V (BK rows), rows of DP + 8 bf16.
template <int BQ, int BK, int DP> struct MmaAttnTile {
  static constexpr int kLd = DP + 8;
  static constexpr size_t kSmem = static_cast<size_t>(BQ + 4 * BK) * kLd * 2;
};

// rows [row0, row0 + ROWS) of a (rows, d) bf16 matrix into a (ROWS, DP + 8)
// tile; rows past n_rows and columns past d are zeros
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void stage(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                      int n_rows, int d, bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int CH = DP / 8;
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = row0 + r < n_rows && c < d;
      const __nv_bfloat16* at = in ? src + static_cast<size_t>(row0 + r) * d + c : src;
      cp_async16(smem_addr(dst + r * LD + c), at, in);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP, c = i % DP;
      const bool in = row0 + r < n_rows && c < d;
      dst[r * LD + c] = in ? src[static_cast<size_t>(row0 + r) * d + c] : __float2bfloat16(0.0f);
    }
  }
}

template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(BQ * 2)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                           int tq, int tk, int d, float scale, int causal, int window,
                           int vec) {
  using L = MmaAttnTile<BQ, BK, DP>;
  constexpr int NT = BQ * 2;       // BQ / 16 warps of 32 threads
  constexpr int LD = L::kLd;
  constexpr int NS = BK / 8;       // n8 score fragments per warp
  constexpr int NO = DP / 8;       // n8 output fragments per warp
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && DP % 16 == 0, "m16n8k16 tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* skv = sq + BQ * LD;   // K0, V0, K1, V1

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  // blocks with the most tiles (the last rows, under a causal mask) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const size_t row = blockIdx.y;
  const __nv_bfloat16* qr = q + row * tq * d;
  const __nv_bfloat16* kr = k + row * tk * d;
  const __nv_bfloat16* vr = v + row * tk * d;
  const int off = tk - tq;             // query i sits at position i + off
  const float sl2 = scale * kLog2e;    // scores in log2 units: exp2 == exp

  // the keys any row of this block can see
  const int last = (q0 + BQ < tq ? q0 + BQ : tq) - 1;
  int kend = tk;
  if (causal && last + off + 1 < kend) kend = last + off + 1;
  int kbeg = 0;
  if (window > 0 && q0 + off - window + 1 > 0) kbeg = (q0 + off - window + 1) / BK * BK;
  const int ntiles = kend > kbeg ? (kend - kbeg + BK - 1) / BK : 0;

  stage<BQ, DP, NT>(sq, qr, q0, tq, d, vec);
  if (ntiles > 0) {
    stage<BK, DP, NT>(skv, kr, kbeg, tk, d, vec);
    stage<BK, DP, NT>(skv + BK * LD, vr, kbeg, tk, d, vec);
  }
  cp_async_commit();

  // this thread's rows: warp * 16 + g and + 8
  const int qlo = q0 + warp * 16 + off, qhi = qlo + 15;  // the warp's rows
  float m_r[2] = {kNeg, kNeg};      // running max, log2 units
  float l_r[2] = {0.0f, 0.0f};      // this thread's share of the running sum
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * BK;
    if (it + 1 < ntiles) {
      __nv_bfloat16* nk = skv + ((it + 1) & 1) * 2 * BK * LD;
      stage<BK, DP, NT>(nk, kr, k0 + BK, tk, d, vec);
      stage<BK, DP, NT>(nk + BK * LD, vr, k0 + BK, tk, d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it (and Q) have landed
    const __nv_bfloat16* sk = skv + (it & 1) * 2 * BK * LD;
    const __nv_bfloat16* sv = sk + BK * LD;

    // S = Q K^T: this warp's 16 rows x BK keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_addr(sq + (warp * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8));
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_addr(sk + (j * 8 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                                  ((lane / 8) % 2) * 8));
        Mma<__nv_bfloat16>::run(s[j], qa, kb[0], kb[1]);
        Mma<__nv_bfloat16>::run(s[j + 1], qa, kb[2], kb[3]);
      }
    }

    // scale to log2 units; mask unless every (row, key) of the warp is kept
    const bool whole = k0 + BK <= tk && (!causal || k0 + BK - 1 <= qlo) &&
                       (window <= 0 || k0 > qhi - window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e] * sl2;
        if (whole) {
          s[j][e] = x;
        } else {
          const int qpos = qlo + g + (e / 2) * 8;
          const int kpos = k0 + j * 8 + 2 * t + (e % 2);
          bool keep = kpos < tk;
          if (causal) keep = keep && kpos <= qpos;
          if (window > 0) keep = keep && kpos > qpos - window;
          s[j][e] = keep ? x : kNeg;
        }
      }

    // online softmax on the two rows this thread holds; the 4 lanes of a
    // quad share a row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h], mx);
      const float corr = exp2f(m_r[h] - m_new);
      m_r[h] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * h] = exp2f(s[j][2 * h] - m_new);
        s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - m_new);
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      l_r[h] = l_r[h] * corr + sum;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * h] *= corr;
        acc[n][2 * h + 1] *= corr;
      }
    }

    // acc += P V with P = P_hi + P_lo, both bf16, as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the A fragment of keys 16 kk..16 kk + 15 is the S fragments of
      // n8 tiles 2 kk and 2 kk + 1: a0 (row g, keys 2t, 2t + 1 of the
      // first), a1 (row g + 8), a2 and a3 (the same of the second)
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* src = s[2 * kk + e / 2] + (e % 2) * 2;
        ah[e] = pack_bf16(src[0], src[1]);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&ah[e]);
        al[e] = pack_bf16(src[0] - __low2float(hi), src[1] - __high2float(hi));
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_addr(sv + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                                        n * 8 + (lane / 16) * 8));
        Mma<__nv_bfloat16>::run(acc[n], ah, vb[0], vb[1]);
        Mma<__nv_bfloat16>::run(acc[n], al, vb[0], vb[1]);
        Mma<__nv_bfloat16>::run(acc[n + 1], ah, vb[2], vb[3]);
        Mma<__nv_bfloat16>::run(acc[n + 1], al, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  cp_async_wait<0>();

  // the row sums: each lane of a quad holds a quarter of its row's keys
  __nv_bfloat16* orow = o + row * tq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    const int gq = q0 + warp * 16 + g + 8 * h;
    if (gq >= tq) continue;
    __nv_bfloat16* out = orow + static_cast<size_t>(gq) * d;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * t;
      const float x0 = acc[n][2 * h] * inv, x1 = acc[n][2 * h + 1] * inv;
      if (vec) {
        if (c < d) *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < d) out[c] = __float2bfloat16_rn(x0);
        if (c + 1 < d) out[c + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int BQ, int BK, int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int bh, int tq,
                        int tk, int d, float scale, int causal, int window, cudaStream_t stream) {
  static unsigned done = 0;
  constexpr size_t smem = MmaAttnTile<BQ, BK, DP>::kSmem;
  auto kernel = flash_attention_mma_kernel<BQ, BK, DP>;
  const cudaError_t err = allow_smem(kernel, smem, &done);
  if (err != cudaSuccess) return err;
  // 16-byte copies need d % 8 == 0 and 16-byte aligned rows
  const int vec = d % 8 == 0 && (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                                 reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
                                        16 == 0;
  const dim3 grid((tq + BQ - 1) / BQ, bh);
  kernel<<<grid, BQ * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), tq, tk, d, scale,
      causal, window, vec);
  return cudaGetLastError();
}

// The blocks compiled in, as (block_q, block_k): f32 kernels/attention.py:
// BLOCKS, bf16 kernels/attention.py:MMA_BLOCKS.  The dispatch and
// flash_attention_smem_bytes both read these lists.
#define FA_F32_BLOCKS(X) X(64, 64) X(64, 32) X(32, 32) X(16, 16)
#define FA_BF16_BLOCKS(X) X(64, 64) X(64, 32) X(16, 64) X(16, 32)

template <int DP>
cudaError_t by_block(int dtype, int block_q, int block_k, const void* q, const void* k,
                     const void* v, void* o, int bh, int tq, int tk, int d, float scale,
                     int causal, int window, cudaStream_t s) {
#define FA_CASE(DT, FN, BQ, BK)                                                       \
  if (dtype == DT && block_q == BQ && block_k == BK)                                  \
    return FN<BQ, BK, DP>(q, k, v, o, bh, tq, tk, d, scale, causal, window, s);
#define FA_F32(BQ, BK) FA_CASE(0, launch_f32, BQ, BK)
#define FA_BF16(BQ, BK) FA_CASE(1, launch_bf16, BQ, BK)
  FA_F32_BLOCKS(FA_F32)
  FA_BF16_BLOCKS(FA_BF16)
#undef FA_BF16
#undef FA_F32
#undef FA_CASE
  return cudaErrorInvalidValue;
}

// the bf16 block's shared memory at staged width dp (one of 64, 128, 256)
template <int BQ, int BK>
size_t smem_bf16(int dp) {
  return dp == 64    ? MmaAttnTile<BQ, BK, 64>::kSmem
         : dp == 128 ? MmaAttnTile<BQ, BK, 128>::kSmem
                     : MmaAttnTile<BQ, BK, 256>::kSmem;
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int bh,
                               int tq, int tk, int d, float scale, int causal, int window,
                               int dtype, int block_q, int block_k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (padded_dim(d)) {
    case 64:
      err = by_block<64>(dtype, block_q, block_k, q, k, v, o, bh, tq, tk, d, scale, causal,
                         window, s);
      break;
    case 128:
      err = by_block<128>(dtype, block_q, block_k, q, k, v, o, bh, tq, tk, d, scale, causal,
                          window, s);
      break;
    case 256:
      err = by_block<256>(dtype, block_q, block_k, q, k, v, o, bh, tq, tk, d, scale, causal,
                          window, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int flash_attention_smem_bytes(int block_q, int block_k, int d, int dtype) {
  const int dp = padded_dim(d);
  if (dp == 0) return 0;
#define FA_F32(BQ, BK)                                \
  if (dtype == 0 && block_q == BQ && block_k == BK) \
    return static_cast<int>(smem_floats(BQ, BK, dp) * sizeof(float));
#define FA_BF16(BQ, BK)                               \
  if (dtype == 1 && block_q == BQ && block_k == BK) \
    return static_cast<int>(smem_bf16<BQ, BK>(dp));
  FA_F32_BLOCKS(FA_F32)
  FA_BF16_BLOCKS(FA_BF16)
#undef FA_BF16
#undef FA_F32
  return 0;
}
