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
// Dataflow.  The TPU grid (BH, T/L) walks the chunk axis in order and keeps
// S in VMEM scratch across grid steps; Hopper blocks run in no order, so one
// block walks every chunk of its row in a loop with its slice of S on chip,
// zeroed inside the block; no state goes through device memory.  S's
// columns are independent (y[:, p] needs only S[:, p] and X[:, p]), so the
// grid is (BH, P / BP) and each block owns BP columns of S and y,
// recomputing the causal score block C B^T.  Rows of the last chunk past T
// (and, for a chunk length that is not a multiple of 16, the tile's rows
// past L) are staged as log_a = 0, b = c = x = 0, which is exactly the
// reference's neutral padding; their outputs are not stored.  Operands are
// read through strides (row, head, time; unit stride on P and N), so the
// model's (B, T, H, .) layout and a b / c shared by every head (head stride
// 0) need no copy.  The fma kernel's exponentials are expf; the mma kernel
// keeps cum in log2 units and takes exp2f, as K3 does (neither __expf).
//
// Bound on this card.  The chunked form costs per row and chunk of L steps
// L(L+1) N for C B^T (bf16 b / c: one tensor-core pass) and L(L+1) P +
// 4 L N P for G X, C S and B^T X, f32-accurate; on the tensor cores at
// three bf16 passes each, that is below the bytes term at every serving
// shape (BH 32, P 64, N 128, T <= 2048), so the bound is bytes: x, log_a,
// b, c read once and y written once.
//
// Two kernels, chosen by the wrapper (kernels/ssd_scan.py:variant) before
// the launch; neither falls back to the other:
//
// mma — bf16 b / c, f32 or bf16 x, N % 16 == 0, N <= 128, P % 16 == 0,
// 16-byte aligned rows; BP = 16 columns a block.  8 warps; a chunk of up to 128 rows (a longer
// chunk is walked as 128-row chunks: the same function, the state carried
// on chip between them) is padded to LP, a multiple of 16.
//  1. Staging: a ring of two buffers, each x (LP, BP), b and c (LP,
//     N + 8) bf16 and log_a (LP), filled by 16-byte cp.async (4-byte for
//     log_a, which has the time stride of the model's layout), zero-filled
//     past the chunk: chunk c + 1 loads while chunk c computes.
//  2. Prefix sum: warp 0 scans cum with shuffles (4 values a lane), in
//     log2 units.
//  3. Scores: warp w owns rows 16w..16w+15, whose y needs key blocks
//     jb <= w: C_w B_jb^T on mma.sync.m16n8k16 (bf16 in, exact products,
//     f32 accumulators), then on the fragments j > i -> 0 before the exp
//     and G = s * exp(cum_i - cum_j).  G stays in registers as the A
//     operand of G X, as K3 keeps P.  The causal triangle is balanced over
//     the warps: the owner of a heavy row block (w > 7 - w at full length)
//     walks its first key blocks and the owner of the light block 7 - w
//     the rest, handing its partial y over in shared memory (5 key blocks
//     a warp at most, where one warp would walk 8).
//  4. f32 accuracy without TF32: each f32 operand v is split into three
//     bf16 planes hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid)
//     (24 bits in all).  G X takes the six products down to 2^-16 of the
//     leading term (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid; three
//     when x is bf16 and exact); C S and B^T (w X) take three (C and B are
//     bf16 and exact).  Two planes (16 bits) reach 1.3x K4's f32 tolerance
//     at a slow decay (tools/k4_precision.py).  Each group of mmas sums
//     into a fresh fragment that is added to its f32 total with an ordinary
//     add: the tensor core truncates as it accumulates.
//  5. The state: warp w owns state rows 16w..16w+15 as f32 accumulator
//     fragments for the whole walk; S = exp(cum_L) S + B^T (w X), and S is
//     written as three bf16 planes to shared memory once per chunk for the
//     next chunk's C S.  w X reuses the X planes after G X is done.
//
// fma — everything else (f32 b / c, the reference's narrow shapes): the
// CUDA-core kernel, every product on FP32 FMA with both operands read from
// shared memory, BP = 16, the whole (L, L) score block in shared memory.
// With one block an SM, nothing overlaps a chunk's staging, which is
// bound by the latency of its scalar loads: each thread issues a batch of
// them before it stores any (stage_rows).
//
// C interface (bound with ctypes):
//   int ssd_scan(x, log_a, b, c, y, nb, nh, t, p, n, l, x_dtype, bc_dtype,
//                strides, variant, stream)
//     x, y (nb, nh, t, p) in x_dtype; log_a (nb, nh, t) f32; b, c (nb, nh,
//     t, n) in bc_dtype; dtype codes 0 float32, 1 bfloat16.  strides: 15
//     element strides (batch, head, time) of x, y, log_a, b, c in that
//     order; the last dim of x, y, b, c has unit stride.  variant 0 fma,
//     1 mma.  Returns the cudaGetLastError() value right after the launch
//     (0 on success), or cudaErrorInvalidValue for an unsupported dtype or
//     shape.
//   int ssd_scan_smem_bytes(variant, l, n, x_dtype) — the dynamic shared
//     memory of one block at chunk length l.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long xb, xh, xt, yb, yh, yt, ab, ah, at, bb, bh, bt, cb, ch, ct;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// fma: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kFmaBlockP = 16;  // columns of S and y owned by one block

// S (N, BP), X (L, BP), B and C (L, N+1), G (L, L+1), cum (L), w (L)
size_t fma_smem_floats(int l, int n) {
  const size_t L = l, N = n;
  return N * kFmaBlockP + L * kFmaBlockP + 2 * L * (N + 1) + L * (L + 1) + 2 * L;
}

// dst[r * ld + k] = src[r * rstride + k] in f32 for the (lrows, cols) tile,
// zero past `rows` rows and `valid` columns, each thread issuing
// kStageBatch loads before it stores any: the staging is latency-bound.
constexpr int kStageBatch = 8;

template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, long long rstride,
                                           int rows, int lrows, int cols, int valid, int tid) {
  const int total = lrows * cols;
  for (int e0 = tid; e0 < total; e0 += kStageBatch * kThreads) {
    float v[kStageBatch];
    int at[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kThreads;
      const int r = e / cols, k = e % cols;
      at[u] = e < total ? r * ld + k : -1;
      v[u] = e < total && r < rows && k < valid ? to_f32(src[r * rstride + k]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u)
      if (at[u] >= 0) dst[at[u]] = v[u];
  }
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
ssd_scan_fma_kernel(const TX* __restrict__ x, const float* __restrict__ log_a,
                    const TB* __restrict__ b, const TB* __restrict__ c, TX* __restrict__ y,
                    int nh, int t, int p, int n, int l, Strides st) {
  constexpr int BP = kFmaBlockP;
  extern __shared__ float smem[];
  const int ldb = n + 1;  // padded row strides: no bank conflicts on columns
  const int ldg = l + 1;
  float* s_state = smem;             // (N, BP)
  float* s_x = s_state + n * BP;     // (L, BP)
  float* s_b = s_x + l * BP;         // (L, N+1)
  float* s_c = s_b + l * ldb;        // (L, N+1)
  float* s_g = s_c + l * ldb;        // (L, L+1), lower triangle used
  float* s_cum = s_g + l * ldg;      // (L)
  float* s_w = s_cum + l;            // (L)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.y * BP;
  const long long bi = blockIdx.x / nh, hi = blockIdx.x % nh;
  const TX* xr = x + bi * st.xb + hi * st.xh + p0;
  TX* yr = y + bi * st.yb + hi * st.yh + p0;
  const float* ar = log_a + bi * st.ab + hi * st.ah;
  const TB* br = b + bi * st.bb + hi * st.bh;
  const TB* cr = c + bi * st.cb + hi * st.ch;

  for (int e = tid; e < n * BP; e += kThreads) s_state[e] = 0.0f;

  for (int t0 = 0; t0 < t; t0 += l) {
    // 1. stage the chunk in f32; rows past T are the neutral padding
    const int rows = t - t0 < l ? t - t0 : l;
    const int cols = p - p0 < BP ? p - p0 : BP;
    stage_rows(s_x, BP, xr + t0 * st.xt, st.xt, rows, l, BP, cols, tid);
    stage_rows(s_b, ldb, br + t0 * st.bt, st.bt, rows, l, n, n, tid);
    stage_rows(s_c, ldb, cr + t0 * st.ct, st.ct, rows, l, n, n, tid);
    for (int i = tid; i < l; i += kThreads) s_cum[i] = i < rows ? ar[(t0 + i) * st.at] : 0.0f;
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
    for (int e = tid; e < l * BP; e += kThreads) {
      const int i = e / BP, col = e % BP;
      const int gt = t0 + i, gp = p0 + col;
      if (gt >= t || gp >= p) continue;
      const float* ci = s_c + i * ldb;
      float inter = 0.0f;
      for (int k = 0; k < n; ++k) inter = fmaf(ci[k], s_state[k * BP + col], inter);
      const float* gi = s_g + i * ldg;
      float intra = 0.0f;
      for (int j = 0; j <= i; ++j) intra = fmaf(gi[j], s_x[j * BP + col], intra);
      yr[gt * st.yt + col] = from_f32<TX>(fmaf(expf(s_cum[i]), inter, intra));
    }
    __syncthreads();

    // 5. S = exp(cum_L) S + sum_j (w_j b_j) (outer) x_j
    const float decay = expf(cum_last);
    for (int e = tid; e < n * BP; e += kThreads) {
      const int k = e / BP, col = e % BP;
      float acc = 0.0f;
      for (int j = 0; j < l; ++j) acc = fmaf(s_w[j] * s_b[j * ldb + k], s_x[j * BP + col], acc);
      s_state[e] = fmaf(decay, s_state[e], acc);
    }
    __syncthreads();
  }
}

template <typename TX, typename TB>
cudaError_t launch_fma(const void* x, const void* log_a, const void* b, const void* c, void* y,
                       int nb, int nh, int t, int p, int n, int l, const Strides& st,
                       cudaStream_t stream) {
  const size_t smem = fma_smem_floats(l, n) * sizeof(float);
  auto kernel = ssd_scan_fma_kernel<TX, TB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the caller raises on the return value
      return err;
    }
  }
  const dim3 grid(nb * nh, (p + kFmaBlockP - 1) / kFmaBlockP);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(log_a), static_cast<const TB*>(b),
      static_cast<const TB*>(c), static_cast<TX*>(y), nh, t, p, n, l, st);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mma: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMaxL = 16 * kMmaWarps;  // rows of a chunk tile: one m16 block a warp
constexpr int kMaxN = 16 * kMmaWarps;  // state rows: one m16 block a warp

__host__ __device__ constexpr size_t align16(size_t v) { return (v + 15) / 16 * 16; }

// bytes of one ring stage: x (lp, bp), b and c (lp, n + 8) bf16, log_a (lp)
__host__ __device__ constexpr size_t mma_stage_bytes(int lp, int n, int bp, int xsize) {
  return align16(static_cast<size_t>(lp) * bp * xsize) +
         2 * align16(static_cast<size_t>(lp) * (n + 8) * 2) + align16(static_cast<size_t>(lp) * 4);
}

// the ring, three bf16 planes of X / w X (lp, bp + 8) and of S (n, bp + 8),
// cum (lp) and the helpers' partial y (lp / 32 row blocks of 16 x bp f32)
__host__ __device__ constexpr size_t mma_smem_bytes(int lp, int n, int bp, int stages,
                                                    int xsize) {
  return stages * mma_stage_bytes(lp, n, bp, xsize) +
         3 * static_cast<size_t>(lp + n) * (bp + 8) * 2 + align16(static_cast<size_t>(lp) * 4) +
         static_cast<size_t>(lp / 32) * 16 * bp * 4;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// v0, v1 -> their hi, mid and lo bf16 pairs (v = hi + mid + lo to 24 bits)
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
  h = pack_bf16(v0, v1);
  const __nv_bfloat162 hh = *reinterpret_cast<const __nv_bfloat162*>(&h);
  const float r0 = v0 - __low2float(hh), r1 = v1 - __high2float(hh);
  m = pack_bf16(r0, r1);
  const __nv_bfloat162 mm = *reinterpret_cast<const __nv_bfloat162*>(&m);
  l = pack_bf16(r0 - __low2float(mm), r1 - __high2float(mm));
}

__device__ __forceinline__ void split3(float v, bf16& h, bf16& m, bf16& l) {
  h = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(h);
  m = __float2bfloat16_rn(r);
  l = __float2bfloat16_rn(r - __bfloat162float(m));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  Mma<bf16>::run(c, a, b0, b1);
}

// The B fragments of n8 tiles nn and nn + 1 over rows k0..k0+15 of a
// (rows, LD) bf16 plane stored [k][n] (X, w X, S): ldmatrix.trans, as K3 reads V.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* plane, int k0, int nn,
                                       int lane) {
  ldmatrix_x4_trans(r, smem_addr(plane + (k0 + ((lane / 8) % 2) * 8 + lane % 8) * LD + nn * 8 +
                                 (lane / 16) * 8));
}

// acc += G X for the 16 rows from i0 over key blocks [jb0, jb1), G built
// block by block on the tensor cores: s = C_i B_jb^T, then G = s exp(cum_i -
// cum_j) on the fragments (cum in log2 units; j > i masked before the exp,
// which only the diagonal block has), then G (three bf16 planes, in
// registers as the A operand, as K3 keeps P) times the X planes.
template <typename TX, int BP>
__device__ __forceinline__ void gx_rows(float (&acc)[BP / 8][4], const bf16* sc, const bf16* sb,
                                        const bf16* px, const float* scum, int i0, int jb0,
                                        int jb1, int lp, int ldb, int nk, int lane) {
  constexpr bool kSplitX = sizeof(TX) == 4;  // f32 x: three planes; bf16 x is exact
  constexpr int LDX = BP + 8;
  const int g = lane / 4, tq = lane % 4;
  const float cum0 = scum[i0 + g], cum1 = scum[i0 + g + 8];
  for (int jb = jb0; jb < jb1; ++jb) {
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk) {
      if (kk < nk) {
        uint32_t ca[4], kb[4];
        ldmatrix_x4(ca, smem_addr(sc + (i0 + lane % 16) * ldb + kk * 16 + (lane / 16) * 8));
        ldmatrix_x4(kb, smem_addr(sb + (jb * 16 + (lane / 16) * 8 + lane % 8) * ldb + kk * 16 +
                                  ((lane / 8) % 2) * 8));
        mma(s[0], ca, kb[0], kb[1]);
        mma(s[1], ca, kb[2], kb[3]);
      }
    }
    const bool diag = jb * 16 == i0;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + (e / 2) * 8;
        const int j = jb * 16 + jj * 8 + 2 * tq + (e % 2);
        const float ci = e / 2 ? cum1 : cum0;
        if (!diag) {
          s[jj][e] *= exp2f(ci - scum[j]);
        } else {
          const bool keep = j <= i;
          s[jj][e] = keep ? s[jj][e] * exp2f(keep ? ci - scum[j] : 0.0f) : 0.0f;
        }
      }
    // the A fragments of G (keys jb*16..+15): a0, a1 from tile 0, a2, a3 from tile 1
    uint32_t ah[4], am[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* src = s[e / 2] + (e % 2) * 2;
      split3(src[0], src[1], ah[e], am[e], al[e]);
    }
#pragma unroll
    for (int nt = 0; nt < BP / 8; nt += 2) {
      uint32_t xh[4];
      load_b<LDX>(xh, px, jb * 16, nt, lane);
      float f[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma(f[h], ah, xh[2 * h], xh[2 * h + 1]);
        mma(f[h], am, xh[2 * h], xh[2 * h + 1]);
        mma(f[h], al, xh[2 * h], xh[2 * h + 1]);
      }
      if (kSplitX) {
        uint32_t xm[4], xl[4];
        load_b<LDX>(xm, px + lp * LDX, jb * 16, nt, lane);
        load_b<LDX>(xl, px + 2 * lp * LDX, jb * 16, nt, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mma(f[h], ah, xm[2 * h], xm[2 * h + 1]);
          mma(f[h], am, xm[2 * h], xm[2 * h + 1]);
          mma(f[h], ah, xl[2 * h], xl[2 * h + 1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt + h][e] += f[h][e];
    }
  }
}

template <typename TX, int BP, int STAGES>
__global__ void __launch_bounds__(kMmaThreads, 1)
ssd_scan_mma_kernel(const TX* __restrict__ x, const float* __restrict__ log_a,
                    const bf16* __restrict__ b, const bf16* __restrict__ c, TX* __restrict__ y,
                    int nh, int t, int n, int l, Strides st) {
  constexpr bool kSplitX = sizeof(TX) == 4;  // f32 x: three planes; bf16 x is exact
  constexpr int LDX = BP + 8;                // bf16 row stride of the X and S planes
  constexpr int NT = BP / 8;                 // n8 tiles of a row block
  constexpr int XCH = BP * sizeof(TX) / 16;  // 16-byte pieces of an x row
  static_assert(BP % 16 == 0, "two n8 tiles per ldmatrix");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lp = (l + 15) / 16 * 16;
  const int ldb = n + 8;  // bf16 row stride of b and c
  const int nk = n / 16;  // k16 steps over the state dim
  const size_t sbytes = mma_stage_bytes(lp, n, BP, sizeof(TX));
  bf16* px = reinterpret_cast<bf16*>(smem_raw + STAGES * sbytes);  // 3 x (lp, LDX)
  bf16* ps = px + 3 * lp * LDX;                                    // 3 x (n, LDX)
  float* scum = reinterpret_cast<float*>(ps + 3 * n * LDX);        // (lp)
  float* part = scum + lp;  // (lp / 32, NT, 4, 32): the helpers' partial y

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  const long long bi = blockIdx.x / nh, hi = blockIdx.x % nh;
  const int p0 = blockIdx.y * BP;
  const TX* xr = x + bi * st.xb + hi * st.xh + p0;
  TX* yr = y + bi * st.yb + hi * st.yh + p0;
  const float* ar = log_a + bi * st.ab + hi * st.ah;
  const bf16* br = b + bi * st.bb + hi * st.bh;
  const bf16* cr = c + bi * st.cb + hi * st.ch;
  const int nchunks = (t + l - 1) / l;

  auto stage_x = [&](int buf) { return reinterpret_cast<TX*>(smem_raw + buf * sbytes); };
  auto stage_b = [&](int buf) {
    return reinterpret_cast<bf16*>(smem_raw + buf * sbytes + align16(size_t(lp) * BP * sizeof(TX)));
  };
  auto stage_a = [&](int buf) {
    return reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(stage_b(buf)) +
                                    2 * align16(size_t(lp) * ldb * 2));
  };
  // chunk ch into ring buffer buf; tile rows past the chunk are zero-filled
  auto stage = [&](int ch, int buf) {
    const int t0 = ch * l;
    const int rows = t - t0 < l ? t - t0 : l;
    TX* sx = stage_x(buf);
    bf16* sb = stage_b(buf);
    bf16* sc = sb + lp * ldb;
    float* sa = stage_a(buf);
    for (int i = tid; i < lp * XCH; i += kMmaThreads) {
      const int r = i / XCH, q = i % XCH;
      const bool in = r < rows;
      const TX* src = xr + (in ? (t0 + r) * st.xt : 0) + q * (16 / sizeof(TX));
      cp_async16(smem_addr(sx + r * BP + q * (16 / sizeof(TX))), src, in);
    }
    const int bch = n / 8;
    for (int i = tid; i < lp * bch; i += kMmaThreads) {
      const int r = i / bch, q = (i % bch) * 8;
      const bool in = r < rows;
      const long long tt = in ? t0 + r : 0;
      cp_async16(smem_addr(sb + r * ldb + q), br + tt * st.bt + q, in);
      cp_async16(smem_addr(sc + r * ldb + q), cr + tt * st.ct + q, in);
    }
    for (int r = tid; r < lp; r += kMmaThreads) {
      const bool in = r < rows;
      cp_async4(smem_addr(sa + r), ar + (in ? (t0 + r) * st.at : 0), in);
    }
  };

  for (int i = tid; i < 3 * n * LDX; i += kMmaThreads) ps[i] = __float2bfloat16(0.0f);
  // this warp's state rows 16 warp + g (+ 8), columns 8 nt + 2 tq (+ 1)
  float state[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) state[nt][e] = 0.0f;

  stage(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    const int buf = STAGES == 2 ? ch % 2 : 0;
    if (STAGES == 2) {
      if (ch + 1 < nchunks) stage(ch + 1, (ch + 1) % 2);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch has landed; the S planes of chunk ch - 1 are written
    const int t0 = ch * l;
    const int rows = t - t0 < l ? t - t0 : l;
    const TX* sx = stage_x(buf);
    const bf16* sb = stage_b(buf);
    const bf16* sc = sb + lp * ldb;

    // prefix sum (warp 0; pads are 0) beside the X planes (everyone)
    if (warp == 0) {
      const float* sa = stage_a(buf);
      float v[4];
      float run = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lane * 4 + e;
        run += r < lp ? sa[r] : 0.0f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += o;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lane * 4 + e;
        if (r < lp) scum[r] = (excl + v[e]) * kLog2e;  // log2 units: exp2 == exp
      }
    }
    for (int i = tid; i < lp * BP; i += kMmaThreads) {
      const int r = i / BP, col = i % BP;
      if (kSplitX) {
        bf16 h, m, lo;
        split3(to_f32(sx[i]), h, m, lo);
        px[r * LDX + col] = h;
        px[(lp + r) * LDX + col] = m;
        px[(2 * lp + r) * LDX + col] = lo;
      } else {
        px[r * LDX + col] = reinterpret_cast<const bf16*>(sx)[i];
      }
    }
    __syncthreads();  // cum and the X planes are ready

    // y, balanced over the warps: row block r has r + 1 key blocks, so the
    // warp owning a heavy block r (r > nrb - 1 - r) does its first `half`
    // key blocks and the warp owning the light block nrb - 1 - r the rest,
    // handing over the partial sum in shared memory (fragment order)
    const int nrb = lp / 16, half = (nrb + 1) / 2;
    const int mate = nrb - 1 - warp;  // the row block this warp pairs with
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;
    if (warp < nrb) {
      const int i0 = warp * 16;
      gx_rows<TX, BP>(acc, sc, sb, px, scum, i0, 0, mate < warp ? half : warp + 1, lp, ldb, nk,
                      lane);
      // exp(cum_i) C S with S the state before this chunk (zero at the first)
      if (ch > 0) {
        float cs[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) cs[nt][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kMaxN / 16; ++kk) {
          if (kk >= nk) break;
          uint32_t ca[4];
          ldmatrix_x4(ca, smem_addr(sc + (i0 + lane % 16) * ldb + kk * 16 + (lane / 16) * 8));
#pragma unroll
          for (int nt = 0; nt < NT; nt += 2) {
            float f[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
            for (int pl = 0; pl < 3; ++pl) {
              uint32_t sv[4];
              load_b<LDX>(sv, ps + pl * n * LDX, kk * 16, nt, lane);
              mma(f[0], ca, sv[0], sv[1]);
              mma(f[1], ca, sv[2], sv[3]);
            }
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) cs[nt + h][e] += f[h][e];
          }
        }
        const float ec[2] = {exp2f(scum[i0 + g]), exp2f(scum[i0 + g + 8])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = fmaf(ec[e / 2], cs[nt][e], acc[nt][e]);
      }
      if (mate > warp) {  // help the heavy row block `mate` with its last key blocks
        float help[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) help[nt][e] = 0.0f;
        gx_rows<TX, BP>(help, sc, sb, px, scum, mate * 16, half, mate + 1, lp, ldb, nk, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[((warp * NT + nt) * 4 + e) * 32 + lane] = help[nt][e];
      }
    }
    __syncthreads();  // G X and C S are done with the X and S planes; partials are in

    // the owners store y (heavy blocks add their helper's partial) while
    // everyone writes w X into the X planes, w_j = exp(cum_L - cum_j)
    if (warp < nrb) {
      if (mate < warp) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] += part[((mate * NT + nt) * 4 + e) * 32 + lane];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + g + 8 * h;
        if (r >= rows) continue;
        TX* out = yr + static_cast<long long>(t0 + r) * st.yt;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = nt * 8 + 2 * tq;
          if (kSplitX) {
            *reinterpret_cast<float2*>(out + col) = make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out + col) =
                __floats2bfloat162_rn(acc[nt][2 * h], acc[nt][2 * h + 1]);
          }
        }
      }
    }
    const float cum_last = scum[lp - 1];
    for (int i = tid; i < lp * BP; i += kMmaThreads) {
      const int r = i / BP, col = i % BP;
      bf16 h, m, lo;
      split3(exp2f(cum_last - scum[r]) * to_f32(sx[i]), h, m, lo);
      px[r * LDX + col] = h;
      px[(lp + r) * LDX + col] = m;
      px[(2 * lp + r) * LDX + col] = lo;
    }
    __syncthreads();

    // S = exp(cum_L) S + B^T (w X) for this warp's 16 state rows
    if (warp < nk) {
      const int n0 = warp * 16;
      float fresh[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) fresh[nt][e] = 0.0f;
      for (int kk = 0; kk < lp / 16; ++kk) {
        // A = B^T (state rows x keys) from b stored [key][state]: ldmatrix.trans
        uint32_t ba[4];
        ldmatrix_x4_trans(ba, smem_addr(sb + (kk * 16 + lane % 8 + (lane / 16) * 8) * ldb + n0 +
                                        ((lane / 8) % 2) * 8));
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          float f[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int pl = 0; pl < 3; ++pl) {
            uint32_t wv[4];
            load_b<LDX>(wv, px + pl * lp * LDX, kk * 16, nt, lane);
            mma(f[0], ba, wv[0], wv[1]);
            mma(f[1], ba, wv[2], wv[3]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) fresh[nt + h][e] += f[h][e];
        }
      }
      const float decay = exp2f(cum_last);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) state[nt][e] = fmaf(decay, state[nt][e], fresh[nt][e]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t sh, sm, sl;
          split3(state[nt][2 * h], state[nt][2 * h + 1], sh, sm, sl);
          const int at = (n0 + g + 8 * h) * LDX + nt * 8 + 2 * tq;
          *reinterpret_cast<uint32_t*>(ps + at) = sh;
          *reinterpret_cast<uint32_t*>(ps + n * LDX + at) = sm;
          *reinterpret_cast<uint32_t*>(ps + 2 * n * LDX + at) = sl;
        }
      }
    }
    __syncthreads();  // the ring buffer and the X planes are free again
    if (STAGES == 1 && ch + 1 < nchunks) {
      stage(ch + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
}

// The mma kernel's column block and ring stages.  One 300-token mamba2-370m
// sequence has 32 rows, and only 16 columns a block give the grid a block
// for (nearly) every SM; two ring stages fit at 16 columns.  The wider
// blocks (one stage) win only at several sequences prefilled together,
// which no path sends (tools/k4_block_sweep.py builds them beside this one).
constexpr int kMmaBlockP = 16;
constexpr int kMmaStages = 2;

template <typename TX, int BP, int STAGES>
cudaError_t launch_mma(const void* x, const void* log_a, const void* b, const void* c, void* y,
                       int nb, int nh, int t, int p, int n, int l, const Strides& st,
                       cudaStream_t stream) {
  static unsigned done = 0;
  const int lp = (l + 15) / 16 * 16;
  const size_t smem = mma_smem_bytes(lp, n, BP, STAGES, sizeof(TX));
  auto kernel = ssd_scan_mma_kernel<TX, BP, STAGES>;
  const cudaError_t err =
      allow_smem(kernel, mma_smem_bytes(kMaxL, kMaxN, BP, STAGES, sizeof(TX)), &done);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  const dim3 grid(nb * nh, p / BP);
  kernel<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(log_a), static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<TX*>(y), nh, t, n, l, st);
  return cudaGetLastError();
}

// Checks the mma kernel's shape rules and launches it at (BP, STAGES): bf16
// b / c, N a multiple of 16 up to one m16 block a warp, whole column
// blocks; chunks longer than a tile are walked as tile-long chunks.
template <int BP, int STAGES>
cudaError_t run_mma(const void* x, const void* log_a, const void* b, const void* c, void* y,
                    int nb, int nh, int t, int p, int n, int l, int x_dtype, int bc_dtype,
                    const Strides& st, cudaStream_t s) {
  if (bc_dtype != 1 || n % 16 != 0 || n > kMaxN || p % BP != 0 || p / BP > 65535)
    return cudaErrorInvalidValue;
  const int lc = l < kMaxL ? l : kMaxL;
  if (x_dtype == 0) return launch_mma<float, BP, STAGES>(x, log_a, b, c, y, nb, nh, t, p, n, lc, st, s);
  if (x_dtype == 1) return launch_mma<bf16, BP, STAGES>(x, log_a, b, c, y, nb, nh, t, p, n, lc, st, s);
  return cudaErrorInvalidValue;
}

// the mma kernel's dynamic shared memory at (BP, STAGES), chunk length l
size_t run_mma_smem(int l, int n, int bp, int stages, int x_dtype) {
  const int lc = l < kMaxL ? l : kMaxL;
  return mma_smem_bytes((lc + 15) / 16 * 16, n, bp, stages, x_dtype == 0 ? 4 : 2);
}

bool valid_call(int nb, int nh, int t, int p, int n, int l) {
  return nb >= 1 && nh >= 1 && t >= 1 && p >= 1 && n >= 1 && l >= 1 && l <= t &&
         static_cast<long long>(nb) * nh <= 2147483647LL;
}

Strides to_strides(const long long* strides) {
  Strides st;
  long long* dst = &st.xb;
  for (int i = 0; i < 15; ++i) dst[i] = strides[i];
  return st;
}

template <typename TX>
cudaError_t fma_by_bc(int bc_dtype, const void* x, const void* log_a, const void* b,
                      const void* c, void* y, int nb, int nh, int t, int p, int n, int l,
                      const Strides& st, cudaStream_t s) {
  switch (bc_dtype) {
    case 0: return launch_fma<TX, float>(x, log_a, b, c, y, nb, nh, t, p, n, l, st, s);
    case 1: return launch_fma<TX, bf16>(x, log_a, b, c, y, nb, nh, t, p, n, l, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ssd_scan_smem_bytes(int variant, int l, int n, int x_dtype) {
  if (variant == 0) return static_cast<int>(fma_smem_floats(l, n) * sizeof(float));
  if (variant != 1 || (x_dtype != 0 && x_dtype != 1)) return 0;
  return static_cast<int>(run_mma_smem(l, n, kMmaBlockP, kMmaStages, x_dtype));
}

extern "C" int ssd_scan(const void* x, const void* log_a, const void* b, const void* c, void* y,
                        int nb, int nh, int t, int p, int n, int l, int x_dtype, int bc_dtype,
                        const long long* strides, int variant, void* stream) {
  if (!valid_call(nb, nh, t, p, n, l)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = to_strides(strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (variant == 0) {
    if ((p + kFmaBlockP - 1) / kFmaBlockP > 65535) return static_cast<int>(err);
    if (x_dtype == 0) err = fma_by_bc<float>(bc_dtype, x, log_a, b, c, y, nb, nh, t, p, n, l, st, s);
    if (x_dtype == 1) err = fma_by_bc<bf16>(bc_dtype, x, log_a, b, c, y, nb, nh, t, p, n, l, st, s);
  } else if (variant == 1) {
    err = run_mma<kMmaBlockP, kMmaStages>(x, log_a, b, c, y, nb, nh, t, p, n, l, x_dtype, bc_dtype,
                                          st, s);
  }
  return static_cast<int>(err);
}
