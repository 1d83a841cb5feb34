// decode_attention — one query position per slot over the slot's KV cache,
// read in place, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The reference's decode attention is plain jnp
// (repro/models/attention.py:97-99, chunked_attention over the whole cache),
// and the port's plain version, models/attention.py:chunked_attention, walks
// the cache in key chunks of 1,024 positions, copying each chunk of K and V
// to f32 and running two f32 einsums, masks, a where, an amax, exps and the
// rescale as separate ops: about 64 launches a layer and an f32 copy of
// every cached K and V block on every step.  This kernel computes the same
// attention in one launch and reads the cache as it is stored.
//
// What it computes (exactly the decode call of chunked_attention; only the
// order of the sums differs).  q (B, 1, H, D), k and v (B, clen, Hkv, D),
// kpos (B, clen) int32, qpos (B,) -> o (B, 1, H, D) in q's dtype; head h
// attends with KV head h / g, g = H / Hkv.  Every value is widened to f32
// in registers; s = (q . k) * scale, s = -1e30 where not (kpos >= 0 and
// kpos <= qpos); online softmax in f32 starting from m = -1e30:
//
//   m_new = max(m, max(s)),  p = exp(s - m_new),  corr = exp(m - m_new)
//   l = l * corr + sum(p),   acc = acc * corr + p @ v
//
// and o = acc / max(l, 1e-30), rounded once to q's dtype.
//
// Live keys only.  Slot b's key loop stops at live = min(qpos + 1, clen).
// In a cache that does not roll, slot j only ever holds position j (prefill
// writes slots [0, n) with positions 0..n-1, decode writes slot pos) or -1,
// so no slot past qpos can pass the causal test; inside the range the mask
// is applied as above, so stale and unwritten entries count as they do in
// chunked_attention.  A rolling (sliding-window) cache is not taken: its
// caller keeps chunked_attention.
//
// Bound on this card: bytes.  Per (slot, KV head) the live K and V rows are
// read once, 4 D FLOPs per (query head, key) against 4 D bytes of bf16 K and
// V per key: g FLOPs a byte, g <= 8, far below the ~295 of the card's
// balance.  So tensor cores buy nothing; what counts is bytes in flight.
//
// Design.  Grid (split, KV head x head chunk, slot): a block takes one KV
// head of one slot, the query heads [c G, c G + G) of its group (G the
// group size rounded up to 1, 2, 4 or 8; groups wider than 8 take several
// head chunks, each reading the same K and V), and keys
// [split * split_len, ...) of its slot's live range.  A block whose range
// starts past its slot's live keys exits at once; the grid is sized on the
// host from clen and the SM count alone, so nothing reads the device's
// positions back.  Inside a block, LANES lanes (a power of two, 4 to 32)
// hold one key row as 16-byte vectors of K and V (8 bf16 or 4 f32 a
// vector); each group of LANES lanes walks its own keys, KB at a time with
// the K and V loads of all KB issued before any arithmetic (KB = 4 for
// groups of up to 2 heads, else 2: the register budget; KB = 8, and a
// register prefetch of the next KB keys, measured slower or no faster on
// an H100), reduces each q . k across its lanes with xor shuffles (which
// leave every lane the same sum), and keeps its own m, l and acc for its
// G heads in registers.  The groups'
// states are merged once in shared memory; a block that holds its slot's
// whole live range writes o, any other writes (m, l, acc) to a workspace,
// and the last of its slot's live blocks to arrive (an atomic count per
// (slot, KV head, chunk), reset by that block) merges the splits in order
// and writes o.  One launch a layer; no atomics on data, so the result does
// not depend on the order in which blocks run.
//
// Head dims 64, 80 (zamba2's shared block: ten vectors a bf16 row, sixteen
// lanes, six of them idle), 128 and 256 (gemma-2b), and 32 (every reduced
// configuration), bf16 or f32, any group size.
//
// C interface (bound with ctypes):
//   int decode_attention(q, k, v, kpos, qpos, qpos64, o, ws, counts, b, h,
//                        hkv, d, clen, G, split_len, nsplit, scale, dtype,
//                        stream)
//     dtype codes 0 float32, 1 bfloat16; qpos int64 if qpos64 else int32;
//     ws holds b * hkv * ceil(g / G) * nsplit * G * (d + 2) floats (unused
//     when nsplit is 1); counts b * hkv * ceil(g / G) ints, zero before the
//     launch and zero after it.  Returns the cudaGetLastError() value right
//     after the launch (0 on success), or cudaErrorInvalidValue for an
//     unsupported dtype, head dim, G or split count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 128;
// the most key splits of one (slot, KV head, chunk)
constexpr int kMaxSplits = 64;

__device__ __forceinline__ void widen(const uint4& u, float (&f)[8], const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& u, float (&f)[4], const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

template <typename T, int D, int G>
struct Shape {
  static constexpr int EPV = 16 / sizeof(T);                 // elements a vector
  static constexpr int NV = D / EPV;                         // vectors a row
  static constexpr int LANES = NV >= 32 ? 32 : pow2_at_least(NV);
  static constexpr int VPL = (NV + LANES - 1) / LANES;       // vectors a lane
  static constexpr int E = VPL * EPV;                        // elements a lane
  static constexpr int NG = kThreads / LANES;                // lane groups a block
  static constexpr int KB = G <= 2 ? 4 : 2;                  // keys a group loads at once
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const int* __restrict__ kpos,
                            const void* __restrict__ qpos, int qpos64, T* __restrict__ o,
                            float* __restrict__ ws, int* __restrict__ counts, int h, int hkv,
                            int g, int clen, int split_len, int nsplit, float scale) {
  using S = Shape<T, D, G>;
  constexpr int EPV = S::EPV, NV = S::NV, LANES = S::LANES, VPL = S::VPL, E = S::E,
                NG = S::NG, KB = S::KB;
  __shared__ float sh_acc[NG][G][D];
  __shared__ float sh_m[NG][G], sh_l[NG][G];
  __shared__ float sh_w[kMaxSplits > NG ? kMaxSplits : NG][G];
  __shared__ float sh_M[G], sh_L[G];
  __shared__ int sh_last;

  const int split = blockIdx.x;
  const int hc = (g + G - 1) / G;
  const int kvh = blockIdx.y / hc, chunk = blockIdx.y % hc;
  const int b = blockIdx.z;
  const long long qp = qpos64 ? static_cast<const long long*>(qpos)[b]
                              : static_cast<long long>(static_cast<const int*>(qpos)[b]);
  long long live_ll = qp + 1 < clen ? qp + 1 : clen;
  const int live = live_ll < 1 ? 1 : static_cast<int>(live_ll);
  const int nlive = (live + split_len - 1) / split_len;
  if (split >= nlive) return;
  const int k_lo = split * split_len;
  const int k_hi = min(k_lo + split_len, live);

  const int h0 = kvh * g + chunk * G;         // first query head of the block
  const int gn = min(G, g - chunk * G);       // its heads
  const int lane = threadIdx.x & 31;
  const int lig = lane % LANES;               // lane in its group
  const int grp = threadIdx.x / LANES;

  // q of the block's heads, widened: lane lig holds vectors lig + j LANES
  float qf[G][E];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int vi = lig + j * LANES;
      float f[EPV];
      if (i < gn && vi < NV) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            q + (static_cast<size_t>(b) * h + h0 + i) * D + vi * EPV);
        widen(u, f, static_cast<const T*>(nullptr));
      } else {
#pragma unroll
        for (int t = 0; t < EPV; ++t) f[t] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < EPV; ++t) qf[i][j * EPV + t] = f[t];
    }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }

  const size_t row = static_cast<size_t>(hkv) * D;           // elements between keys
  const T* kb = k + static_cast<size_t>(b) * clen * row + static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * clen * row + static_cast<size_t>(kvh) * D;
  const int* pb = kpos + static_cast<size_t>(b) * clen;

  // the loop bound is the block's, so every lane of a warp runs every
  // iteration and the shuffles see all 32 lanes
  for (int base = k_lo; base < k_hi; base += NG * KB) {
    uint4 ku[KB][VPL], vu[KB][VPL];
    int kp[KB];
    bool in[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      const int key = base + grp + j * NG;
      in[j] = key < k_hi;
      kp[j] = in[j] ? __ldg(pb + key) : -1;
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        const int vi = lig + c * LANES;
        if (in[j] && vi < NV) {
          const size_t off = static_cast<size_t>(key) * row + vi * EPV;
          ku[j][c] = __ldg(reinterpret_cast<const uint4*>(kb + off));
          vu[j][c] = __ldg(reinterpret_cast<const uint4*>(vb + off));
        } else {
          ku[j][c] = make_uint4(0, 0, 0, 0);
          vu[j][c] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    // scores, then the online update with p kept for the P V products
    float p[KB][G];
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float kf[E];
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        float f[EPV];
        widen(ku[j][c], f, static_cast<const T*>(nullptr));
#pragma unroll
        for (int t = 0; t < EPV; ++t) kf[c * EPV + t] = f[t];
      }
      const bool keep = kp[j] >= 0 && static_cast<long long>(kp[j]) <= qp;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qf[i][e], kf[e], dot);
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        // a key past the block's range takes no part at all (p = 0)
        p[j][i] = !in[j] ? __int_as_float(0xff800000) : keep ? dot * scale : kNeg;
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < KB; ++j) mx = fmaxf(mx, p[j][i]);
      const float corr = expf(m[i] - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        p[j][i] = expf(p[j][i] - mx);
        psum += p[j][i];
      }
      l[i] = l[i] * corr + psum;
      m[i] = mx;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      float vf[E];
#pragma unroll
      for (int c = 0; c < VPL; ++c) {
        float f[EPV];
        widen(vu[j][c], f, static_cast<const T*>(nullptr));
#pragma unroll
        for (int t = 0; t < EPV; ++t) vf[c * EPV + t] = f[t];
      }
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(p[j][i], vf[e], acc[i][e]);
    }
  }

  // merge the NG groups' states: M = max m, weights exp(m - M)
#pragma unroll
  for (int i = 0; i < G; ++i) {
#pragma unroll
    for (int c = 0; c < VPL; ++c) {
      const int vi = lig + c * LANES;
      if (vi < NV)
#pragma unroll
        for (int t = 0; t < EPV; ++t) sh_acc[grp][i][vi * EPV + t] = acc[i][c * EPV + t];
    }
    if (lig == 0) {
      sh_m[grp][i] = m[i];
      sh_l[grp][i] = l[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {
    const int i = threadIdx.x;
    float M = kNeg;
    for (int r = 0; r < NG; ++r) M = fmaxf(M, sh_m[r][i]);
    float L = 0.f;
    for (int r = 0; r < NG; ++r) {
      const float w = expf(sh_m[r][i] - M);
      sh_w[r][i] = w;
      L += w * sh_l[r][i];
    }
    sh_M[i] = M;
    sh_L[i] = L;
  }
  __syncthreads();

  const size_t y = static_cast<size_t>(b) * gridDim.y + blockIdx.y;  // (slot, head, chunk)
  if (nlive == 1) {
    for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
      const int i = idx / D, e = idx % D;
      float a = 0.f;
      for (int r = 0; r < NG; ++r) a += sh_w[r][i] * sh_acc[r][i][e];
      store(o + (static_cast<size_t>(b) * h + h0 + i) * D + e, a / fmaxf(sh_L[i], 1e-30f));
    }
    return;
  }

  // a split of several: (m, l, acc) of this split to the workspace, whose
  // record of (slot, head, chunk) y and split s starts at (y nsplit + s) G (D + 2)
  const size_t rec = static_cast<size_t>(G) * (D + 2);
  float* mine = ws + (y * nsplit + split) * rec;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int i = idx / D, e = idx % D;
    float a = 0.f;
    for (int r = 0; r < NG; ++r) a += sh_w[r][i] * sh_acc[r][i][e];
    mine[2 * G + idx] = a;
  }
  if (threadIdx.x < G) {
    mine[threadIdx.x] = sh_M[threadIdx.x];
    mine[G + threadIdx.x] = sh_L[threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sh_last = atomicAdd(counts + y, 1) == nlive - 1;
  __syncthreads();
  if (!sh_last) return;
  __threadfence();

  // the last live split merges all of them, in split order
  const float* all = ws + y * nsplit * rec;
  if (threadIdx.x < G) {
    const int i = threadIdx.x;
    float M = kNeg;
    for (int r = 0; r < nlive; ++r) M = fmaxf(M, __ldcg(all + r * rec + i));
    float L = 0.f;
    for (int r = 0; r < nlive; ++r) {
      const float w = expf(__ldcg(all + r * rec + i) - M);
      sh_w[r][i] = w;
      L += w * __ldcg(all + r * rec + G + i);
    }
    sh_L[i] = L;
  }
  if (threadIdx.x == 0) counts[y] = 0;
  __syncthreads();
  for (int idx = threadIdx.x; idx < gn * D; idx += kThreads) {
    const int i = idx / D;
    float a = 0.f;
    for (int r = 0; r < nlive; ++r) a += sh_w[r][i] * __ldcg(all + r * rec + 2 * G + idx);
    store(o + (static_cast<size_t>(b) * h + h0 + i) * D + idx % D, a / fmaxf(sh_L[i], 1e-30f));
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kpos,
                   const void* qpos, int qpos64, void* o, float* ws, int* counts, int b, int h,
                   int hkv, int clen, int split_len, int nsplit, float scale, cudaStream_t s) {
  const int g = h / hkv;
  const dim3 grid(nsplit, hkv * ((g + G - 1) / G), b);
  decode_attention_kernel<T, D, G><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kpos, qpos,
      qpos64, static_cast<T*>(o), ws, counts, h, hkv, g, clen, split_len, nsplit, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int G, const void* q, const void* k, const void* v, const int* kpos,
                     const void* qpos, int qpos64, void* o, float* ws, int* counts, int b, int h,
                     int hkv, int clen, int split_len, int nsplit, float scale, cudaStream_t s) {
  switch (G) {
#define DA_G(GG)                                                                             \
  case GG:                                                                                   \
    return launch<T, D, GG>(q, k, v, kpos, qpos, qpos64, o, ws, counts, b, h, hkv, clen,   \
                            split_len, nsplit, scale, s);
    DA_G(1) DA_G(2) DA_G(4) DA_G(8)
#undef DA_G
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_dim(int d, int G, const void* q, const void* k, const void* v, const int* kpos,
                   const void* qpos, int qpos64, void* o, float* ws, int* counts, int b, int h,
                   int hkv, int clen, int split_len, int nsplit, float scale, cudaStream_t s) {
  switch (d) {
#define DA_D(DD)                                                                          \
  case DD:                                                                                \
    return by_group<T, DD>(G, q, k, v, kpos, qpos, qpos64, o, ws, counts, b, h, hkv, clen, \
                           split_len, nsplit, scale, s);
    DA_D(32) DA_D(64) DA_D(80) DA_D(128) DA_D(256)
#undef DA_D
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention(const void* q, const void* k, const void* v, const int* kpos,
                                const void* qpos, int qpos64, void* o, float* ws, int* counts,
                                int b, int h, int hkv, int d, int clen, int G, int split_len,
                                int nsplit, float scale, int dtype, void* stream) {
  if (nsplit < 1 || nsplit > kMaxSplits || split_len < 1 || hkv < 1 || h % hkv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = by_dim<float>(d, G, q, k, v, kpos, qpos, qpos64, o, ws, counts, b, h, hkv, clen,
                          split_len, nsplit, scale, s);
      break;
    case 1:
      err = by_dim<__nv_bfloat16>(d, G, q, k, v, kpos, qpos, qpos64, o, ws, counts, b, h, hkv,
                                  clen, split_len, nsplit, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
