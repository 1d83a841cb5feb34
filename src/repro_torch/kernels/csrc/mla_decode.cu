// mla_decode — MLA's absorbed decode attention over the bf16 latent cache,
// read in place, for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The reference attends MLA in plain jnp
// (repro/models/attention.py, the absorbed form through chunked attention),
// and the port's plain version, the decode branch of
// models/attention.py:mla_apply, concatenates the whole latent cache into a
// new (B, clen, 1, r + rd) tensor on every layer, then runs
// chunked_attention over all clen positions of every slot: an f32 copy of
// each 1,024-position chunk, f32 GEMMs of all H heads against every
// position, and masks applied afterwards.  This kernel computes the same
// attention in one launch, reads ckv and kr where they are stored, and
// reads only each slot's live positions.
//
// What it computes (exactly the decode call
//   chunked_attention(qq, cat([ckv, kr], -1)[:, :, None], ckv[:, :, None],
//                     causal=True, q_offset=qpos)
// only the order of the sums differs).  qq (B, 1, H, D) with D = r + rd,
// ckv (B, clen, r) and kr (B, clen, rd), all bf16; qpos (B,) -> o (B, 1, H,
// r) bf16.  Key j of slot b is [ckv[b, j], kr[b, j]] and its value ckv[b,
// j]; it is seen where j <= qpos[b].  s = (qq . k) * scale in f32 (the
// bf16 x bf16 products are exact, summed in f32); online softmax in f32
// from m = -1e30:
//
//   m_new = max(m, max(s)),  p = exp(s - m_new),  corr = exp(m - m_new)
//   l = l * corr + sum(p),   acc = acc * corr + p @ v
//
// and o = acc / max(l, 1e-30), rounded once to bf16.  A key past qpos
// scores -1e30 in chunked_attention and adds exp(-1e30 - m) = 0, so the
// kernel leaves it out: slot b reads keys 0 .. live - 1, live = min(qpos +
// 1, clen), and no byte of the cache past them.
//
// Bound on this card.  Per slot and live key, the 1,152 bytes of its
// latent (r = 512, rd = 64) serve all H = 128 heads: 2 H (D + r) = 278,528
// FLOPs against 1,152 bytes, 242 FLOP/B, just under the card's ridge of
// ~295 (bf16 at 989 TFLOP/s over 3.35 TB/s); with qq read and o written
// once the cell's step is bound by bytes, but only just.  So this is a
// tensor-core kernel: the heads are the rows of mma.sync.m16n8k16 tiles,
// one staged tile of keys feeds 64 heads, and P V keeps ~16 bits of P by
// splitting it into two bf16 halves (chunked_attention multiplies P in
// f32; P rounded once to bf16 moves an output by up to ~2^-9 of
// sum(p |v|) / l), 1.47 x the FLOPs of the score and value products.
//
// Design.  Grid (split, head block, slot): a block takes kRows = 64 query
// heads of one slot (rows past H are zero and never stored) and keys
// [split * split_len, ...) of the slot's live range; a block whose range
// starts past the live keys exits at once.  The grid is sized on the host
// from B, H, clen and the SM count alone, so nothing reads the positions
// back.  The block's 64 rows of qq are staged once in shared memory; the
// keys arrive kKeys = 32 at a time by cp.async, straight from ckv and kr
// into one (32, D) tile (ckv's row in its first r columns, kr's after),
// double-buffered so tile i + 1 loads while tile i computes.  The tile is
// both K (all D columns) and V (its first r).  Warps: 4 row groups of 16
// heads x CG column groups of VC = min(r, 256) value columns, so a warp's
// f32 accumulator is 16 x VC (128 registers a thread at r = 512).  For the
// scores each of a row group's CG warps takes 1 / CG of the depth D for
// all 32 keys of the tile (no product is computed twice, and the row group
// reads each element of its rows of qq once a tile), and the row group's warps
// add their partial scores through shared memory in a fixed order; each
// then holds the same 16 x 32 scores of its rows, runs the online softmax in
// registers (the four lanes of a quad share a row, as in
// flash_attention.cu) and adds P V for its columns, V read by
// ldmatrix.trans.  A block that holds its slot's whole live range writes
// o; any other writes (m, l, acc) to a workspace, and the last of its
// (slot, head block)'s live splits to arrive (an atomic count, reset by
// that block) merges the splits in split order and writes o.  One launch a
// layer; no atomics on data, so the result does not depend on the order in
// which blocks run.
//
// Widths: (r, rd) = (512, 64), DeepSeek-V3's, and (32, 16), every reduced
// configuration's; any head count.
//
// C interface (bound with ctypes):
//   int mla_decode(q, ckv, kr, qpos, qpos64, o, ws, counts, b, h, r, rd,
//                  clen, split_len, nsplit, scale, stream)
//     qpos int64 if qpos64 else int32; ws holds b * ceil(h / 64) * nsplit *
//     64 * (r + 2) floats (unused when nsplit is 1); counts b * ceil(h / 64)
//     ints, zero before the launch and zero after it.  Returns the
//     cudaGetLastError() value right after the launch (0 on success), or
//     cudaErrorInvalidValue for unsupported widths or split counts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr float kNeg = -1e30f;
constexpr int kRows = 64;       // query heads a block
constexpr int kKeys = 32;       // keys a staged tile
constexpr int kMaxSplits = 32;  // the most key splits of one (slot, head block)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int R, int RD> struct MlaTile {
  static constexpr int D = R + RD;               // key width
  static constexpr int LD = D + 8;               // a staged row, bf16: an odd count of 16 bytes
  static constexpr int VC = R < 256 ? R : 256;   // value columns a warp
  static constexpr int CG = R / VC;              // column groups
  static constexpr int NT = 4 * CG * 32;         // threads: 4 row groups x CG
  static constexpr int KD = D / 16 / CG;         // k16 steps of the scores' depth a warp takes
  static constexpr int NS = kKeys / 8;           // n8 score fragments of a tile
  static constexpr int NO = VC / 8;              // n8 accumulator fragments a warp
  static constexpr size_t kStage = static_cast<size_t>(kRows + 2 * kKeys) * LD * 2;
  static constexpr size_t kTrade = CG > 1 ? static_cast<size_t>(NT) * NS * 4 * 4 : 0;
  static constexpr size_t kMerge = static_cast<size_t>(kMaxSplits + 1) * kRows * 4;
  static constexpr size_t kSmem =
      kStage + kTrade > kMerge ? kStage + kTrade : kMerge;
  static_assert(R % VC == 0 && VC % 16 == 0 && D % 16 == 0 && RD % 8 == 0, "mma tiles");
  static_assert((D / 16) % CG == 0 && kKeys % 16 == 0, "whole k16 steps a warp");
};

template <int R, int RD>
__global__ void __launch_bounds__(MlaTile<R, RD>::NT, 1)
    mla_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ ckv,
                      const bf16* __restrict__ kr, const void* __restrict__ qpos, int qpos64,
                      bf16* __restrict__ o, float* __restrict__ ws, int* __restrict__ counts,
                      int h, int clen, int split_len, int nsplit, float scale) {
  using L = MlaTile<R, RD>;
  constexpr int D = L::D, LD = L::LD, VC = L::VC, CG = L::CG, NT = L::NT, KD = L::KD,
                NS = L::NS, NO = L::NO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);   // (kRows, LD)
  bf16* sk = sq + kRows * LD;                     // two (kKeys, LD) tiles
  float* trade = reinterpret_cast<float*>(sk + 2 * kKeys * LD);

  const int split = blockIdx.x, hb = blockIdx.y, b = blockIdx.z;
  const long long qp = qpos64 ? static_cast<const long long*>(qpos)[b]
                              : static_cast<long long>(static_cast<const int*>(qpos)[b]);
  const long long live_ll = qp + 1 < clen ? qp + 1 : clen;
  const int live = live_ll < 1 ? 1 : static_cast<int>(live_ll);
  const int nlive = (live + split_len - 1) / split_len;
  if (split >= nlive) return;
  const int k_lo = split * split_len;
  const int k_hi = min(k_lo + split_len, live);
  const int ntiles = (k_hi - k_lo + kKeys - 1) / kKeys;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rg = warp % 4, ch = warp / 4;   // row group, column group
  const int g = lane / 4, t = lane % 4;
  const int h0 = hb * kRows;
  const int rows = min(kRows, h - h0);

  // the block's rows of qq; rows past H are zeros
  const bf16* qb = q + (static_cast<size_t>(b) * h + h0) * D;
  for (int i = tid; i < kRows * (D / 8); i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool in = r < rows;
    cp_async16(smem_addr(sq + r * LD + c), in ? qb + static_cast<size_t>(r) * D + c : qb, in);
  }
  // keys [k0, k0 + kKeys) of the slot into a tile: ckv's row, then kr's;
  // keys past the block's range are zeros, and their bytes are not read
  const bf16* cb = ckv + static_cast<size_t>(b) * clen * R;
  const bf16* rb = kr + static_cast<size_t>(b) * clen * RD;
  auto stage = [&](bf16* dst, int k0) {
    for (int i = tid; i < kKeys * (D / 8); i += NT) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int key = k0 + r;
      const bool in = key < k_hi;
      const bf16* src = !in ? cb
                        : c < R ? cb + static_cast<size_t>(key) * R + c
                                : rb + static_cast<size_t>(key) * RD + (c - R);
      cp_async16(smem_addr(dst + r * LD + c), src, in);
    }
  };
  stage(sk, k_lo);
  cp_async_commit();

  // this thread's rows: rg * 16 + g and + 8
  float m_r[2] = {kNeg, kNeg};   // running max
  float l_r[2] = {0.0f, 0.0f};   // this thread's share of the running sum
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = k_lo + it * kKeys;
    if (it + 1 < ntiles) stage(sk + ((it + 1) & 1) * kKeys * LD, k0 + kKeys);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it (and qq) have landed
    const bf16* kt = sk + (it & 1) * kKeys * LD;

    // this warp's share of the scores: its 16 rows x the tile's 32 keys over
    // the depth [ch KD, ch KD + KD) k16 steps
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll 2
    for (int kk = ch * KD; kk < ch * KD + KD; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_addr(sq + (rg * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8));
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_addr(kt + (j * 8 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                                  ((lane / 8) % 2) * 8));
        Mma<bf16>::run(s[j], qa, kb[0], kb[1]);
        Mma<bf16>::run(s[j + 1], qa, kb[2], kb[3]);
      }
    }
    // the row group's warps add their shares in column-group order, so
    // every one of them holds the same sums
    if constexpr (CG > 1) {
      float* at = trade + static_cast<size_t>(warp * 32 + lane) * NS * 4;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        *reinterpret_cast<float4*>(at + j * 4) = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      __syncthreads();
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const float* from = trade + static_cast<size_t>((c * 4 + rg) * 32 + lane) * NS * 4;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(from + j * 4);
          s[j][0] = c == 0 ? v.x : s[j][0] + v.x;
          s[j][1] = c == 0 ? v.y : s[j][1] + v.y;
          s[j][2] = c == 0 ? v.z : s[j][2] + v.z;
          s[j][3] = c == 0 ? v.w : s[j][3] + v.w;
        }
      }
    }
    // scaled in f32; a key past the block's range scores -1e30 (p = 0)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e % 2);
        s[j][e] = key < k_hi ? s[j][e] * scale : kNeg;
      }

    // online softmax on the two rows this thread holds
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx);
      const float corr = expf(m_r[hh] - m_new);
      m_r[hh] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * hh] = expf(s[j][2 * hh] - m_new);
        s[j][2 * hh + 1] = expf(s[j][2 * hh + 1] - m_new);
        sum += s[j][2 * hh] + s[j][2 * hh + 1];
      }
      l_r[hh] = l_r[hh] * corr + sum;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * hh] *= corr;
        acc[n][2 * hh + 1] *= corr;
      }
    }

    // acc += P V over this warp's VC columns, P = P_hi + P_lo (both bf16)
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
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
        ldmatrix_x4_trans(vb, smem_addr(kt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                                        ch * VC + n * 8 + (lane / 16) * 8));
        Mma<bf16>::run(acc[n], ah, vb[0], vb[1]);
        Mma<bf16>::run(acc[n], al, vb[0], vb[1]);
        Mma<bf16>::run(acc[n + 1], ah, vb[2], vb[3]);
        Mma<bf16>::run(acc[n + 1], al, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this tile and the trade
  }
  cp_async_wait<0>();

  // the row sums: each lane of a quad holds a quarter of its row's keys
  float l_row[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_row[hh] = l;
  }

  if (nlive == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rg * 16 + g + 8 * hh;
      if (row >= rows) continue;
      const float l = fmaxf(l_row[hh], 1e-30f);
      bf16* out = o + (static_cast<size_t>(b) * h + h0 + row) * R + ch * VC;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * hh] / l, acc[n][2 * hh + 1] / l);
    }
    return;
  }

  // a split of several: (m, l, acc) of this split to the workspace; the
  // record of (slot, head block) y and split s starts at (y nsplit + s) rec
  const size_t y = static_cast<size_t>(b) * gridDim.y + hb;
  constexpr size_t rec = static_cast<size_t>(kRows) * (R + 2);
  float* mine_ws = ws + (y * nsplit + split) * rec;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rg * 16 + g + 8 * hh;
    if (ch == 0 && t == 0) {
      mine_ws[row] = m_r[hh];
      mine_ws[kRows + row] = l_row[hh];
    }
    float* at = mine_ws + 2 * kRows + static_cast<size_t>(row) * R + ch * VC;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(at + n * 8 + 2 * t) = make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  }
  __threadfence();
  __shared__ int sh_last;
  __syncthreads();
  if (tid == 0) sh_last = atomicAdd(counts + y, 1) == nlive - 1;
  __syncthreads();
  if (!sh_last) return;
  __threadfence();

  // the last live split merges all of them, in split order
  float* sw = reinterpret_cast<float*>(smem_raw);   // (kMaxSplits, kRows) weights
  float* sl = sw + kMaxSplits * kRows;              // (kRows) sums
  const float* all = ws + y * nsplit * rec;
  if (tid < kRows) {
    float M = kNeg;
    for (int r = 0; r < nlive; ++r) M = fmaxf(M, __ldcg(all + r * rec + tid));
    float Ls = 0.0f;
    for (int r = 0; r < nlive; ++r) {
      const float w = expf(__ldcg(all + r * rec + tid) - M);
      sw[r * kRows + tid] = w;
      Ls += w * __ldcg(all + r * rec + kRows + tid);
    }
    sl[tid] = Ls;
  }
  if (tid == 0) counts[y] = 0;
  __syncthreads();
  // each thread merges V4 runs of four accumulator floats, all of a
  // split's loads in flight at once
  constexpr int V4 = kRows * R / (4 * NT);
  static_assert(kRows * R % (4 * NT) == 0 && R % 4 == 0, "whole float4 runs a thread");
  float4 a[V4];
#pragma unroll
  for (int p = 0; p < V4; ++p) a[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int r = 0; r < nlive; ++r) {
    const float4* part = reinterpret_cast<const float4*>(all + r * rec + 2 * kRows);
#pragma unroll
    for (int p = 0; p < V4; ++p) {
      const int v = tid + p * NT;
      const float w = sw[r * kRows + v * 4 / R];
      const float4 x = __ldcg(part + v);
      a[p].x += w * x.x;
      a[p].y += w * x.y;
      a[p].z += w * x.z;
      a[p].w += w * x.w;
    }
  }
  bf16* ob = o + (static_cast<size_t>(b) * h + h0) * R;
#pragma unroll
  for (int p = 0; p < V4; ++p) {
    const int v = tid + p * NT, i = v * 4 / R;
    if (i >= rows) continue;
    const float l = fmaxf(sl[i], 1e-30f);
    __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(ob + v * 4);
    at[0] = __floats2bfloat162_rn(a[p].x / l, a[p].y / l);
    at[1] = __floats2bfloat162_rn(a[p].z / l, a[p].w / l);
  }
}

template <int R, int RD>
cudaError_t launch(const void* q, const void* ckv, const void* kr, const void* qpos, int qpos64,
                   void* o, float* ws, int* counts, int b, int h, int clen, int split_len,
                   int nsplit, float scale, cudaStream_t s) {
  using L = MlaTile<R, RD>;
  static unsigned done = 0;
  auto kernel = mla_decode_kernel<R, RD>;
  const cudaError_t err = allow_smem(kernel, L::kSmem, &done);
  if (err != cudaSuccess) return err;
  const dim3 grid(nsplit, (h + kRows - 1) / kRows, b);
  kernel<<<grid, L::NT, L::kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(ckv), static_cast<const bf16*>(kr),
      qpos, qpos64, static_cast<bf16*>(o), ws, counts, h, clen, split_len, nsplit, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mla_decode(const void* q, const void* ckv, const void* kr, const void* qpos,
                          int qpos64, void* o, float* ws, int* counts, int b, int h, int r, int rd,
                          int clen, int split_len, int nsplit, float scale, void* stream) {
  if (nsplit < 1 || nsplit > kMaxSplits || split_len < 1 || b < 1 || h < 1 || clen < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (r == 512 && rd == 64) {
    err = launch<512, 64>(q, ckv, kr, qpos, qpos64, o, ws, counts, b, h, clen, split_len, nsplit,
                          scale, s);
  } else if (r == 32 && rd == 16) {
    err = launch<32, 16>(q, ckv, kr, qpos, qpos64, o, ws, counts, b, h, clen, split_len, nsplit,
                         scale, s);
  }
  return static_cast<int>(err);
}
