// ame_elementwise — fused mfadd / mfsub / mfmul (+ ReLU) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/elementwise.py:_ew_kernel
// (pallas_call at elementwise.py:50): o = a + b, a - b or a * b over a pair
// of 2-D operands of one shape and dtype, with an optional ReLU applied on
// writeback.  Each operand is read once and the result written once.
//
// Design.  The TPU version cuts the operands into (256, 512) VMEM tiles and
// pads the ragged edge; none of that means anything here.  The operands are
// contiguous, so the kernel sees one flat array of n elements, one launch
// per call.  Where all three pointers are 16-byte aligned the array is
// n_vec 16-byte vectors (4 f32 or 8 bf16 / f16 values) and a scalar tail of
// n % (16 / sizeof(T)) elements; a misaligned view is n scalars.  Each
// thread owns VECS vectors (or scalars) of a block's THREADS x VECS and
// issues all its loads of a and of b before any arithmetic, so VECS x 32
// bytes are in flight per thread; the vectors' loads and stores carry the
// streaming hint (ld.global.cs / st.global.cs: nothing is reused).  The
// grid covers the array in one pass, block k taking items [k THREADS VECS,
// (k + 1) THREADS VECS).  THREADS and VECS were chosen by
// tools/k4_block_sweep.py at the two model cases of chip_smoke.py (a
// persistent grid of the resident blocks measured 8-10 % slower there and
// is not kept).
//
// Numerics.  Every value is widened to f32, the operation is done once in
// f32 and the result is rounded once to the operand type.  For bf16 and f16
// that is the correctly rounded result (f32 has p = 24 >= 2p + 2 bits for
// both, so rounding twice is harmless, and the product of two 11-bit or
// 8-bit significands is exact in f32), which is what PyTorch computes: the
// kernel is held bit for bit against torch's own +, -, *.  ReLU is applied
// after the rounding, as the reference applies it to the rounded result,
// and as `v <= 0 ? +0 : v`, which is jnp.maximum(v, 0): a NaN passes
// through (fmaxf(NaN, 0) would give 0) and -0 becomes +0.  Built without
// --use_fast_math, so f32 denormals are kept.
//
// Bound on this card: bytes.  One FLOP per 3 x sizeof(T) bytes moved is far
// below the H100's ~295 FLOP/byte balance; the least time is
// 3 n sizeof(T) / 3.35 TB/s.
//
// C interface (bound with ctypes):
//   int ame_elementwise(a, b, o, n, dtype, kind, relu, stream)
//     a, b, o: n contiguous elements; dtype codes 0 float32, 1 bfloat16,
//     2 float16; kind 0 add, 1 sub, 2 mul; relu 0 or 1.  Returns the
//     cudaGetLastError() value right after the launch (0 on success), or
//     cudaErrorInvalidValue for an unsupported dtype or kind.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// (threads, vectors per thread) of the pass: the fastest at (8192, 8192)
// bf16 in the sweep; more vectors a thread gained nothing there, as 16
// resident blocks of 128 threads an SM already keep 64 KB of loads in
// flight per SM
constexpr int kThreads = 128;
constexpr int kVecs = 1;

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

template <typename T, int KIND, bool RELU>
__device__ __forceinline__ T apply(T a, T b) {
  const float x = to_f32(a), y = to_f32(b);
  float r;
  if (KIND == 0) {
    r = __fadd_rn(x, y);
  } else if (KIND == 1) {
    r = __fsub_rn(x, y);
  } else {
    r = __fmul_rn(x, y);
  }
  T o = from_f32<T>(r);
  if (RELU && to_f32(o) <= 0.0f) o = from_f32<T>(0.0f);
  return o;
}

// One launch per call over items: the vectors and, past them, the scalar
// tail [n_vec kVec, n).  Block k takes the THREADS VECS items from
// k THREADS VECS, thread i items i, i + THREADS, ...  A misaligned view
// passes n_vec = 0 and takes the whole array one element at a time.
template <typename T, int KIND, bool RELU, int THREADS, int VECS>
__global__ void __launch_bounds__(THREADS)
ew_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ o, long long n_vec,
          long long n) {
  constexpr int kVec = 16 / sizeof(T);
  const uint4* va = reinterpret_cast<const uint4*>(a);
  const uint4* vb = reinterpret_cast<const uint4*>(b);
  uint4* vo = reinterpret_cast<uint4*>(o);
  const long long tail0 = n_vec * kVec;
  const long long base = static_cast<long long>(blockIdx.x) * THREADS * VECS + threadIdx.x;
  uint4 xa[VECS], xb[VECS];
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    const long long i = base + u * THREADS;
    if (i < n_vec) {
      xa[u] = __ldcs(va + i);
      xb[u] = __ldcs(vb + i);
    }
  }
#pragma unroll
  for (int u = 0; u < VECS; ++u) {
    const long long i = base + u * THREADS;
    if (i < n_vec) {
      uint4 xo;
      const T* ta = reinterpret_cast<const T*>(&xa[u]);
      const T* tb = reinterpret_cast<const T*>(&xb[u]);
      T* to = reinterpret_cast<T*>(&xo);
#pragma unroll
      for (int e = 0; e < kVec; ++e) to[e] = apply<T, KIND, RELU>(ta[e], tb[e]);
      __stcs(vo + i, xo);
    }
  }
  if (base < n - tail0) {
    T sa[VECS], sb[VECS];
#pragma unroll
    for (int u = 0; u < VECS; ++u) {
      const long long i = tail0 + base + u * THREADS;
      if (i < n) {
        sa[u] = a[i];
        sb[u] = b[i];
      }
    }
#pragma unroll
    for (int u = 0; u < VECS; ++u) {
      const long long i = tail0 + base + u * THREADS;
      if (i < n) o[i] = apply<T, KIND, RELU>(sa[u], sb[u]);
    }
  }
}

template <typename T, int KIND, bool RELU, int THREADS, int VECS>
cudaError_t launch(const void* a, const void* b, void* o, long long n, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr long long kPer = static_cast<long long>(THREADS) * VECS;
  if (n <= 0) return cudaSuccess;
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(o)) % 16) == 0;
  const long long n_vec = aligned ? n / kVec : 0;
  const long long tail = n - n_vec * kVec;
  const long long items = n_vec > tail ? n_vec : tail;
  const long long blocks = (items + kPer - 1) / kPer;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  ew_kernel<T, KIND, RELU, THREADS, VECS><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(o), n_vec, n);
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t by_relu(int relu, const void* a, const void* b, void* o, long long n,
                    cudaStream_t s) {
  return relu ? launch<T, KIND, true, kThreads, kVecs>(a, b, o, n, s)
              : launch<T, KIND, false, kThreads, kVecs>(a, b, o, n, s);
}

template <typename T>
cudaError_t by_kind(int kind, int relu, const void* a, const void* b, void* o, long long n,
                    cudaStream_t s) {
  switch (kind) {
    case 0: return by_relu<T, 0>(relu, a, b, o, n, s);
    case 1: return by_relu<T, 1>(relu, a, b, o, n, s);
    case 2: return by_relu<T, 2>(relu, a, b, o, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int ame_elementwise(const void* a, const void* b, void* o, long long n, int dtype,
                               int kind, int relu, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = by_kind<float>(kind, relu, a, b, o, n, s); break;
    case 1: err = by_kind<__nv_bfloat16>(kind, relu, a, b, o, n, s); break;
    case 2: err = by_kind<__half>(kind, relu, a, b, o, n, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
