// The K2 (ame_elementwise) add, without ReLU, at each (threads a block,
// 16-byte vectors a thread) that tools/k4_block_sweep.py times, the shipped
// (128, 1) among them.  The tool builds this file into a library of its own
// (repro_torch.kernels._build, with the kernels' csrc/ on the include
// path); the port never loads it.
//
// C interface (bound with ctypes):
//   int ame_elementwise_sweep(a, b, o, n, dtype, threads, vecs, stream)
//     ame_elementwise's add (csrc/ame_elementwise.cu) at (threads, vecs) of
//     EW_SWEEP_CONFIGS; cudaErrorInvalidValue for any other pair or dtype.
#include "ame_elementwise.cu"

#define EW_SWEEP_CONFIGS(X) \
  X(128, 1) X(128, 2) X(128, 4) X(256, 1) X(256, 2) X(256, 4) X(512, 1) X(512, 2) X(512, 4)

namespace {

template <typename T>
cudaError_t by_config(int threads, int vecs, const void* a, const void* b, void* o, long long n,
                      cudaStream_t s) {
#define EW_SWEEP_CASE(TH, V) \
  if (threads == TH && vecs == V) return launch<T, 0, false, TH, V>(a, b, o, n, s);
  EW_SWEEP_CONFIGS(EW_SWEEP_CASE)
#undef EW_SWEEP_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ame_elementwise_sweep(const void* a, const void* b, void* o, long long n, int dtype,
                                     int threads, int vecs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = by_config<float>(threads, vecs, a, b, o, n, s); break;
    case 1: err = by_config<__nv_bfloat16>(threads, vecs, a, b, o, n, s); break;
    case 2: err = by_config<__half>(threads, vecs, a, b, o, n, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
