// The K4 (ssd_scan) mma kernel at each (column block, ring stages) that
// tools/k4_block_sweep.py times, the shipped (16, 2) among them.  The tool
// builds this file into a library of its own (repro_torch.kernels._build,
// with the kernels' csrc/ on the include path); the port never loads it.
//
// C interface (bound with ctypes):
//   int ssd_scan_sweep(x, log_a, b, c, y, nb, nh, t, p, n, l, x_dtype,
//                      bc_dtype, strides, block_p, stages, stream)
//     ssd_scan's mma variant (csrc/ssd_scan.cu) at (block_p, stages) of
//     SSD_SWEEP_CONFIGS; cudaErrorInvalidValue for any other pair.
#include "ssd_scan.cu"

// Two ring stages fit in shared memory at 16 columns only.
#define SSD_SWEEP_CONFIGS(X) X(16, 2) X(32, 1) X(64, 1)

extern "C" int ssd_scan_sweep(const void* x, const void* log_a, const void* b, const void* c,
                              void* y, int nb, int nh, int t, int p, int n, int l, int x_dtype,
                              int bc_dtype, const long long* strides, int block_p, int stages,
                              void* stream) {
  if (!valid_call(nb, nh, t, p, n, l)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st = to_strides(strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SSD_SWEEP_CASE(BP, ST)                                                                 \
  if (block_p == BP && stages == ST)                                                           \
    return static_cast<int>(                                                                   \
        run_mma<BP, ST>(x, log_a, b, c, y, nb, nh, t, p, n, l, x_dtype, bc_dtype, st, s));
  SSD_SWEEP_CONFIGS(SSD_SWEEP_CASE)
#undef SSD_SWEEP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
