// B8: y = A x for an assembled sparse matrix in sliced ELL (f32).
//
// Replaces cuda_mpi_parallel_tpu/ops/pallas/spmv.py: shift_ell_matvec
// (kernel factory _make_kernel).  The TPU layout - lane-gather sheets over
// 128-lane chunks of a VMEM-resident x - is built for the TPU's one fast
// gather and is not carried over.  Here the host packer
// (ops/cuda/spmv.py, pack_sliced_ell) cuts the rows into slices of 32,
// pads each slice to its own longest row, and stores values and int32
// columns slot-major within the slice: slot k of the slice's row l sits
// at slice_ptr[s] + 32 k + l.  A padding slot holds column -1 and is
// skipped, so it adds nothing (not even 0 * inf).
//
// Bound on an H100: memory.  Each nonzero brings 8 bytes (value and
// column) that are used once, x and y are 4 bytes per row, and the flops
// (2 per nonzero) are far below the ridge.  Design against the bound:
//  * one thread per row, one warp per slice: at every slot the warp reads
//    32 consecutive values and 32 consecutive columns (two 128-byte
//    lines), so the matrix streams at full coalescing; per-slice widths
//    keep the padding to what the slice's own rows need;
//  * x is read through the read-only path (__ldg); for banded matrices
//    the rows of a warp touch neighbouring x entries, which L1/L2 serve;
//  * each row sums its slots in CSR order with _rn intrinsics, so the
//    plain twin, which adds the slots in the same order, equals the kernel
//    bit for bit.  No atomics: a row's sum belongs to one thread.
#include "common.cuh"

namespace cmpt {

constexpr int kSlice = 32;  // rows per slice (one warp)

__global__ void __launch_bounds__(256)
sliced_ell_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
                  const int64_t* __restrict__ slice_ptr,
                  const float* __restrict__ x, float* __restrict__ y,
                  int64_t n) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int64_t s = row / kSlice;
  const int lane = (int)(row % kSlice);
  const int64_t begin = slice_ptr[s] + lane, end = slice_ptr[s + 1];
  float acc = 0.0f;
  for (int64_t i = begin; i < end; i += kSlice) {
    const int c = cols[i];
    if (c >= 0) acc = add_rn(acc, mul_rn(vals[i], __ldg(x + c)));
  }
  y[row] = acc;
}

}  // namespace cmpt

extern "C" {

// y (n floats) is written.  vals/cols hold slice_ptr[n_slices] slots;
// slice_ptr has ceil(n / 32) + 1 int64 entries.
int cmpt_sliced_ell_spmv(const float* vals, const int* cols,
                         const int64_t* slice_ptr, const float* x, float* y,
                         int64_t n, cudaStream_t stream) {
  using namespace cmpt;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t blocks = ceil_div(n, threads);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  sliced_ell_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      vals, cols, slice_ptr, x, y, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
