// B1/B2: the matrix-free Poisson stencils, y = scale * (Laplacian of x)
// with zero Dirichlet edges.
//
// Replaces cuda_mpi_parallel_tpu/ops/pallas/stencil.py: stencil2d_apply
// (_stencil2d_kernel) and stencil3d_apply (_stencil3d_kernel).
//
// Bound on an H100: memory.  The function reads x once and writes y once
// (2 planes: 134 MB at 256^3 f32, about 40 us at 3.35 TB/s) and does 8
// (3D) or 6 (2D) flops per point, far below the card's ridge.  The TPU
// kernel streamed double-buffered slabs through VMEM; here a thread walks
// kPlanes points along the slowest axis keeping its own column's
// previous/current/next values in registers, so DRAM sees each x value
// about once and the in-plane neighbours are served by L1/L2.  Nothing is
// padded in memory: edges read as zero.
#include "common.cuh"

namespace cmpt {

template <typename T, bool THREE_D>
__global__ void __launch_bounds__(256)
stencil_kernel(const T* __restrict__ x, T* __restrict__ y,
               const T* __restrict__ scale_p, Grid g) {
  const T scale = *scale_p;
  walk_column<T, THREE_D>(
      g, [=](int64_t o) { return x[o]; },
      [=](int64_t o, T, T lap) { y[o] = mul_rn(scale, lap); });
}

template <typename T>
int launch_stencil(const T* x, T* y, const T* scale, int64_t n0, int64_t n1,
                   int64_t n2, int three_d, cudaStream_t stream) {
  const Grid g{n0, n1, n2};
  const int64_t blocks = tile_blocks(g, three_d != 0);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const dim3 block = tile_block(three_d != 0);
  if (three_d)
    stencil_kernel<T, true><<<(unsigned)blocks, block, 0, stream>>>(x, y, scale, g);
  else
    stencil_kernel<T, false><<<(unsigned)blocks, block, 0, stream>>>(x, y, scale, g);
  return (int)cudaGetLastError();
}

}  // namespace cmpt

extern "C" {

// 2D grids pass (n0, n1, n2) = (nx, 1, ny) and three_d = 0.
int cmpt_stencil_f32(const float* x, float* y, const float* scale, int64_t n0,
                     int64_t n1, int64_t n2, int three_d, cudaStream_t stream) {
  return cmpt::launch_stencil<float>(x, y, scale, n0, n1, n2, three_d, stream);
}

int cmpt_stencil_f64(const double* x, double* y, const double* scale,
                     int64_t n0, int64_t n1, int64_t n2, int three_d,
                     cudaStream_t stream) {
  return cmpt::launch_stencil<double>(x, y, scale, n0, n1, n2, three_d, stream);
}

// Blocks of the tile walk for this grid: the length of the partial-sum
// scratch the fused CG passes need.  -1 when the grid is too large.
int64_t cmpt_tile_blocks(int64_t n0, int64_t n1, int64_t n2, int three_d) {
  return cmpt::tile_blocks(cmpt::Grid{n0, n1, n2}, three_d != 0);
}

const char* cmpt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
