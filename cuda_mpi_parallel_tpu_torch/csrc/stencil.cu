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

// One launch applies the stencil to each of the k grids of a stack
// stored grid after grid (col_stride elements apart): gridDim.y = k over
// the tile walk.  k = 1 is the single-grid call (stencil2d_apply /
// stencil3d_apply); k > 1 is the column-stack instance, the many-RHS
// solvers' matmat.  It replaces the vmapped stencil2d_apply /
// stencil3d_apply (JAX LinearOperator.matmat is jax.vmap(matvec), which
// gives the Pallas call a batch grid axis), so each grid gets exactly the
// arithmetic of a single launch on it, bit for bit.  Bound: memory, k
// times the single grid's bytes (x read, y written once each).
template <typename T, bool THREE_D>
__global__ void __launch_bounds__(256)
stencil_kernel(const T* __restrict__ x, T* __restrict__ y,
               const T* __restrict__ scale_p, Grid g, int64_t col_stride) {
  const T scale = *scale_p;
  const int64_t base = (int64_t)blockIdx.y * col_stride;
  const T* xc = x + base;
  T* yc = y + base;
  walk_column<T, THREE_D>(
      g, [=](int64_t o) { return xc[o]; },
      [=](int64_t o, T, T lap) { yc[o] = mul_rn(scale, lap); });
}

template <typename T>
int launch_stencil(const T* x, T* y, const T* scale, int64_t n0, int64_t n1,
                   int64_t n2, int three_d, int64_t k, cudaStream_t stream) {
  const Grid g{n0, n1, n2};
  const int64_t blocks = tile_blocks(g, three_d != 0);
  if (blocks <= 0 || k < 1 || k > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)k, 1);
  const dim3 block = tile_block(three_d != 0);
  const int64_t stride = n0 * n1 * n2;
  if (three_d)
    stencil_kernel<T, true><<<grid, block, 0, stream>>>(x, y, scale, g,
                                                        stride);
  else
    stencil_kernel<T, false><<<grid, block, 0, stream>>>(x, y, scale, g,
                                                         stride);
  return (int)cudaGetLastError();
}

}  // namespace cmpt

extern "C" {

// k grids of n0 * n1 * n2 points, one after another; 2D grids pass
// (n0, n1, n2) = (nx, 1, ny) and three_d = 0.
int cmpt_stencil_f32(const float* x, float* y, const float* scale, int64_t n0,
                     int64_t n1, int64_t n2, int three_d, int64_t k,
                     cudaStream_t stream) {
  return cmpt::launch_stencil<float>(x, y, scale, n0, n1, n2, three_d, k,
                                     stream);
}

int cmpt_stencil_f64(const double* x, double* y, const double* scale,
                     int64_t n0, int64_t n1, int64_t n2, int three_d,
                     int64_t k, cudaStream_t stream) {
  return cmpt::launch_stencil<double>(x, y, scale, n0, n1, n2, three_d, k,
                                      stream);
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
