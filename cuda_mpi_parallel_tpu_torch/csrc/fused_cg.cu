// B3/B4: the two fused passes of one streaming CG iteration (f32).
//
// Replaces cuda_mpi_parallel_tpu/ops/pallas/fused_cg.py: fused_cg_pass_a
// (_pass_a_kernel) and fused_cg_pass_b (_pass_b_kernel).
//
//   pass A:  p_new = r / theta + beta * p      (written)
//            pap   = sum(p_new * A p_new)      (A p_new never stored)
//   pass B:  Ap = A p_new                      (recomputed, never read back)
//            x += alpha * p_new;  r -= alpha * Ap   (in place)
//            rr = sum(r * r) [, rz = sum(r * (r / theta))]
//
// Bound on an H100: memory.  Pass A moves 3 planes (reads r, p; writes
// p_new: 201 MB at 256^3, about 60 us at 3.35 TB/s), pass B 5 planes
// (reads p_new, x, r; writes x, r: 336 MB, about 100 us).  The flops per
// point (a few tens) stay well below the ridge, but an IEEE division is
// dear: with theta, pass A divides at each recomputed p_new, so the
// unpreconditioned path (theta NULL) is compiled without it.  Design
// against the bound:
//  * the p-update is elementwise, so a block recomputes p_new at its
//    tile's +-1 neighbours from r and p instead of reading back values
//    another block writes: no cross-block dependency inside a pass, and
//    A p_new never touches DRAM (pass B recomputes it from p_new);
//  * the tile walk of common.cuh keeps each thread's own column in
//    registers, so DRAM sees every input about once;
//  * scale, alpha, beta and theta are read from device memory (as the TPU
//    kernels read them from SMEM), so the CG loop never waits on the host;
//  * the inner products are deterministic, with no float atomics: each
//    block writes one partial (fixed shuffle tree), then sum_partials
//    adds the partials in index order with a fixed tree.  A fixed launch
//    configuration gives the same bits on every run, so convergence
//    decisions repeat.
// p_new must not alias p (neighbouring blocks still read p); x and r are
// updated in place because each thread reads and writes only its own
// point of them.
#include "common.cuh"

namespace cmpt {

// Partials of sum j live at partials[j * n .. j * n + n); one block per sum.
__global__ void __launch_bounds__(kSumThreads)
sum_partials(const float* __restrict__ partials, int64_t n,
             float* __restrict__ out) {
  const float* src = partials + blockIdx.x * n;
  float v = 0.0f;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) v += src[i];
  v = block_sum(v);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

// p_new at offset o.  Without theta the divisor is 1 and the division is
// skipped (r / 1 == r exactly): an IEEE division at each of the 5 points
// where p_new is recomputed more than doubled pass A's time on an H100.
template <bool HAS_THETA>
struct PNew {
  const float* r;
  const float* p;
  float beta, theta;
  __device__ __forceinline__ float operator()(int64_t o) const {
    const float v = HAS_THETA ? __fdiv_rn(r[o], theta) : r[o];
    return add_rn(v, mul_rn(beta, p[o]));
  }
};

template <bool THREE_D, bool HAS_THETA>
__global__ void __launch_bounds__(256)
pass_a_kernel(const float* __restrict__ r, const float* __restrict__ p,
              float* __restrict__ pnew, const float* __restrict__ scale_p,
              const float* __restrict__ beta_p,
              const float* __restrict__ theta_p, Grid g,
              float* __restrict__ partials) {
  const float scale = *scale_p;
  const PNew<HAS_THETA> pn{r, p, *beta_p, HAS_THETA ? *theta_p : 1.0f};
  float acc = 0.0f;
  walk_column<float, THREE_D>(g, pn, [&](int64_t o, float u, float lap) {
    pnew[o] = u;
    acc = add_rn(acc, mul_rn(u, mul_rn(scale, lap)));
  });
  acc = block_sum(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[blockIdx.x] = acc;
}

template <bool THREE_D, bool WITH_RZ>
__global__ void __launch_bounds__(256)
pass_b_kernel(const float* __restrict__ pnew, float* __restrict__ x,
              float* __restrict__ r, const float* __restrict__ scale_p,
              const float* __restrict__ alpha_p,
              const float* __restrict__ theta_p, Grid g,
              float* __restrict__ partials) {
  const float scale = *scale_p, alpha = *alpha_p;
  const float theta = (WITH_RZ && theta_p) ? *theta_p : 1.0f;
  float acc_rr = 0.0f, acc_rz = 0.0f;
  walk_column<float, THREE_D>(
      g, [=](int64_t o) { return pnew[o]; },
      [&](int64_t o, float u, float lap) {
        x[o] = add_rn(x[o], mul_rn(alpha, u));
        const float rn = sub_rn(r[o], mul_rn(alpha, mul_rn(scale, lap)));
        r[o] = rn;
        acc_rr = add_rn(acc_rr, mul_rn(rn, rn));
        if (WITH_RZ) acc_rz = add_rn(acc_rz, mul_rn(rn, __fdiv_rn(rn, theta)));
      });
  const int64_t nblocks = gridDim.x;
  acc_rr = block_sum(acc_rr);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[blockIdx.x] = acc_rr;
  if (WITH_RZ) {
    acc_rz = block_sum(acc_rz);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partials[nblocks + blockIdx.x] = acc_rz;
  }
}

}  // namespace cmpt

extern "C" {

// pnew, partials (cmpt_tile_blocks floats) and out (1 float) are written;
// theta may be NULL (divisor 1).  2D grids pass (n0, n1, n2) = (nx, 1, ny)
// and three_d = 0.
int cmpt_cg_pass_a(const float* r, const float* p, float* pnew,
                   const float* scale, const float* beta, const float* theta,
                   int64_t n0, int64_t n1, int64_t n2, int three_d,
                   float* partials, float* out, cudaStream_t stream) {
  using namespace cmpt;
  const Grid g{n0, n1, n2};
  const int64_t blocks = tile_blocks(g, three_d != 0);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const dim3 block = tile_block(three_d != 0);
  const unsigned nb = (unsigned)blocks;
  if (three_d && theta)
    pass_a_kernel<true, true><<<nb, block, 0, stream>>>(r, p, pnew, scale, beta, theta, g, partials);
  else if (three_d)
    pass_a_kernel<true, false><<<nb, block, 0, stream>>>(r, p, pnew, scale, beta, theta, g, partials);
  else if (theta)
    pass_a_kernel<false, true><<<nb, block, 0, stream>>>(r, p, pnew, scale, beta, theta, g, partials);
  else
    pass_a_kernel<false, false><<<nb, block, 0, stream>>>(r, p, pnew, scale, beta, theta, g, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<1, kSumThreads, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

// x and r are updated in place; partials (2 * cmpt_tile_blocks floats when
// with_rz, else 1 *) and out (2 floats when with_rz: rr, rz; else rr) are
// written.  theta is read only when with_rz, and may be NULL (divisor 1).
int cmpt_cg_pass_b(const float* pnew, float* x, float* r, const float* scale,
                   const float* alpha, const float* theta, int64_t n0,
                   int64_t n1, int64_t n2, int three_d, int with_rz,
                   float* partials, float* out, cudaStream_t stream) {
  using namespace cmpt;
  const Grid g{n0, n1, n2};
  const int64_t blocks = tile_blocks(g, three_d != 0);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const dim3 block = tile_block(three_d != 0);
  const unsigned nb = (unsigned)blocks;
  if (three_d && with_rz)
    pass_b_kernel<true, true><<<nb, block, 0, stream>>>(pnew, x, r, scale, alpha, theta, g, partials);
  else if (three_d)
    pass_b_kernel<true, false><<<nb, block, 0, stream>>>(pnew, x, r, scale, alpha, theta, g, partials);
  else if (with_rz)
    pass_b_kernel<false, true><<<nb, block, 0, stream>>>(pnew, x, r, scale, alpha, theta, g, partials);
  else
    pass_b_kernel<false, false><<<nb, block, 0, stream>>>(pnew, x, r, scale, alpha, theta, g, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<with_rz ? 2 : 1, kSumThreads, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
