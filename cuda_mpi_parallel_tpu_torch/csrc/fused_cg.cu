// B3/B4: the two fused passes of one streaming CG iteration (f32), and
// B5: one step of the streamed Chebyshev preconditioner.
//
// Replaces cuda_mpi_parallel_tpu/ops/pallas/fused_cg.py: fused_cg_pass_a
// (_pass_a_kernel), fused_cg_pass_b (_pass_b_kernel) and fused_cheb_step
// (_cheb_step_kernel).  B5 is described above its kernel below.
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

// B5: one Chebyshev semi-iteration step, z' = z + d', with
//   d' = c1 * d + c2 * (r - A z)                  (in the JAX kernel's order)
// FIRST: the operand v is r itself and z0 = d0 = r / theta is formed on
// the fly, at the neighbours too (the ChebZ functor), so no z0 plane is
// written or read back.  LAST: the step also sums rho = r . z' (the PCG
// reduction), as pass B sums rr: per-block partials, then sum_partials.
//
// Bound on an H100: memory.  The first step reads r and writes z', d'
// (3 planes: 201 MB at 256^3, about 60 us at 3.35 TB/s); a middle or
// last step reads z, r, d and writes z', d' (5 planes, about 100 us).
// The flops (about 12 per point) stay far below the ridge.  As in pass A,
// z is recomputed at the tile's +-1 neighbours instead of read back from
// another block, and each thread's column stays in registers.  z' must
// not alias z, whose neighbours other blocks still read; d is read and
// written only at the thread's own point, so d_out may be d_in.  scale,
// theta, c1 and c2 are read from device memory.
template <bool FIRST>
struct ChebZ {
  const float* v;
  float theta;
  __device__ __forceinline__ float operator()(int64_t o) const {
    return FIRST ? __fdiv_rn(v[o], theta) : v[o];
  }
};

template <bool THREE_D, bool FIRST, bool LAST>
__global__ void __launch_bounds__(256)
cheb_step_kernel(const float* __restrict__ v, const float* __restrict__ r,
                 const float* d_in, float* __restrict__ zout, float* d_out,
                 const float* __restrict__ scale_p,
                 const float* __restrict__ theta_p,
                 const float* __restrict__ c1_p,
                 const float* __restrict__ c2_p, Grid g,
                 float* __restrict__ partials) {
  const float scale = *scale_p, c1 = *c1_p, c2 = *c2_p;
  const ChebZ<FIRST> zf{v, *theta_p};
  float acc = 0.0f;
  walk_column<float, THREE_D>(g, zf, [&](int64_t o, float z, float lap) {
    const float rv = FIRST ? v[o] : r[o];
    const float dv = FIRST ? z : d_in[o];
    const float dn = add_rn(mul_rn(c1, dv),
                            mul_rn(c2, sub_rn(rv, mul_rn(scale, lap))));
    const float zn = add_rn(z, dn);
    zout[o] = zn;
    d_out[o] = dn;
    if (LAST) acc = add_rn(acc, mul_rn(rv, zn));
  });
  if (LAST) {
    acc = block_sum(acc);
    if (threadIdx.x == 0 && threadIdx.y == 0) partials[blockIdx.x] = acc;
  }
}

struct ChebArgs {
  const float *v, *r, *d_in;
  float *zout, *d_out;
  const float *scale, *theta, *c1, *c2;
  Grid g;
  float* partials;
};

template <bool THREE_D, bool FIRST, bool LAST>
static void launch_cheb_variant(const ChebArgs& a, unsigned nb,
                                cudaStream_t stream) {
  cheb_step_kernel<THREE_D, FIRST, LAST><<<nb, tile_block(THREE_D), 0, stream>>>(
      a.v, a.r, a.d_in, a.zout, a.d_out, a.scale, a.theta, a.c1, a.c2, a.g,
      a.partials);
}

template <bool THREE_D>
static void launch_cheb(const ChebArgs& a, bool first, bool last, unsigned nb,
                        cudaStream_t stream) {
  if (first && last) launch_cheb_variant<THREE_D, true, true>(a, nb, stream);
  else if (first) launch_cheb_variant<THREE_D, true, false>(a, nb, stream);
  else if (last) launch_cheb_variant<THREE_D, false, true>(a, nb, stream);
  else launch_cheb_variant<THREE_D, false, false>(a, nb, stream);
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

// One Chebyshev step.  first: v is r (r and d_in unused, may be NULL);
// else v is z, with r and d_in read.  zout and d_out are written (d_out may
// be d_in, zout must not be v); when last, partials (cmpt_tile_blocks
// floats) and out (1 float: rho = r . z') are written.  2D grids pass
// (n0, n1, n2) = (nx, 1, ny) and three_d = 0.
int cmpt_cheb_step(const float* v, const float* r, const float* d_in,
                   float* zout, float* d_out, const float* scale,
                   const float* theta, const float* c1, const float* c2,
                   int64_t n0, int64_t n1, int64_t n2, int three_d, int first,
                   int last, float* partials, float* out,
                   cudaStream_t stream) {
  using namespace cmpt;
  const Grid g{n0, n1, n2};
  const int64_t blocks = tile_blocks(g, three_d != 0);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const ChebArgs a{v, r, d_in, zout, d_out, scale, theta, c1, c2, g, partials};
  const unsigned nb = (unsigned)blocks;
  if (three_d)
    launch_cheb<true>(a, first != 0, last != 0, nb, stream);
  else
    launch_cheb<false>(a, first != 0, last != 0, nb, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !last) return (int)err;
  sum_partials<<<1, kSumThreads, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
