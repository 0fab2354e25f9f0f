// B3/B4: the two fused passes of one streaming CG iteration (f32), B6/B7:
// the same two passes in float64, and B5: one step of the streamed
// Chebyshev preconditioner (f32).
//
// Replaces cuda_mpi_parallel_tpu/ops/pallas/fused_cg.py: fused_cg_pass_a
// (_pass_a_kernel), fused_cg_pass_b (_pass_b_kernel), fused_cg_pass_a_df64
// (_pass_a_kernel_df64), fused_cg_pass_b_df64 (_pass_b_kernel_df64) and
// fused_cheb_step (_cheb_step_kernel).  B5 is described above its kernel
// below.  The TPU's df64 passes carry every plane as an (hi, lo) f32 pair
// and every product and sum as an error-free transform, because a TPU has
// no f64 units; an H100 has them (34 TFLOP/s), so B6/B7 are the B3/B4
// kernels instantiated with T = double: the same tile walk, the
// _rn intrinsics of common.cuh in their double form (no FMA contraction,
// so the plain twin matches bit for bit), double per-block partials summed
// in the same fixed order, no atomics.  As in the df64 kernels, pass A has
// no theta (the f64 lane has no preconditioned streaming path).
//
//   pass A:  p_new = r / theta + beta * p      (written)
//            pap   = sum(p_new * A p_new)      (A p_new never stored)
//   pass B:  Ap = A p_new                      (recomputed, never read back)
//            x += alpha * p_new;  r -= alpha * Ap   (in place)
//            rr = sum(r * r) [, rz = sum(r * (r / theta))]
//
// Bound on an H100: memory.  Pass A moves 3 planes (reads r, p; writes
// p_new: 201 MB at 256^3 in f32, about 60 us at 3.35 TB/s; 403 MB and
// 120 us in f64), pass B 5 planes (reads p_new, x, r; writes x, r: 336 MB,
// about 100 us; 671 MB and 200 us in f64).  The flops per point (a few
// tens) stay well below the ridge, in f64 too, but an IEEE division is
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
//
// Halos (f32 B3/B4, the JAX passes' `halos=`): for a slab of a
// row-partitioned grid the neighbours' edge planes replace the Dirichlet
// zero just outside the slab along n0, as _fill_edge_halo does.  Pass A
// takes r_lo, r_hi, p_lo, p_hi and forms p_new there as everywhere
// (r / theta + beta * p); pass B takes p_new's edge planes pn_lo, pn_hi.
// The sums are then the slab's partials, which the caller reduces over
// the mesh.
#include "common.cuh"

namespace cmpt {

// Partials of sum j live at partials[j * n .. j * n + n); one block per sum.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
sum_partials(const T* __restrict__ partials, int64_t n, T* __restrict__ out) {
  const T* src = partials + blockIdx.x * n;
  T v = T(0);
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) v += src[i];
  v = block_sum(v);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

// p_new at offset o.  Without theta the divisor is 1 and the division is
// skipped (r / 1 == r exactly): an IEEE division at each of the 5 points
// where p_new is recomputed more than doubled pass A's time on an H100.
template <typename T, bool HAS_THETA>
struct PNew {
  const T* r;
  const T* p;
  T beta, theta;
  __device__ __forceinline__ T operator()(int64_t o) const {
    const T v = HAS_THETA ? div_rn(r[o], theta) : r[o];
    return add_rn(v, mul_rn(beta, p[o]));
  }
};

// The halo planes of a slab (lo below plane 0, hi past the last), or
// none; indexed by the in-plane offset.
template <typename T>
struct Halos {
  const T* lo0;  // pass A: r_lo, pass B: pn_lo
  const T* hi0;
  const T* lo1;  // pass A: p_lo
  const T* hi1;
};

template <typename T, bool THREE_D, bool HAS_THETA, bool HALO>
__global__ void __launch_bounds__(256)
pass_a_kernel(const T* __restrict__ r, const T* __restrict__ p,
              T* __restrict__ pnew, const T* __restrict__ scale_p,
              const T* __restrict__ beta_p, const T* __restrict__ theta_p,
              Halos<T> h, Grid g, T* __restrict__ partials) {
  const T scale = *scale_p;
  const T beta = *beta_p, theta = HAS_THETA ? *theta_p : T(1);
  const PNew<T, HAS_THETA> pn{r, p, beta, theta};
  T acc = T(0);
  const auto visit = [&](int64_t o, T u, T lap) {
    pnew[o] = u;
    acc = add_rn(acc, mul_rn(u, mul_rn(scale, lap)));
  };
  if (HALO)
    walk_column_edges<T, THREE_D>(
        g, (int64_t)blockIdx.x, pn, PNew<T, HAS_THETA>{h.lo0, h.lo1, beta, theta},
        PNew<T, HAS_THETA>{h.hi0, h.hi1, beta, theta}, visit);
  else
    walk_column<T, THREE_D>(g, pn, visit);
  acc = block_sum(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[blockIdx.x] = acc;
}

template <typename T, bool THREE_D, bool WITH_RZ, bool HALO>
__global__ void __launch_bounds__(256)
pass_b_kernel(const T* __restrict__ pnew, T* __restrict__ x,
              T* __restrict__ r, const T* __restrict__ scale_p,
              const T* __restrict__ alpha_p, const T* __restrict__ theta_p,
              Halos<T> h, Grid g, T* __restrict__ partials) {
  const T scale = *scale_p, alpha = *alpha_p;
  const T theta = (WITH_RZ && theta_p) ? *theta_p : T(1);
  T acc_rr = T(0), acc_rz = T(0);
  const auto load = [=](int64_t o) { return pnew[o]; };
  const auto visit = [&](int64_t o, T u, T lap) {
    x[o] = add_rn(x[o], mul_rn(alpha, u));
    const T rn = sub_rn(r[o], mul_rn(alpha, mul_rn(scale, lap)));
    r[o] = rn;
    acc_rr = add_rn(acc_rr, mul_rn(rn, rn));
    if (WITH_RZ) acc_rz = add_rn(acc_rz, mul_rn(rn, div_rn(rn, theta)));
  };
  if (HALO)
    walk_column_edges<T, THREE_D>(
        g, (int64_t)blockIdx.x, load, [=](int64_t c) { return h.lo0[c]; },
        [=](int64_t c) { return h.hi0[c]; }, visit);
  else
    walk_column<T, THREE_D>(g, load, visit);
  const int64_t nblocks = gridDim.x;
  acc_rr = block_sum(acc_rr);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[blockIdx.x] = acc_rr;
  if (WITH_RZ) {
    acc_rz = block_sum(acc_rz);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      partials[nblocks + blockIdx.x] = acc_rz;
  }
}

// Pass A of either lane: the variant, then the sum of its partials.  The
// f64 lane has no theta and no halos, so only the f32 lane instantiates
// the division and the halo walk.
template <typename T, bool THREE_D, bool HAS_THETA, bool HALO>
static void pass_a_variant(const T* r, const T* p, T* pnew, const T* scale,
                           const T* beta, const T* theta, Halos<T> h, Grid g,
                           T* partials, unsigned nb, cudaStream_t stream) {
  pass_a_kernel<T, THREE_D, HAS_THETA, HALO>
      <<<nb, tile_block(THREE_D), 0, stream>>>(r, p, pnew, scale, beta, theta,
                                                h, g, partials);
}

template <typename T, bool HAS_THETA, bool HALO>
static void pass_a_dims(bool three_d, const T* r, const T* p, T* pnew,
                        const T* scale, const T* beta, const T* theta,
                        Halos<T> h, Grid g, T* partials, unsigned nb,
                        cudaStream_t stream) {
  if (three_d)
    pass_a_variant<T, true, HAS_THETA, HALO>(r, p, pnew, scale, beta, theta,
                                             h, g, partials, nb, stream);
  else
    pass_a_variant<T, false, HAS_THETA, HALO>(r, p, pnew, scale, beta, theta,
                                              h, g, partials, nb, stream);
}

template <typename T>
static int launch_pass_a(const T* r, const T* p, T* pnew, const T* scale,
                         const T* beta, const T* theta, Halos<T> h, Grid g,
                         bool three_d, T* partials, T* out,
                         cudaStream_t stream) {
  const int64_t blocks = tile_blocks(g, three_d);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const unsigned nb = (unsigned)blocks;
  const bool halo = h.lo0 != nullptr;
  if (halo && (!h.hi0 || !h.lo1 || !h.hi1)) return (int)cudaErrorInvalidValue;
  if (theta == nullptr && !halo) {
    pass_a_dims<T, false, false>(three_d, r, p, pnew, scale, beta, theta, h,
                                 g, partials, nb, stream);
  } else if constexpr (sizeof(T) == 4) {
    if (theta == nullptr)
      pass_a_dims<T, false, true>(three_d, r, p, pnew, scale, beta, theta, h,
                                  g, partials, nb, stream);
    else if (halo)
      pass_a_dims<T, true, true>(three_d, r, p, pnew, scale, beta, theta, h,
                                 g, partials, nb, stream);
    else
      pass_a_dims<T, true, false>(three_d, r, p, pnew, scale, beta, theta, h,
                                  g, partials, nb, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<T><<<1, kSumThreads, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

// Pass B of either lane; only the f32 lane sums r . z and takes halos.
template <typename T, bool WITH_RZ, bool HALO>
static void pass_b_dims(bool three_d, const T* pnew, T* x, T* r,
                        const T* scale, const T* alpha, const T* theta,
                        Halos<T> h, Grid g, T* partials, unsigned nb,
                        cudaStream_t stream) {
  if (three_d)
    pass_b_kernel<T, true, WITH_RZ, HALO><<<nb, tile_block(true), 0, stream>>>(
        pnew, x, r, scale, alpha, theta, h, g, partials);
  else
    pass_b_kernel<T, false, WITH_RZ, HALO><<<nb, tile_block(false), 0, stream>>>(
        pnew, x, r, scale, alpha, theta, h, g, partials);
}

template <typename T>
static int launch_pass_b(const T* pnew, T* x, T* r, const T* scale,
                         const T* alpha, const T* theta, Halos<T> h, Grid g,
                         bool three_d, bool with_rz, T* partials, T* out,
                         cudaStream_t stream) {
  const int64_t blocks = tile_blocks(g, three_d);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const unsigned nb = (unsigned)blocks;
  const bool halo = h.lo0 != nullptr;
  if (halo && !h.hi0) return (int)cudaErrorInvalidValue;
  if (!with_rz && !halo) {
    pass_b_dims<T, false, false>(three_d, pnew, x, r, scale, alpha, theta, h,
                                 g, partials, nb, stream);
  } else if constexpr (sizeof(T) == 4) {
    if (!with_rz)
      pass_b_dims<T, false, true>(three_d, pnew, x, r, scale, alpha, theta, h,
                                  g, partials, nb, stream);
    else if (halo)
      pass_b_dims<T, true, true>(three_d, pnew, x, r, scale, alpha, theta, h,
                                 g, partials, nb, stream);
    else
      pass_b_dims<T, true, false>(three_d, pnew, x, r, scale, alpha, theta, h,
                                  g, partials, nb, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<T><<<with_rz ? 2 : 1, kSumThreads, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
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
// theta may be NULL (divisor 1).  r_lo, r_hi, p_lo, p_hi: the slab's halo
// planes (n1 * n2 floats each), all four or all NULL (the Dirichlet
// zero).  2D grids pass (n0, n1, n2) = (nx, 1, ny) and three_d = 0.
int cmpt_cg_pass_a(const float* r, const float* p, float* pnew,
                   const float* scale, const float* beta, const float* theta,
                   const float* r_lo, const float* r_hi, const float* p_lo,
                   const float* p_hi, int64_t n0, int64_t n1, int64_t n2,
                   int three_d, float* partials, float* out,
                   cudaStream_t stream) {
  return cmpt::launch_pass_a<float>(
      r, p, pnew, scale, beta, theta, cmpt::Halos<float>{r_lo, r_hi, p_lo, p_hi},
      cmpt::Grid{n0, n1, n2}, three_d != 0, partials, out, stream);
}

// B6: pass A in float64, without theta; partials (cmpt_tile_blocks
// doubles) and out (1 double: pap) are written.
int cmpt_cg_pass_a_f64(const double* r, const double* p, double* pnew,
                       const double* scale, const double* beta, int64_t n0,
                       int64_t n1, int64_t n2, int three_d, double* partials,
                       double* out, cudaStream_t stream) {
  return cmpt::launch_pass_a<double>(r, p, pnew, scale, beta, nullptr,
                                     cmpt::Halos<double>{},
                                     cmpt::Grid{n0, n1, n2}, three_d != 0,
                                     partials, out, stream);
}

// x and r are updated in place; partials (2 * cmpt_tile_blocks floats when
// with_rz, else 1 *) and out (2 floats when with_rz: rr, rz; else rr) are
// written.  theta is read only when with_rz, and may be NULL (divisor 1).
// pn_lo, pn_hi: p_new's halo planes, both or neither.
int cmpt_cg_pass_b(const float* pnew, float* x, float* r, const float* scale,
                   const float* alpha, const float* theta, const float* pn_lo,
                   const float* pn_hi, int64_t n0, int64_t n1, int64_t n2,
                   int three_d, int with_rz, float* partials, float* out,
                   cudaStream_t stream) {
  return cmpt::launch_pass_b<float>(
      pnew, x, r, scale, alpha, theta,
      cmpt::Halos<float>{pn_lo, pn_hi, nullptr, nullptr},
      cmpt::Grid{n0, n1, n2}, three_d != 0, with_rz != 0, partials, out,
      stream);
}

// B7: pass B in float64 (x and r in place); partials (cmpt_tile_blocks
// doubles) and out (1 double: rr) are written.
int cmpt_cg_pass_b_f64(const double* pnew, double* x, double* r,
                       const double* scale, const double* alpha, int64_t n0,
                       int64_t n1, int64_t n2, int three_d, double* partials,
                       double* out, cudaStream_t stream) {
  return cmpt::launch_pass_b<double>(pnew, x, r, scale, alpha, nullptr,
                                     cmpt::Halos<double>{},
                                     cmpt::Grid{n0, n1, n2}, three_d != 0,
                                     false, partials, out, stream);
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
  sum_partials<float><<<1, kSumThreads, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
