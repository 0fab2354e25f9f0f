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
// no f64 units; an H100 has them (34 TFLOP/s), so B6/B7 are the tile-walk
// kernels below instantiated with T = double: the _rn intrinsics of
// common.cuh in their double form (no FMA contraction, so the plain twin
// matches bit for bit), double per-block partials summed in the same fixed
// order, no atomics.  As in the df64 kernels, pass A has no theta (the f64
// lane has no preconditioned streaming path).
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
// dear, so the unpreconditioned path (theta NULL) is compiled without it.
//
// B3 and B4, the f32 passes, march planes (2.5D blocking, pass_a_march
// and pass_b_march below): a block owns an in-plane tile (8 rows x 64
// columns in 3D, 1 x 512 in 2D) and walks a run of L planes along n0, L
// fixed by the grid alone (march.cuh: about two waves of blocks; 32 at
// 256^3).  B3 answers the three limits of a walk that forms p_new at
// every neighbour from global r and p:
//  * p_new once per point: each plane's r and p land in shared memory
//    over the tile and a one-point ring, the block forms p_new there once
//    (one division per point with theta, not five) into a shared plane,
//    and the stencil reads its in-plane neighbours from that plane; the
//    thread's own column keeps p_new at planes i - 1, i, i + 1 in
//    registers.  DRAM sees 2 loads and 1 store per point, plus the
//    (L + 2) / L planes and the ring that neighbouring tiles share in L2;
//  * long walks: L planes a block instead of 8, so the two recomputed
//    edge planes cost 2 / L;
//  * memory-level parallelism: r and p of plane i + 2 are in flight
//    (cp.async, 16-byte copies where rows are 16-byte aligned, 4-byte
//    copies elsewhere, so ragged n2 stays right) while plane i is
//    computed, from a ring of three staging slots; out-of-grid cells are
//    the copy's zero fill, the Dirichlet zero.
// B4 answers the same limits for pass B, which only reads p_new:
//  * p_new once per point: each plane of p_new lands in shared memory over
//    the tile and its ring, two planes ahead (the same cp.async staging),
//    and the stencil reads its in-plane neighbours there instead of five
//    loads a point through L1/L2; with one staging ring and no plane
//    formed, one barrier a plane does;
//  * long walks: the same runs of L planes;
//  * x and r in flight: each thread touches only its own points of x and
//    r, so it issues their loads for the next plane before it waits for
//    the current one, and their values sit in registers for a step.
//    DRAM sees about 5 planes: p_new (L + 2) / L, x and r read and
//    written once.
// Their arithmetic is the old walk's: the same _rn operations for p_new,
// x, r and the Laplacian (common.cuh's laplacian, in the same order), so
// p_new, x and r are bit-equal to the twins.  B6 and B7 keep the tile
// walk of common.cuh, each thread's column in registers and p_new
// recomputed (B6) or loaded again (B7) at the neighbours.  All keep the
// rest of the design:
//  * no cross-block dependency inside a pass: a block forms p_new on its
//    ring from r and p instead of reading values another block writes,
//    and A p_new never touches DRAM (pass B recomputes it from p_new);
//  * scale, alpha, beta and theta are read from device memory (as the TPU
//    kernels read them from SMEM), so the CG loop never waits on the host;
//  * the inner products are deterministic, with no float atomics: each
//    block writes one partial (fixed shuffle tree), then sum_partials
//    adds the partials in index order with a fixed tree.  A launch
//    configuration fixed by the grid gives the same bits on every run, so
//    convergence decisions repeat.
// p_new must not alias p (neighbouring blocks still read p); x and r are
// updated in place because each thread reads and writes only its own
// point of them.
//
// Halos (the JAX passes' `halos=`, f32 and f64): for a slab of a
// row-partitioned grid the neighbours' edge planes replace the Dirichlet
// zero just outside the slab along n0, as _fill_edge_halo does.  Pass A
// takes r_lo, r_hi, p_lo, p_hi and forms p_new there as everywhere
// (r / theta + beta * p): in B3 the block that owns plane 0 stages plane
// -1 from r_lo / p_lo, the one that owns plane n0 - 1 stages plane n0
// from r_hi / p_hi.  Pass B takes p_new's edge planes pn_lo, pn_hi and
// stages them as planes -1 and n0, so a halo costs a slab nothing extra.
// B6/B7 read the same planes where their tile walk (walk_column_edges)
// reaches past the slab, once a column of the edge tiles.  The sums are
// then the slab's partials, which the caller reduces over the mesh.
#include <cuda_pipeline.h>

#include "common.cuh"
#include "march.cuh"

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

// The halo planes of a slab (lo below plane 0, hi past the last), or
// none; indexed by the in-plane offset.
template <typename T>
struct Halos {
  const T* lo0;  // pass A: r_lo, pass B: pn_lo
  const T* hi0;
  const T* lo1;  // pass A: p_lo
  const T* hi1;
};

// Stage one plane of each of N (1 or 2) arrays over a march tile and its
// ring into shared memory with cp.async: plane src0 (and src1) into dst0
// (and dst1), in MarchTile's layout: rows j0 - RY .. j0 + BY + RY - 1, the
// columns the stencil reads around [k0, k0 + TX).  VEC: 16-byte copies,
// for n2 % 4 == 0 and 16-byte aligned planes.  A cell outside the grid,
// or of a NULL plane, is the copy's zero fill, the Dirichlet zero; `any`
// is a valid address for the zero-filling copies to name.
template <bool THREE_D, bool VEC, int N>
__device__ __forceinline__ void stage_tile(const float* src0,
                                           const float* src1, float* dst0,
                                           float* dst1, const float* any,
                                           int64_t j0, int64_t k0, Grid g) {
  using M = MarchTile<THREE_D>;
  constexpr int W = VEC ? 4 : 1;                    // floats a copy
  constexpr int ROW = VEC ? M::SW / 4 : M::TX + 2;  // copies a row
  constexpr int C0 = VEC ? 0 : M::PAD - 1;          // first column copied
  const int tid = threadIdx.y * M::BX + threadIdx.x;
  for (int e = tid; e < N * M::SH * ROW; e += M::THREADS) {
    const int arr = e / (M::SH * ROW);
    const int y = e % (M::SH * ROW) / ROW;
    const int c = C0 + e % ROW * W;
    const int64_t j = j0 - M::RY + y, k = k0 - M::PAD + c;
    const float* base = arr ? src1 : src0;
    const bool in = base != nullptr && j >= 0 && j < g.n1 && k >= 0 &&
                    k < g.n2;
    float* dst = (arr ? dst1 : dst0) + y * M::SW + c;
    __pipeline_memcpy_async(dst, in ? base + j * g.n2 + k : any, W * 4,
                            in ? 0 : W * 4);
  }
}

// B3: pass A in f32, plane marching (see the note at the top; the tile
// and the geometry are march.cuh's).  Launched with dim3(BX, BY)
// threads: four blocks per SM is the occupancy the geometry's "two waves"
// assumes (23 KB of shared memory a block in 3D, 17 KB in 2D).
template <bool THREE_D, bool HAS_THETA, bool VEC>
__global__ void __launch_bounds__(MarchTile<THREE_D>::THREADS, 4)
pass_a_march(const float* __restrict__ r, const float* __restrict__ p,
             float* __restrict__ pnew, const float* __restrict__ scale_p,
             const float* __restrict__ beta_p,
             const float* __restrict__ theta_p, Halos<float> h, Grid g,
             MarchGeometry geo, float* __restrict__ partials) {
  using M = MarchTile<THREE_D>;
  __shared__ __align__(16) float s_r[3][M::CELLS];  // staging ring
  __shared__ __align__(16) float s_p[3][M::CELLS];
  __shared__ float s_pn[2][M::CELLS];               // p_new, two planes

  const float scale = *scale_p, beta = *beta_p;
  const float theta = HAS_THETA ? *theta_p : 1.0f;
  const int tid = threadIdx.y * M::BX + threadIdx.x;
  const MarchBlock blk =
      march_block<THREE_D>(blockIdx.x, g.n0, g.n1, g.n2, geo);
  const int64_t i0 = blk.i0, j0 = blk.j0, k0 = blk.k0;
  const int64_t s0 = g.n1 * g.n2;
  // step t stages, forms and holds plane i0 - 1 + t; the stencil of plane
  // i0 - 2 + t runs at step t >= 2
  const int steps = (int)(blk.i1 - i0) + 2;

  // Copy plane q's r and p over the tile and its ring into slot `slot`;
  // cells outside the grid (and outside a slab without halos) are zero.
  const auto stage = [&](int64_t q, int slot) {
    const float *rq, *pq;
    if (q < 0) {
      rq = h.lo0;
      pq = h.lo1;
    } else if (q >= g.n0) {
      rq = h.hi0;
      pq = h.hi1;
    } else {
      rq = r + q * s0;
      pq = p + q * s0;
    }
    stage_tile<THREE_D, VEC, 2>(rq, pq, s_r[slot], s_p[slot], r, j0, k0, g);
  };

  // The columns this thread owns: row j0 + threadIdx.y, columns
  // k0 + threadIdx.x + m * BX.
  const int64_t j = j0 + threadIdx.y;
  const int own = (threadIdx.y + M::RY) * M::SW + M::PAD + threadIdx.x;
  bool inside[M::PTS];
#pragma unroll
  for (int m = 0; m < M::PTS; ++m)
    inside[m] = j < blk.j1 && k0 + threadIdx.x + m * M::BX < blk.k1;

  float prev[M::PTS] = {}, cur[M::PTS] = {};
  float acc = 0.0f;
  stage(i0 - 1, 0);
  __pipeline_commit();
  stage(i0, 1);
  __pipeline_commit();
  for (int t = 0; t < steps; ++t) {
    __pipeline_wait_prior(1);
    __syncthreads();  // plane t staged; every thread done with step t - 1
    if (t + 2 < steps) stage(i0 + 1 + t, (t + 2) % 3);
    __pipeline_commit();
    // p_new once per cell of the tile and its ring (PNew's arithmetic)
    const float* sr = s_r[t % 3];
    const float* sp = s_p[t % 3];
    float* pn = s_pn[t & 1];
    for (int e = tid; e < M::USED; e += M::THREADS) {
      const int o = e / (M::TX + 2) * M::SW + M::PAD - 1 + e % (M::TX + 2);
      const float v = HAS_THETA ? div_rn(sr[o], theta) : sr[o];
      pn[o] = add_rn(v, mul_rn(beta, sp[o]));
    }
    __syncthreads();
    const float* pc = s_pn[(t - 1) & 1];  // the stencil's centre plane
    const int64_t i = i0 - 2 + t;
#pragma unroll
    for (int m = 0; m < M::PTS; ++m) {
      const int o = own + m * M::BX;
      const float next = pn[o];
      if (t >= 2 && inside[m]) {
        const float u = cur[m];
        const float lap = laplacian<float, THREE_D>(
            u, prev[m], next, THREE_D ? pc[o - M::SW] : 0.0f,
            THREE_D ? pc[o + M::SW] : 0.0f, pc[o - 1], pc[o + 1]);
        pnew[i * s0 + j * g.n2 + k0 + threadIdx.x + m * M::BX] = u;
        acc = add_rn(acc, mul_rn(u, mul_rn(scale, lap)));
      }
      prev[m] = cur[m];
      cur[m] = next;
    }
  }
  acc = block_sum(acc);
  if (tid == 0) partials[blockIdx.x] = acc;
}

template <bool THREE_D, bool HAS_THETA>
static void march_variant(bool vec, const float* r, const float* p,
                          float* pnew, const float* scale, const float* beta,
                          const float* theta, Halos<float> h, Grid g,
                          MarchGeometry geo, float* partials,
                          cudaStream_t stream) {
  const dim3 block(MarchTile<THREE_D>::BX, MarchTile<THREE_D>::BY);
  const unsigned nb = (unsigned)geo.blocks;
  if (vec)
    pass_a_march<THREE_D, HAS_THETA, true><<<nb, block, 0, stream>>>(
        r, p, pnew, scale, beta, theta, h, g, geo, partials);
  else
    pass_a_march<THREE_D, HAS_THETA, false><<<nb, block, 0, stream>>>(
        r, p, pnew, scale, beta, theta, h, g, geo, partials);
}

static bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

static int launch_pass_a_f32(const float* r, const float* p, float* pnew,
                             const float* scale, const float* beta,
                             const float* theta, Halos<float> h, Grid g,
                             bool three_d, float* partials, float* out,
                             cudaStream_t stream) {
  const MarchGeometry geo = march_geometry(g.n0, g.n1, g.n2, three_d);
  if (geo.blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const bool halo = h.lo0 != nullptr;
  if (halo && (!h.hi0 || !h.lo1 || !h.hi1)) return (int)cudaErrorInvalidValue;
  // 16-byte copies need every row of every staged plane 16-byte aligned
  const bool vec = g.n2 % 4 == 0 && aligned16(r) && aligned16(p) &&
                   (!halo || (aligned16(h.lo0) && aligned16(h.hi0) &&
                              aligned16(h.lo1) && aligned16(h.hi1)));
  if (three_d && theta)
    march_variant<true, true>(vec, r, p, pnew, scale, beta, theta, h, g, geo,
                              partials, stream);
  else if (three_d)
    march_variant<true, false>(vec, r, p, pnew, scale, beta, theta, h, g,
                               geo, partials, stream);
  else if (theta)
    march_variant<false, true>(vec, r, p, pnew, scale, beta, theta, h, g,
                               geo, partials, stream);
  else
    march_variant<false, false>(vec, r, p, pnew, scale, beta, theta, h, g,
                                geo, partials, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<float><<<1, kSumThreads, 0, stream>>>(partials, geo.blocks,
                                                     out);
  return (int)cudaGetLastError();
}

// B4: pass B in f32, plane marching on B3's tile and geometry (see the
// note at the top).  Step t lands plane q = i0 - 1 + t of p_new in slot
// t % 3 of the staging ring and computes plane q - 1.  The thread's own
// column keeps p_new at planes q - 2, q - 1 in registers (prev, cur) and
// reads q (next) from the slot; the in-plane neighbours of plane q - 1
// were read from its slot a step earlier and kept in registers (nb), so
// a slot is free again one step after it lands, and the one barrier of
// step t both publishes plane q and releases the slot that plane q + 2
// is copied into.  x and r of plane q are loaded at the top of step t
// and used at step t + 1.  Launched like B3 (8.8 KB of shared memory a
// block in 3D, 6.4 KB in 2D).
template <bool THREE_D, bool WITH_RZ, bool VEC>
__global__ void __launch_bounds__(MarchTile<THREE_D>::THREADS, 4)
pass_b_march(const float* __restrict__ pnew, float* __restrict__ x,
             float* __restrict__ r, const float* __restrict__ scale_p,
             const float* __restrict__ alpha_p,
             const float* __restrict__ theta_p, Halos<float> h, Grid g,
             MarchGeometry geo, float* __restrict__ partials) {
  using M = MarchTile<THREE_D>;
  __shared__ __align__(16) float s_pn[3][M::CELLS];  // staging ring

  const float scale = *scale_p, alpha = *alpha_p;
  const float theta = (WITH_RZ && theta_p) ? *theta_p : 1.0f;
  const int tid = threadIdx.y * M::BX + threadIdx.x;
  const MarchBlock blk =
      march_block<THREE_D>(blockIdx.x, g.n0, g.n1, g.n2, geo);
  const int64_t i0 = blk.i0, j0 = blk.j0, k0 = blk.k0;
  const int64_t s0 = g.n1 * g.n2;
  const int steps = (int)(blk.i1 - i0) + 2;

  // Copy plane q of p_new over the tile and its ring into slot `slot`;
  // cells outside the grid (and outside a slab without halos) are zero.
  const auto stage = [&](int64_t q, int slot) {
    const float* pq = q < 0 ? h.lo0 : q >= g.n0 ? h.hi0 : pnew + q * s0;
    stage_tile<THREE_D, VEC, 1>(pq, nullptr, s_pn[slot], s_pn[slot], pnew,
                                j0, k0, g);
  };

  // The columns this thread owns, as in B3: row j0 + threadIdx.y,
  // columns k0 + threadIdx.x + m * BX (in-plane offsets col[m]).
  const int64_t j = j0 + threadIdx.y;
  const int own = (threadIdx.y + M::RY) * M::SW + M::PAD + threadIdx.x;
  bool inside[M::PTS];
  int64_t col[M::PTS];
#pragma unroll
  for (int m = 0; m < M::PTS; ++m) {
    const int64_t k = k0 + threadIdx.x + m * M::BX;
    inside[m] = j < blk.j1 && k < blk.k1;
    col[m] = j * g.n2 + k;
  }

  float prev[M::PTS] = {}, cur[M::PTS] = {};
  float nb[M::PTS][4] = {};             // cur's ym, yp, zm, zp
  float xv[M::PTS] = {}, rv[M::PTS] = {};  // x, r of plane q - 1
  float acc_rr = 0.0f, acc_rz = 0.0f;
  stage(i0 - 1, 0);
  __pipeline_commit();
  stage(i0, 1);
  __pipeline_commit();
  for (int t = 0; t < steps; ++t) {
    const int64_t q = i0 - 1 + t;
    float xn[M::PTS] = {}, rn[M::PTS] = {};
    if (q >= i0 && q < blk.i1) {
#pragma unroll
      for (int m = 0; m < M::PTS; ++m)
        if (inside[m]) {
          xn[m] = x[q * s0 + col[m]];
          rn[m] = r[q * s0 + col[m]];
        }
    }
    __pipeline_wait_prior(1);
    __syncthreads();  // plane q staged; every thread done with slot t - 1
    if (t + 2 < steps) stage(q + 2, (t + 2) % 3);
    __pipeline_commit();
    const float* s = s_pn[t % 3];
#pragma unroll
    for (int m = 0; m < M::PTS; ++m) {
      const int o = own + m * M::BX;
      const float next = s[o];
      if (t >= 2 && inside[m]) {
        const float u = cur[m];
        const float lap = laplacian<float, THREE_D>(
            u, prev[m], next, nb[m][0], nb[m][1], nb[m][2], nb[m][3]);
        const int64_t at = (q - 1) * s0 + col[m];
        x[at] = add_rn(xv[m], mul_rn(alpha, u));
        const float rnew = sub_rn(rv[m], mul_rn(alpha, mul_rn(scale, lap)));
        r[at] = rnew;
        acc_rr = add_rn(acc_rr, mul_rn(rnew, rnew));
        if (WITH_RZ)
          acc_rz = add_rn(acc_rz, mul_rn(rnew, div_rn(rnew, theta)));
      }
      prev[m] = cur[m];
      cur[m] = next;
      nb[m][0] = THREE_D ? s[o - M::SW] : 0.0f;
      nb[m][1] = THREE_D ? s[o + M::SW] : 0.0f;
      nb[m][2] = s[o - 1];
      nb[m][3] = s[o + 1];
      xv[m] = xn[m];
      rv[m] = rn[m];
    }
  }
  acc_rr = block_sum(acc_rr);
  if (tid == 0) partials[blockIdx.x] = acc_rr;
  if (WITH_RZ) {
    acc_rz = block_sum(acc_rz);
    if (tid == 0) partials[geo.blocks + blockIdx.x] = acc_rz;
  }
}

template <bool THREE_D, bool WITH_RZ>
static void march_b_variant(bool vec, const float* pnew, float* x, float* r,
                            const float* scale, const float* alpha,
                            const float* theta, Halos<float> h, Grid g,
                            MarchGeometry geo, float* partials,
                            cudaStream_t stream) {
  const dim3 block(MarchTile<THREE_D>::BX, MarchTile<THREE_D>::BY);
  const unsigned nb = (unsigned)geo.blocks;
  if (vec)
    pass_b_march<THREE_D, WITH_RZ, true><<<nb, block, 0, stream>>>(
        pnew, x, r, scale, alpha, theta, h, g, geo, partials);
  else
    pass_b_march<THREE_D, WITH_RZ, false><<<nb, block, 0, stream>>>(
        pnew, x, r, scale, alpha, theta, h, g, geo, partials);
}

static int launch_pass_b_f32(const float* pnew, float* x, float* r,
                             const float* scale, const float* alpha,
                             const float* theta, Halos<float> h, Grid g,
                             bool three_d, bool with_rz, float* partials,
                             float* out, cudaStream_t stream) {
  const MarchGeometry geo = march_geometry(g.n0, g.n1, g.n2, three_d);
  if (geo.blocks < 1) return (int)cudaErrorInvalidConfiguration;
  const bool halo = h.lo0 != nullptr;
  if (halo != (h.hi0 != nullptr)) return (int)cudaErrorInvalidValue;
  // 16-byte copies need every row of every staged plane 16-byte aligned
  const bool vec = g.n2 % 4 == 0 && aligned16(pnew) &&
                   (!halo || (aligned16(h.lo0) && aligned16(h.hi0)));
  if (three_d && with_rz)
    march_b_variant<true, true>(vec, pnew, x, r, scale, alpha, theta, h, g,
                                geo, partials, stream);
  else if (three_d)
    march_b_variant<true, false>(vec, pnew, x, r, scale, alpha, theta, h, g,
                                 geo, partials, stream);
  else if (with_rz)
    march_b_variant<false, true>(vec, pnew, x, r, scale, alpha, theta, h, g,
                                 geo, partials, stream);
  else
    march_b_variant<false, false>(vec, pnew, x, r, scale, alpha, theta, h,
                                  g, geo, partials, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<float><<<with_rz ? 2 : 1, kSumThreads, 0, stream>>>(
      partials, geo.blocks, out);
  return (int)cudaGetLastError();
}

// B6: pass A in float64 on the tile walk of common.cuh, p_new recomputed
// at each neighbour (r + beta * p: no theta).  HALO: p_new is also formed
// from the halos (r_lo, r_hi, p_lo, p_hi) on the planes just outside the
// slab, where walk_column_edges reaches past it (once a column of the
// edge tiles); without, those planes are the Dirichlet zero and the
// kernel is the one without halos, instruction for instruction.
template <typename T, bool THREE_D, bool HALO>
__global__ void __launch_bounds__(256)
pass_a_kernel(const T* __restrict__ r, const T* __restrict__ p,
              T* __restrict__ pnew, const T* __restrict__ scale_p,
              const T* __restrict__ beta_p, Halos<T> h, Grid g,
              T* __restrict__ partials) {
  const T scale = *scale_p, beta = *beta_p;
  const auto edge = [=](const T* re, const T* pe, int64_t c) {
    if constexpr (HALO) return add_rn(re[c], mul_rn(beta, pe[c]));
    else return T(0);
  };
  T acc = T(0);
  walk_column_edges<T, THREE_D>(
      g, (int64_t)blockIdx.x,
      [=](int64_t o) { return add_rn(r[o], mul_rn(beta, p[o])); },
      [=](int64_t c) { return edge(h.lo0, h.lo1, c); },
      [=](int64_t c) { return edge(h.hi0, h.hi1, c); },
      [&](int64_t o, T u, T lap) {
        pnew[o] = u;
        acc = add_rn(acc, mul_rn(u, mul_rn(scale, lap)));
      });
  acc = block_sum(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[blockIdx.x] = acc;
}

// B7: pass B in float64 on the tile walk of common.cuh (no theta): p_new
// loaded again at each neighbour; HALO: p_new's planes just outside the
// slab read from pn_lo, pn_hi.
template <typename T, bool THREE_D, bool HALO>
__global__ void __launch_bounds__(256)
pass_b_kernel(const T* __restrict__ pnew, T* __restrict__ x,
              T* __restrict__ r, const T* __restrict__ scale_p,
              const T* __restrict__ alpha_p, Halos<T> h, Grid g,
              T* __restrict__ partials) {
  const T scale = *scale_p, alpha = *alpha_p;
  const auto edge = [=](const T* e, int64_t c) {
    if constexpr (HALO) return e[c];
    else return T(0);
  };
  T acc = T(0);
  walk_column_edges<T, THREE_D>(
      g, (int64_t)blockIdx.x, [=](int64_t o) { return pnew[o]; },
      [=](int64_t c) { return edge(h.lo0, c); },
      [=](int64_t c) { return edge(h.hi0, c); },
      [&](int64_t o, T u, T lap) {
        x[o] = add_rn(x[o], mul_rn(alpha, u));
        const T rn = sub_rn(r[o], mul_rn(alpha, mul_rn(scale, lap)));
        r[o] = rn;
        acc = add_rn(acc, mul_rn(rn, rn));
      });
  acc = block_sum(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) partials[blockIdx.x] = acc;
}

// B6's and B7's launches, one function per instance (THREE_D, HALO); the
// launchers below index them by the grid and by whether halos are given.
template <bool THREE_D, bool HALO>
static void pass_a_f64(const double* r, const double* p, double* pnew,
                       const double* scale, const double* beta,
                       Halos<double> h, Grid g, unsigned nb,
                       double* partials, cudaStream_t stream) {
  pass_a_kernel<double, THREE_D, HALO><<<nb, tile_block(THREE_D), 0,
                                         stream>>>(r, p, pnew, scale, beta,
                                                   h, g, partials);
}

template <bool THREE_D, bool HALO>
static void pass_b_f64(const double* pnew, double* x, double* r,
                       const double* scale, const double* alpha,
                       Halos<double> h, Grid g, unsigned nb,
                       double* partials, cudaStream_t stream) {
  pass_b_kernel<double, THREE_D, HALO><<<nb, tile_block(THREE_D), 0,
                                         stream>>>(pnew, x, r, scale, alpha,
                                                   h, g, partials);
}

// The ordered sum of a launch's partials into out, once it launched.
static int sum_f64(int64_t blocks, double* partials, double* out,
                   cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<double><<<1, kSumThreads, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

static int launch_pass_a_f64(const double* r, const double* p, double* pnew,
                             const double* scale, const double* beta,
                             Halos<double> h, Grid g, bool three_d,
                             double* partials, double* out,
                             cudaStream_t stream) {
  const bool halo = h.lo0 != nullptr;
  if (halo != (h.hi0 != nullptr) || halo != (h.lo1 != nullptr) ||
      halo != (h.hi1 != nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = tile_blocks(g, three_d);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  decltype(&pass_a_f64<false, false>) const launch[2][2] = {
      {pass_a_f64<false, false>, pass_a_f64<false, true>},
      {pass_a_f64<true, false>, pass_a_f64<true, true>}};
  launch[three_d][halo](r, p, pnew, scale, beta, h, g, (unsigned)blocks,
                        partials, stream);
  return sum_f64(blocks, partials, out, stream);
}

static int launch_pass_b_f64(const double* pnew, double* x, double* r,
                             const double* scale, const double* alpha,
                             Halos<double> h, Grid g, bool three_d,
                             double* partials, double* out,
                             cudaStream_t stream) {
  const bool halo = h.lo0 != nullptr;
  if (halo != (h.hi0 != nullptr)) return (int)cudaErrorInvalidValue;
  const int64_t blocks = tile_blocks(g, three_d);
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  decltype(&pass_b_f64<false, false>) const launch[2][2] = {
      {pass_b_f64<false, false>, pass_b_f64<false, true>},
      {pass_b_f64<true, false>, pass_b_f64<true, true>}};
  launch[three_d][halo](pnew, x, r, scale, alpha, h, g, (unsigned)blocks,
                        partials, stream);
  return sum_f64(blocks, partials, out, stream);
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

// The block count of B3's and B4's launch for this grid (march.cuh): B3
// writes that many partials, B4 that many for each sum.  0 for an empty
// grid or one that needs more blocks than one launch allows.  2D grids
// pass (n0, n1, n2) = (nx, 1, ny) and three_d = 0.
int64_t cmpt_march_blocks(int64_t n0, int64_t n1, int64_t n2, int three_d) {
  return cmpt::march_geometry(n0, n1, n2, three_d != 0).blocks;
}

// B3.  pnew, partials (cmpt_march_blocks floats) and out (1 float)
// are written; theta may be NULL (divisor 1).  r_lo, r_hi, p_lo, p_hi:
// the slab's halo planes (n1 * n2 floats each), all four or all NULL (the
// Dirichlet zero).
int cmpt_cg_pass_a(const float* r, const float* p, float* pnew,
                   const float* scale, const float* beta, const float* theta,
                   const float* r_lo, const float* r_hi, const float* p_lo,
                   const float* p_hi, int64_t n0, int64_t n1, int64_t n2,
                   int three_d, float* partials, float* out,
                   cudaStream_t stream) {
  return cmpt::launch_pass_a_f32(
      r, p, pnew, scale, beta, theta, cmpt::Halos<float>{r_lo, r_hi, p_lo, p_hi},
      cmpt::Grid{n0, n1, n2}, three_d != 0, partials, out, stream);
}

// B6: pass A in float64, without theta; partials (cmpt_tile_blocks
// doubles) and out (1 double: pap) are written.  r_lo, r_hi, p_lo, p_hi:
// the slab's halo planes (n1 * n2 doubles each), all four or all NULL
// (the Dirichlet zero).
int cmpt_cg_pass_a_f64(const double* r, const double* p, double* pnew,
                       const double* scale, const double* beta,
                       const double* r_lo, const double* r_hi,
                       const double* p_lo, const double* p_hi, int64_t n0,
                       int64_t n1, int64_t n2, int three_d, double* partials,
                       double* out, cudaStream_t stream) {
  return cmpt::launch_pass_a_f64(
      r, p, pnew, scale, beta, cmpt::Halos<double>{r_lo, r_hi, p_lo, p_hi},
      cmpt::Grid{n0, n1, n2}, three_d != 0, partials, out, stream);
}

// B4: x and r are updated in place; partials (2 * cmpt_march_blocks
// floats when with_rz, else 1 *) and out (2 floats when with_rz: rr, rz;
// else rr) are written.  theta is read only when with_rz, and may be NULL
// (divisor 1).  pn_lo, pn_hi: p_new's halo planes, both or neither.
int cmpt_cg_pass_b(const float* pnew, float* x, float* r, const float* scale,
                   const float* alpha, const float* theta, const float* pn_lo,
                   const float* pn_hi, int64_t n0, int64_t n1, int64_t n2,
                   int three_d, int with_rz, float* partials, float* out,
                   cudaStream_t stream) {
  return cmpt::launch_pass_b_f32(
      pnew, x, r, scale, alpha, theta,
      cmpt::Halos<float>{pn_lo, pn_hi, nullptr, nullptr},
      cmpt::Grid{n0, n1, n2}, three_d != 0, with_rz != 0, partials, out,
      stream);
}

// B7: pass B in float64 (x and r in place); partials (cmpt_tile_blocks
// doubles) and out (1 double: rr) are written.  pn_lo, pn_hi: p_new's
// halo planes, both or neither.
int cmpt_cg_pass_b_f64(const double* pnew, double* x, double* r,
                       const double* scale, const double* alpha,
                       const double* pn_lo, const double* pn_hi, int64_t n0,
                       int64_t n1, int64_t n2, int three_d, double* partials,
                       double* out, cudaStream_t stream) {
  return cmpt::launch_pass_b_f64(
      pnew, x, r, scale, alpha,
      cmpt::Halos<double>{pn_lo, pn_hi, nullptr, nullptr},
      cmpt::Grid{n0, n1, n2}, three_d != 0, partials, out, stream);
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
