// B10: the whole unpreconditioned CG solve (f32) in ONE launch.
//
// Replaces cuda_mpi_parallel_tpu/ops/pallas/resident.py: _cg_resident_call
// with _resident_kernel at degree 0 (the cg1 kernel and the in-kernel
// Chebyshev degree are later work).
//
// Semantics are _resident_kernel's, line for line: x0 = 0 takes the
// copy-only init (r0 = b), a warm start computes r0 = b - A x0;
// thresh = max(tol, rtol * sqrt(rr0)); the continue condition
// rr >= thresh^2 & rr > 0 & k < cap & healthy is evaluated once per check
// block, which then runs nsteps = min(check_every, cap - k) iterations;
// safe_div freezes only an exact 0/0; the indefinite flag is
// (pap <= 0) & (rr > 0); converged and healthy are decided on the kernel's
// own threshold; the ||r||^2 trace holds rr0 in slot 0, one value per
// block that ran and -1 in every block that never ran.  scale, tol, rtol
// and cap are read from device memory: the host reads nothing during the
// solve.
//
// Bound on an H100: at the sizes the gate admits (5 planes within the
// 50 MB L2: 1024^2 and 128^3 f32) the planes b, x, r, p and Ap stay in
// L2, and DRAM sees b read and x written about once per solve.  What
// bounds an iteration is then the three grid-wide barriers and the three
// passes over L2-resident planes, not DRAM bytes; the flops (about 16
// per cell per iteration) are far below the card's float32 peak.  Design:
//  * one cooperative launch (cudaLaunchCooperativeKernel) with the grid
//    sized at occupancy x SM count, so every block is resident and
//    cooperative_groups' grid.sync() can separate the phases; each block
//    owns the tiles blockIdx.x, blockIdx.x + gridDim.x, ... of the
//    common.cuh tile walk for the whole solve;
//  * three barriers per iteration: after Ap = A p and the pap partials,
//    after the x/r update and the rr partials, and after the p update
//    (p must be complete before any block reads a neighbour's p);
//  * reductions with no float atomics and in lockstep: each block writes
//    its partial into its own slot (one array per reduction, so a block
//    still reading the pap partials is never overwritten by an rr
//    partial), and after the barrier EVERY block sums all partials in the
//    same fixed order with the same code.  Every block so holds the same
//    bits of alpha, beta and rr and takes the same branch at the check
//    test - a block that decided otherwise would leave the rest waiting
//    at the next barrier forever - and two launches on the same inputs
//    give the same bits;
//  * data another block wrote during the launch (p, the partials) is read
//    with __ldcg and p is written with __stcg: through L2, never from a
//    stale L1 line.  A thread's own x, r and Ap are only read back by that
//    thread;
//  * every product and sum is an _rn intrinsic (common.cuh), so nvcc
//    contracts nothing the plain twin rounds twice.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cmpt {

namespace cgr = cooperative_groups;

struct ResidentArgs {
  const float* b;
  const float* x0;      // nullptr: the x0 = 0 fast path
  float* x;
  float* r;
  float* p;
  float* ap;
  const float* params;  // scale, tol, rtol
  const int* cap;
  float* part_pap;      // one slot per block
  float* part_rr;       // one slot per block
  float* rr_out;        // final ||r||^2
  int* flags;           // iterations, indefinite, converged, healthy
  float* hist;          // nblocks + 1 slots
  Grid g;
  int64_t tiles;
  int nblocks;
  int check_every;
};

__device__ __forceinline__ float safe_div(float num, float den) {
  return (num == 0.0f && den == 0.0f) ? 0.0f : __fdiv_rn(num, den);
}

// max that propagates NaN, as jnp.maximum / torch.maximum do
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// This block's partial into its own slot.
__device__ __forceinline__ void put_partial(float* part, float v) {
  v = block_sum(v);
  if (threadIdx.x == 0 && threadIdx.y == 0) __stcg(part + blockIdx.x, v);
}

// The sum of all n partials, in one fixed order, broadcast to every thread:
// the same code on the same slots, so every block gets the same bits.
__device__ __forceinline__ float grid_total(const float* part, int n) {
  __shared__ float total;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  float v = 0.0f;
  for (int i = tid; i < n; i += nt) v = add_rn(v, __ldcg(part + i));
  v = block_sum(v);
  if (tid == 0) total = v;
  __syncthreads();
  return total;
}

// The minimum blocks per SM hold the registers to what four (2D) or two
// (3D) resident 256-thread blocks allow: 4 x 132 SMs covers the 512 tiles
// of a 1024^2 grid, one per block.  Unbounded, the warm-start init's
// registers leave room for three 2D blocks per SM, and some blocks then
// walk two tiles per pass.
template <bool THREE_D>
__global__ void __launch_bounds__(256, THREE_D ? 2 : 4)
    resident_kernel(ResidentArgs a) {
  cgr::grid_group grid = cgr::this_grid();
  // the planes as locals, so the lambdas below capture registers
  const float* b = a.b;
  const float* x0 = a.x0;
  float* x = a.x;
  float* r = a.r;
  float* p = a.p;
  float* ap = a.ap;
  const Grid g = a.g;
  const float scale = a.params[0], tol = a.params[1], rtol = a.params[2];
  const int cap = *a.cap;
  const int nb = gridDim.x;
  const int64_t first = blockIdx.x;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0;

  // init: x = x0 (or 0), r = p = b - A x0 (or b), partials of r.r; every
  // block takes the same branch
  float acc = 0.0f;
  for (int64_t tile = first; tile < a.tiles; tile += nb) {
    if (x0 != nullptr) {
      walk_column<float, THREE_D>(
          g, tile, [&](int64_t o) { return x0[o]; },
          [&](int64_t o, float u, float lap) {
            const float r0 = sub_rn(b[o], mul_rn(scale, lap));
            x[o] = u;
            r[o] = r0;
            __stcg(p + o, r0);
            acc = add_rn(acc, mul_rn(r0, r0));
          });
    } else {
      for_each_point(g, tile, [&](int64_t o) {
        const float r0 = b[o];
        x[o] = 0.0f;
        r[o] = r0;
        __stcg(p + o, r0);
        acc = add_rn(acc, mul_rn(r0, r0));
      });
    }
  }
  put_partial(a.part_rr, acc);
  {
    const int64_t stride = (int64_t)nb * blockDim.x * blockDim.y;
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x * blockDim.y +
                     threadIdx.y * blockDim.x + threadIdx.x;
         j <= a.nblocks; j += stride)
      a.hist[j] = -1.0f;  // sentinel: the block never ran
  }
  grid.sync();

  float rr = grid_total(a.part_rr, nb);
  float rho = rr;
  const float thresh = max_nan(tol, mul_rn(rtol, __fsqrt_rn(rr)));
  const float thresh2 = mul_rn(thresh, thresh);
  if (lead) a.hist[0] = rr;
  int k = 0, indefinite = 0;

  for (int blk = 0; blk < a.nblocks; ++blk) {
    const bool healthy = isfinite(rr) && isfinite(rho) && rho > 0.0f;
    // Once false the condition stays false (nothing changes between
    // blocks that do not run), so the walk over blocks stops here.
    if (!(rr >= thresh2 && rr > 0.0f && k < cap && healthy)) break;
    const int nsteps = min(a.check_every, cap - k);
    for (int step = 0; step < nsteps; ++step) {
      // phase 1: Ap = A p (stored), partials of p.Ap
      acc = 0.0f;
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        walk_column<float, THREE_D>(
            g, tile, [&](int64_t o) { return __ldcg(p + o); },
            [&](int64_t o, float u, float lap) {
              const float v = mul_rn(scale, lap);
              ap[o] = v;
              acc = add_rn(acc, mul_rn(u, v));
            });
      put_partial(a.part_pap, acc);
      grid.sync();
      const float pap = grid_total(a.part_pap, nb);
      if (pap <= 0.0f && rr > 0.0f) indefinite = 1;
      const float alpha = safe_div(rho, pap);

      // phase 2: x += alpha p, r -= alpha Ap, partials of r.r
      acc = 0.0f;
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        for_each_point(g, tile, [&](int64_t o) {
          x[o] = add_rn(x[o], mul_rn(alpha, __ldcg(p + o)));
          const float rn = sub_rn(r[o], mul_rn(alpha, ap[o]));
          r[o] = rn;
          acc = add_rn(acc, mul_rn(rn, rn));
        });
      put_partial(a.part_rr, acc);
      grid.sync();
      const float rr_new = grid_total(a.part_rr, nb);
      const float beta = safe_div(rr_new, rho);

      // phase 3: p = r + beta p
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        for_each_point(g, tile, [&](int64_t o) {
          __stcg(p + o, add_rn(r[o], mul_rn(beta, __ldcg(p + o))));
        });
      grid.sync();
      rr = rr_new;
      rho = rr_new;
    }
    k += nsteps;
    if (lead) a.hist[blk + 1] = rr;
  }

  if (lead) {
    *a.rr_out = rr;
    a.flags[0] = k;
    a.flags[1] = indefinite;
    a.flags[2] = (rr < thresh2 || rr == 0.0f) ? 1 : 0;
    a.flags[3] = (isfinite(rr) && isfinite(rho) && (rho > 0.0f || rr == 0.0f))
                     ? 1 : 0;
  }
}

// The kernel variant and its cooperative grid: occupancy x SM count
// blocks, at most one per tile of the walk.
static cudaError_t resident_grid(bool three_d, int64_t tiles, const void** fn,
                                 int64_t* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *fn = three_d ? (const void*)resident_kernel<true>
                : (const void*)resident_kernel<false>;
  const dim3 block = tile_block(three_d);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, *fn, (int)(block.x * block.y), 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = (int64_t)per_sm * sms < tiles ? (int64_t)per_sm * sms : tiles;
  return cudaSuccess;
}

}  // namespace cmpt

extern "C" {

// One cooperative launch of the whole solve on `stream`.  x, r, p, ap are
// grid planes (written); partials holds 2 * cmpt_tile_blocks floats;
// params = (scale, tol, rtol); cap = the iteration cap; rr_out (1 float),
// flags (4 ints: iterations, indefinite, converged, healthy) and hist
// (nblocks + 1 floats) are written.  x0 may be NULL (x0 = 0).  2D grids
// pass (n0, n1, n2) = (nx, 1, ny) and three_d = 0.  Returns the launch's
// cudaError_t (cudaErrorCooperativeLaunchTooLarge and the like when the
// card refuses it).
int cmpt_cg_resident(const float* b, const float* x0, float* x, float* r,
                     float* p, float* ap, const float* params, const int* cap,
                     float* partials, float* rr_out, int* flags, float* hist,
                     int64_t n0, int64_t n1, int64_t n2, int three_d,
                     int nblocks, int check_every, cudaStream_t stream) {
  using namespace cmpt;
  const Grid g{n0, n1, n2};
  const int64_t tiles = tile_blocks(g, three_d != 0);
  if (tiles <= 0 || nblocks < 0 || check_every < 1)
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  int64_t blocks = 0;
  cudaError_t err = resident_grid(three_d != 0, tiles, &fn, &blocks);
  if (err != cudaSuccess) return (int)err;
  ResidentArgs args{b, x0, x, r, p, ap, params, cap,
                    partials, partials + tiles, rr_out, flags, hist,
                    g, tiles, nblocks, check_every};
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)blocks),
                                    tile_block(three_d != 0), kargs, 0,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
