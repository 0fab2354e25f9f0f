// B10: the whole CG solve (f32) in ONE launch, unpreconditioned or with
// the Chebyshev polynomial preconditioner applied inside the kernel; and
// B11: the same solve in float64.
//
// Replaces cuda_mpi_parallel_tpu/ops/pallas/resident.py: _cg_resident_call
// with _resident_kernel at every degree (and with _resident_kernel_cg1:
// resident_cg1_kernel below, or the one-barrier body of resident_dist.cu),
// and _cg_resident_df64_call
// (_resident_kernel_df64).  The TPU's df64
// kernel keeps (hi, lo) f32 planes and sums through error-free fold trees
// for want of f64 units; B11 is this kernel instantiated with T = double.
// Two things differ between the lanes, as between the JAX kernels: the
// threshold (f32: max(tol, rtol ||r0||)^2; f64: max(tol^2, rtol^2
// ||r0||^2), solver.df64's) and the Chebyshev parameters (f32: lmin and
// lmax; f64: the centre theta and half-width delta of
// solver.df64.chebyshev_interval).
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
// 50 MB L2: 1024^2 and 128^3 f32, 1024^2 and 109^3 f64) the planes stay in
// L2, and DRAM sees b read and x written about once per solve.  What
// bounds an iteration is then its grid-wide barriers and its passes over
// L2-resident planes, not DRAM bytes; the flops (about 16 per cell per
// iteration) are far below the card's float32 and float64 peaks.
//
// Which shapes run where.  Two bodies; the f32 C entry picks one from the
// shape alone (never from a failure), and they give the same bits:
//  * B12's body at one shard (resident_dist.cu, resident_dist_kernel with
//    P = 1 and this launch's own exchange region) takes every f32 solve
//    whose tiles fit its shared slots: dist_geometry(n0, n1, n2, three_d,
//    1, SMs).fits (resident_dist.cuh), at most 3 tiles a CTA in 2D and 7
//    in 3D at B10's four and two CTAs per SM - on 132 SMs up to 1,584
//    tiles of 8 x 256 points or 1,848 of 8 x 8 x 32.  That is every
//    square and cube the gate admits (1024^2, 128^3; squares to 1,619,
//    cubes to 137), warm starts and every Chebyshev degree included.  Two
//    barriers an iteration, each carrying its reduction (the CTA that
//    completes it sums the partials once, where the tile walk has every
//    block sum them); p formed where it is read, in two p planes (p and
//    ap here), so the p pass and its barrier are gone; Ap, the Chebyshev
//    d and x in shared memory.
//  * the tile walk below (resident_kernel<float, ...>) takes the thin or
//    ragged f32 grids past those slots (e.g. 12,800 x 200: 1,600 tiles),
//    and, as resident_kernel<double, ...>, every f64 solve (B11).
// At one shard B12's body keeps the tile walk's grid (B10's CTAs per SM,
// at most one a tile), walks the same tiles in the same order, does the
// same operations in the same order and sums the same partials in the
// same fixed order, so x, the trace and the iteration count are the same
// bits on both.  cmpt_cg_resident's `instance` is a check hook, not a
// tuning option: it forces one body (1: B12's, which refuses a grid past
// its slots; 2: the tile walk) for the checks that hold them equal; the
// solver passes 0, by shape.
//
// The tile walk:
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
//
// The preconditioned variant (PRECOND, degree k >= 1) follows
// _resident_kernel's precond(): z = P(A) r after each r update (and at
// init), rho = r . z, beta = rho / rho_old, p = z + beta p.
//  * degree 1: z = r / theta is formed where it is used (the rho partials
//    of the r-update pass, and p), so the iteration keeps three barriers;
//  * degree k >= 2: k - 1 Chebyshev steps, each a pass over the block's
//    tiles that reads its neighbours' z (the first reads its neighbours'
//    r, forming z0 = r / theta on the fly) and a grid barrier, the last
//    one also writing the rho partials: 3 + (k - 1) barriers;
//  * r, Ap and the z buffers are now read across blocks, so in this
//    variant they are written with __stcg and read with __ldcg; d is read
//    and written only by its own thread;
//  * seven planes instead of five: a second z buffer and d (Ap's plane is
//    the first z buffer once the r update has read it);
//  * theta, delta, sigma and each step's c1, c2 come from lmin and lmax in
//    device memory, computed by every thread with the same code, so all
//    blocks hold the same bits.
// The preconditioner is a template parameter, so the degree-0 variants
// compile as they did without it.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "resident.cuh"
#include "resident_dist.cuh"

namespace cmpt {

namespace cgr = cooperative_groups;

template <typename T>
struct ResidentArgs {
  const T* b;
  const T* x0;      // nullptr: the x0 = 0 fast path
  T* x;
  T* r;
  T* p;
  T* ap;            // with PRECOND also the first z buffer
  T* z2;            // the second z buffer (degree >= 3)
  T* d;             // Chebyshev d (degree >= 2)
  const T* params;  // scale, tol, rtol, and the interval (see cheb_of)
  const int* cap;
  T* part_pap;      // one slot per block
  T* part_rr;       // one slot per block
  T* part_rz;       // one slot per block (rho = r . z, PRECOND)
  T* rr_out;        // final ||r||^2
  int* flags;       // iterations, indefinite, converged, healthy
  T* hist;          // nblocks + 1 slots
  Grid g;
  int64_t tiles;
  int nblocks;
  int check_every;
  int degree;       // Chebyshev terms; 0 = unpreconditioned
};

// z = P(A) r for degree >= 2: degree - 1 Chebyshev steps, each a pass and
// a grid barrier; the last writes the partials of r . z into part_rz.
// Returns the plane holding z (ap or z2).  r must be complete (a barrier
// since it was written).
template <typename T, bool THREE_D>
__device__ __forceinline__ T* cheb_apply(const ResidentArgs<T>& a,
                                         cgr::grid_group& grid, T scale,
                                         Cheb<T> cb) {
  const Grid g = a.g;
  const int nb = gridDim.x;
  const T* r = a.r;
  T* d = a.d;
  const T theta = cb.theta;
  T rho_c = div_rn(T(1), cb.sigma);
  const T* zin = r;
  T* zout = a.ap;
  for (int j = 0; j < a.degree - 1; ++j) {
    const T rho_n = div_rn(T(1), sub_rn(mul_rn(T(2), cb.sigma), rho_c));
    const T c1 = mul_rn(rho_n, rho_c);
    const T c2 = div_rn(mul_rn(T(2), rho_n), cb.delta);
    const bool last = j == a.degree - 2;
    zout = (j % 2 == 0) ? a.ap : a.z2;
    T* out = zout;
    T acc = T(0);
    for (int64_t tile = blockIdx.x; tile < a.tiles; tile += nb) {
      if (j == 0) {
        // z0 = d0 = r / theta, at the neighbours too
        walk_column<T, THREE_D>(
            g, tile, [&](int64_t o) { return div_rn(__ldcg(r + o), theta); },
            [&](int64_t o, T z, T lap) {
              const T rv = __ldcg(r + o);
              const T dn = add_rn(
                  mul_rn(c1, z), mul_rn(c2, sub_rn(rv, mul_rn(scale, lap))));
              const T zn = add_rn(z, dn);
              __stcg(out + o, zn);
              d[o] = dn;
              if (last) acc = add_rn(acc, mul_rn(rv, zn));
            });
      } else {
        walk_column<T, THREE_D>(
            g, tile, [&](int64_t o) { return __ldcg(zin + o); },
            [&](int64_t o, T z, T lap) {
              const T rv = __ldcg(r + o);
              const T dn = add_rn(
                  mul_rn(c1, d[o]), mul_rn(c2, sub_rn(rv, mul_rn(scale, lap))));
              const T zn = add_rn(z, dn);
              __stcg(out + o, zn);
              d[o] = dn;
              if (last) acc = add_rn(acc, mul_rn(rv, zn));
            });
      }
    }
    if (last) put_partial(a.part_rz, acc);
    grid.sync();
    zin = zout;
    rho_c = rho_n;
  }
  return zout;
}

// Resident 256-thread blocks per SM that __launch_bounds__ asks the
// compiler to keep room for.  f32: four (2D) or two (3D), which holds the
// registers to 64 and 128 a thread: 4 x 132 SMs covers the 512 tiles of a
// 1024^2 grid, one per block.  Unbounded, the f32 warm-start init's
// registers leave room for three 2D blocks per SM, and some blocks then
// walk two tiles per pass.  The preconditioned variants keep the same
// bound.  f64: two in 2D and 3D (128 registers a thread): a double takes
// two registers, and under the f32 lane's 64 the 2D f64 variants would
// spill their working values; at 1024^2 the 264 blocks then walk one or
// two tiles each.  The cooperative grid is sized from the occupancy of the
// instance that is launched, so the bound sets the grid, never a refusal.
template <typename T, bool THREE_D, bool PRECOND>
__global__ void __launch_bounds__(256, sizeof(T) == 8 ? 2 : (THREE_D ? 2 : 4))
    resident_kernel(ResidentArgs<T> a) {
  cgr::grid_group grid = cgr::this_grid();
  // the planes as locals, so the lambdas below capture registers
  const T* b = a.b;
  const T* x0 = a.x0;
  T* x = a.x;
  T* r = a.r;
  T* p = a.p;
  T* ap = a.ap;
  const Grid g = a.g;
  const T scale = a.params[0], tol = a.params[1], rtol = a.params[2];
  const int cap = *a.cap;
  const int nb = gridDim.x;
  const int64_t first = blockIdx.x;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0;
  // degree 1 forms z = r / theta where it is used
  Cheb<T> cb{T(1), T(1), T(1)};
  bool by_theta = false;
  if constexpr (PRECOND) {
    cb = cheb_of(a.params[3], a.params[4]);
    by_theta = a.degree == 1;
  }
  const T theta = cb.theta;

  // init: x = x0 (or 0), r = b - A x0 (or b), partials of r.r; p = r
  // unpreconditioned, r / theta at degree 1 (with the partials of
  // r . r / theta); every block takes the same branch
  T acc = T(0), acc_rz = T(0);
  auto seed = [&](int64_t o, T r0) {
    if constexpr (PRECOND) {
      __stcg(r + o, r0);
      if (by_theta) {
        const T z0 = div_rn(r0, theta);
        __stcg(p + o, z0);
        acc_rz = add_rn(acc_rz, mul_rn(r0, z0));
      }
    } else {
      r[o] = r0;
      __stcg(p + o, r0);
    }
    acc = add_rn(acc, mul_rn(r0, r0));
  };
  for (int64_t tile = first; tile < a.tiles; tile += nb) {
    if (x0 != nullptr) {
      walk_column<T, THREE_D>(
          g, tile, [&](int64_t o) { return x0[o]; },
          [&](int64_t o, T u, T lap) {
            x[o] = u;
            seed(o, sub_rn(b[o], mul_rn(scale, lap)));
          });
    } else {
      for_each_point(g, tile, [&](int64_t o) {
        x[o] = T(0);
        seed(o, b[o]);
      });
    }
  }
  put_partial(a.part_rr, acc);
  if constexpr (PRECOND) {
    if (by_theta) put_partial(a.part_rz, acc_rz);
  }
  {
    const int64_t stride = (int64_t)nb * blockDim.x * blockDim.y;
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x * blockDim.y +
                     threadIdx.y * blockDim.x + threadIdx.x;
         j <= a.nblocks; j += stride)
      a.hist[j] = T(-1);  // sentinel: the block never ran
  }
  grid.sync();

  T rr = grid_total(a.part_rr, nb);
  T rho = rr;
  if constexpr (PRECOND) {
    if (by_theta) {
      rho = grid_total(a.part_rz, nb);
    } else {
      // p0 = z0 = P(A) r0
      const T* z = cheb_apply<T, THREE_D>(a, grid, scale, cb);
      rho = grid_total(a.part_rz, nb);
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        for_each_point(g, tile,
                       [&](int64_t o) { __stcg(p + o, __ldcg(z + o)); });
      grid.sync();
    }
  }
  const T thresh2 = threshold2(tol, rtol, rr);
  if (lead) a.hist[0] = rr;
  int k = 0, indefinite = 0;

  for (int blk = 0; blk < a.nblocks; ++blk) {
    const bool healthy = isfinite(rr) && isfinite(rho) && rho > T(0);
    // Once false the condition stays false (nothing changes between
    // blocks that do not run), so the walk over blocks stops here.
    if (!(rr >= thresh2 && rr > T(0) && k < cap && healthy)) break;
    const int nsteps = min(a.check_every, cap - k);
    for (int step = 0; step < nsteps; ++step) {
      // phase 1: Ap = A p (stored), partials of p.Ap
      acc = T(0);
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        walk_column<T, THREE_D>(
            g, tile, [&](int64_t o) { return __ldcg(p + o); },
            [&](int64_t o, T u, T lap) {
              const T v = mul_rn(scale, lap);
              if constexpr (PRECOND) __stcg(ap + o, v);
              else ap[o] = v;
              acc = add_rn(acc, mul_rn(u, v));
            });
      put_partial(a.part_pap, acc);
      grid.sync();
      const T pap = grid_total(a.part_pap, nb);
      if (pap <= T(0) && rr > T(0)) indefinite = 1;
      const T alpha = safe_div(rho, pap);

      // phase 2: x += alpha p, r -= alpha Ap, partials of r.r (and of
      // r . r / theta at degree 1)
      acc = T(0);
      acc_rz = T(0);
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        for_each_point(g, tile, [&](int64_t o) {
          x[o] = add_rn(x[o], mul_rn(alpha, __ldcg(p + o)));
          if constexpr (PRECOND) {
            const T rn = sub_rn(__ldcg(r + o), mul_rn(alpha, __ldcg(ap + o)));
            __stcg(r + o, rn);
            acc = add_rn(acc, mul_rn(rn, rn));
            if (by_theta)
              acc_rz = add_rn(acc_rz, mul_rn(rn, div_rn(rn, theta)));
          } else {
            const T rn = sub_rn(r[o], mul_rn(alpha, ap[o]));
            r[o] = rn;
            acc = add_rn(acc, mul_rn(rn, rn));
          }
        });
      put_partial(a.part_rr, acc);
      if constexpr (PRECOND) {
        if (by_theta) put_partial(a.part_rz, acc_rz);
      }
      grid.sync();
      const T rr_new = grid_total(a.part_rr, nb);
      T rho_new = rr_new;

      // phase 3: p = z + beta p
      if constexpr (PRECOND) {
        const T* z = by_theta ? nullptr
                              : cheb_apply<T, THREE_D>(a, grid, scale, cb);
        rho_new = grid_total(a.part_rz, nb);
        const T beta = safe_div(rho_new, rho);
        for (int64_t tile = first; tile < a.tiles; tile += nb)
          for_each_point(g, tile, [&](int64_t o) {
            const T zo = by_theta ? div_rn(__ldcg(r + o), theta)
                                  : __ldcg(z + o);
            __stcg(p + o, add_rn(zo, mul_rn(beta, __ldcg(p + o))));
          });
      } else {
        const T beta = safe_div(rr_new, rho);
        for (int64_t tile = first; tile < a.tiles; tile += nb)
          for_each_point(g, tile, [&](int64_t o) {
            __stcg(p + o, add_rn(r[o], mul_rn(beta, __ldcg(p + o))));
          });
      }
      grid.sync();
      rr = rr_new;
      rho = rho_new;
    }
    k += nsteps;
    if (lead) a.hist[blk + 1] = rr;
  }

  if (lead) {
    *a.rr_out = rr;
    a.flags[0] = k;
    a.flags[1] = indefinite;
    a.flags[2] = (rr < thresh2 || rr == T(0)) ? 1 : 0;
    a.flags[3] = (isfinite(rr) && isfinite(rho) && (rho > T(0) || rr == T(0)))
                     ? 1 : 0;
  }
}

template <typename T>
static const void* resident_fn(bool three_d, bool precond) {
  if (three_d)
    return precond ? (const void*)resident_kernel<T, true, true>
                   : (const void*)resident_kernel<T, true, false>;
  return precond ? (const void*)resident_kernel<T, false, true>
                 : (const void*)resident_kernel<T, false, false>;
}

// SMs of the current device.
static cudaError_t sm_count(int* sms) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Resident blocks per SM of kernel fn on the current device.
static cudaError_t per_sm_of(const void* fn, bool three_d, int* per_sm) {
  const dim3 block = tile_block(three_d);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, fn, (int)(block.x * block.y), 0);
}

// The cooperative grid of kernel fn: occupancy x SM count blocks, at most
// one per tile of the walk.
static cudaError_t coop_grid(const void* fn, bool three_d, int64_t tiles,
                             int64_t* blocks) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = per_sm_of(fn, three_d, &per_sm);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = (int64_t)per_sm * sms < tiles ? (int64_t)per_sm * sms : tiles;
  return cudaSuccess;
}

// One cooperative launch of the whole solve (either lane).
template <typename T>
static int launch_resident(const T* b, const T* x0, T* x, T* r, T* p, T* ap,
                           T* z2, T* d, const T* params, const int* cap,
                           T* partials, T* rr_out, int* flags, T* hist,
                           Grid g, bool three_d, int nblocks, int check_every,
                           int degree, cudaStream_t stream) {
  const int64_t tiles = tile_blocks(g, three_d);
  if (tiles <= 0 || nblocks < 0 || check_every < 1 || degree < 0 ||
      (degree >= 2 && d == nullptr) || (degree >= 3 && z2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* fn = resident_fn<T>(three_d, degree > 0);
  int64_t blocks = 0;
  cudaError_t err = coop_grid(fn, three_d, tiles, &blocks);
  if (err != cudaSuccess) return (int)err;
  ResidentArgs<T> args{b, x0, x, r, p, ap, z2, d, params, cap,
                       partials, partials + tiles, partials + 2 * tiles,
                       rr_out, flags, hist, g, tiles, nblocks, check_every,
                       degree};
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)blocks),
                                    tile_block(three_d), kargs, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// B10's cg1 kernel: the whole Chronopoulos-Gear solve (f32,
// unpreconditioned) in one launch.
//
// Replaces cuda_mpi_parallel_tpu/ops/pallas/resident.py:
// _cg_resident_call with _resident_kernel_cg1.  Semantics line for line:
// x0 = 0 takes the copy-only init, a warm start computes r0 = b - A x0;
// w0 = A r0, rr0 = r . r, delta0 = w0 . r0, p = r0, s = w0, alpha carried
// one step ahead (safe_div(rr0, delta0)), the indefinite flag seeded with
// (delta0 <= 0) & (rr0 > 0); the threshold max(tol, rtol sqrt(rr0))^2;
// per check block nsteps = min(check_every, cap - k); per iteration
//   x += alpha p, r -= alpha s, w = A r, rr' = r . r, delta = w . r,
//   beta = rr' / rr, denom = delta - beta (rr' / alpha),
//   alpha' = rr' / denom, indefinite |= (denom <= 0) & (rr' > 0),
//   p = r + beta p, s = w + beta s;
// healthy is finite rr and finite alpha, converged rr < thresh^2 or
// rr == 0; the ||r||^2 trace holds rr0 in slot 0, one value per block
// that ran and -1 elsewhere.
//
// Which shapes run where.  Two bodies, which give the same bits; the C
// entry (cmpt_cg_resident_cg1) picks one from the shape alone, as
// cmpt_cg_resident does: the one-barrier body (resident_dist.cu's
// resident_cg1_shard_kernel: one pass and one barrier an iteration, r
// formed where it is read, p and x in shared memory) takes every grid
// whose tiles fit B12's shared slots, dist_geometry(n0, n1, n2, three_d,
// 1, SMs).fits - every square and cube the cg1 gate admits (1024^2,
// 128^3; squares to 1,478, cubes to 129) - and this kernel, the tile walk,
// the thin or ragged grids past them (e.g. 12,800 x 147: 1,600 tiles).
//
// What bounds it on an H100: as B10's plain kernel, the grid barriers and
// passes over L2-resident planes, not bytes or flops.  Design:
//  * one cooperative launch, the grid sized from this kernel's own
//    occupancy query; each block owns fixed tiles of the common.cuh walk;
//    fixed-order per-block partials summed by every block (no float
//    atomics); _rn arithmetic throughout - as resident_kernel;
//  * TWO grid barriers and two passes per iteration, against the plain
//    kernel's three.  Of the six planes (b, x, r, p, s, w) only r is read
//    across blocks (for w = A r); p, s, w and x are read only by the
//    thread that owns the point.  So:
//      pass 1: every block has summed the previous pass's partials and
//        holds beta, alpha; it finishes iteration k's direction update
//        (p = r + beta p, s = w + beta s) and starts iteration k + 1
//        (x += alpha p, r -= alpha s) at its own points, r written with
//        __stcg;  barrier 1;
//      pass 2: w = A r, reading the neighbours' r with __ldcg; w stored at
//        the block's own points; the rr and delta partials into two slot
//        arrays;  barrier 2.
//    Safe: pass 2 reads the neighbours' r after barrier 1, and nothing
//    writes r again until the next pass 1, after barrier 2.  The partials
//    are written in pass 2 and read by every block after barrier 2, before
//    its next pass 1, so no block overwrites a slot another still reads.
//    The direction update deferred to the next pass 1 leaves x exact at
//    exit; the p and s still pending when the solve stops are not outputs;
//  * six planes against B10's five: s takes the place of Ap, and w is
//    new.
// Its own __launch_bounds__: four 2D or two 3D blocks per SM (64 or 128
// registers a thread), as the f32 resident_kernel.
struct Cg1Args {
  const float* b;
  const float* x0;     // nullptr: the x0 = 0 fast path
  float* x;
  float* r;
  float* p;
  float* s;            // A p, by recurrence
  float* w;            // A r
  const float* params; // scale, tol, rtol
  const int* cap;
  float* part_rr;      // one slot per block
  float* part_delta;   // one slot per block
  float* rr_out;       // final ||r||^2
  int* flags;          // iterations, indefinite, converged, healthy
  float* hist;         // nblocks + 1 slots
  Grid g;
  int64_t tiles;
  int nblocks;
  int check_every;
};

template <bool THREE_D>
__global__ void __launch_bounds__(256, THREE_D ? 2 : 4)
    resident_cg1_kernel(Cg1Args a) {
  cgr::grid_group grid = cgr::this_grid();
  const float* b = a.b;
  const float* x0 = a.x0;
  float* x = a.x;
  float* r = a.r;
  float* p = a.p;
  float* s = a.s;
  float* w = a.w;
  const Grid g = a.g;
  const float scale = a.params[0], tol = a.params[1], rtol = a.params[2];
  const int cap = *a.cap;
  const int nb = gridDim.x;
  const int64_t first = blockIdx.x;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0 && threadIdx.y == 0;

  // init: x = x0 and r0 = b - A x0 (a pass and a barrier) or x = 0 and
  // r0 = b; then w0 = A r0 into s, p = r0, the partials of r.r and w.r
  if (x0 != nullptr) {
    for (int64_t tile = first; tile < a.tiles; tile += nb)
      walk_column<float, THREE_D>(
          g, tile, [&](int64_t o) { return x0[o]; },
          [&](int64_t o, float u, float lap) {
            x[o] = u;
            __stcg(r + o, sub_rn(b[o], mul_rn(scale, lap)));
          });
    grid.sync();
  }
  float acc_rr = 0.f, acc_d = 0.f;
  for (int64_t tile = first; tile < a.tiles; tile += nb)
    walk_column<float, THREE_D>(
        g, tile,
        [&](int64_t o) { return x0 != nullptr ? __ldcg(r + o) : b[o]; },
        [&](int64_t o, float u, float lap) {
          if (x0 == nullptr) {
            x[o] = 0.f;
            __stcg(r + o, u);
          }
          const float wv = mul_rn(scale, lap);
          p[o] = u;
          s[o] = wv;
          acc_rr = add_rn(acc_rr, mul_rn(u, u));
          acc_d = add_rn(acc_d, mul_rn(wv, u));
        });
  put_partial(a.part_rr, acc_rr);
  put_partial(a.part_delta, acc_d);
  {
    const int64_t stride = (int64_t)nb * blockDim.x * blockDim.y;
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x * blockDim.y +
                     threadIdx.y * blockDim.x + threadIdx.x;
         j <= a.nblocks; j += stride)
      a.hist[j] = -1.f;  // sentinel: the block never ran
  }
  grid.sync();

  float rr = grid_total(a.part_rr, nb);
  const float delta0 = grid_total(a.part_delta, nb);
  float alpha = safe_div(rr, delta0);
  int indefinite = (delta0 <= 0.f && rr > 0.f) ? 1 : 0;
  const float thresh2 = threshold2(tol, rtol, rr);
  if (lead) a.hist[0] = rr;
  float beta = 0.f;
  bool pending = false;  // p and s still owe iteration k's update
  int k = 0;

  for (int blk = 0; blk < a.nblocks; ++blk) {
    const bool healthy = isfinite(rr) && isfinite(alpha);
    if (!(rr >= thresh2 && rr > 0.f && k < cap && healthy)) break;
    const int nsteps = min(a.check_every, cap - k);
    for (int step = 0; step < nsteps; ++step) {
      // pass 1: p, s (iteration k), then x and r (iteration k + 1)
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        for_each_point(g, tile, [&](int64_t o) {
          const float ro = __ldcg(r + o);
          float po = p[o], so = s[o];
          if (pending) {
            po = add_rn(ro, mul_rn(beta, po));
            so = add_rn(w[o], mul_rn(beta, so));
            p[o] = po;
            s[o] = so;
          }
          x[o] = add_rn(x[o], mul_rn(alpha, po));
          __stcg(r + o, sub_rn(ro, mul_rn(alpha, so)));
        });
      grid.sync();
      // pass 2: w = A r, partials of r . r and w . r
      acc_rr = 0.f;
      acc_d = 0.f;
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        walk_column<float, THREE_D>(
            g, tile, [&](int64_t o) { return __ldcg(r + o); },
            [&](int64_t o, float u, float lap) {
              const float wv = mul_rn(scale, lap);
              w[o] = wv;
              acc_rr = add_rn(acc_rr, mul_rn(u, u));
              acc_d = add_rn(acc_d, mul_rn(wv, u));
            });
      put_partial(a.part_rr, acc_rr);
      put_partial(a.part_delta, acc_d);
      grid.sync();
      const float rr_new = grid_total(a.part_rr, nb);
      const float delta = grid_total(a.part_delta, nb);
      beta = safe_div(rr_new, rr);
      const float denom =
          sub_rn(delta, mul_rn(beta, safe_div(rr_new, alpha)));
      alpha = safe_div(rr_new, denom);
      if (denom <= 0.f && rr_new > 0.f) indefinite = 1;
      rr = rr_new;
      pending = true;
    }
    k += nsteps;
    if (lead) a.hist[blk + 1] = rr;
  }

  if (lead) {
    *a.rr_out = rr;
    a.flags[0] = k;
    a.flags[1] = indefinite;
    a.flags[2] = (rr < thresh2 || rr == 0.f) ? 1 : 0;
    a.flags[3] = (isfinite(rr) && isfinite(alpha)) ? 1 : 0;
  }
}

static const void* cg1_fn(bool three_d) {
  return three_d ? (const void*)resident_cg1_kernel<true>
                 : (const void*)resident_cg1_kernel<false>;
}

static int launch_cg1(const float* b, const float* x0, float* x, float* r,
                      float* p, float* s, float* w, const float* params,
                      const int* cap, float* partials, float* rr_out,
                      int* flags, float* hist, Grid g, bool three_d,
                      int nblocks, int check_every, cudaStream_t stream) {
  const int64_t tiles = tile_blocks(g, three_d);
  if (tiles <= 0 || nblocks < 0 || check_every < 1)
    return (int)cudaErrorInvalidValue;
  const void* fn = cg1_fn(three_d);
  int64_t blocks = 0;
  cudaError_t err = coop_grid(fn, three_d, tiles, &blocks);
  if (err != cudaSuccess) return (int)err;
  Cg1Args args{b, x0, x, r, p, s, w, params, cap, partials, partials + tiles,
               rr_out, flags, hist, g, tiles, nblocks, check_every};
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)blocks),
                                    tile_block(three_d), kargs, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace cmpt

extern "C" {

// One cooperative launch of the whole solve on `stream`.  x, r, p, ap are
// grid planes (written); z2 (degree >= 3) and d (degree >= 2) are grid
// planes or NULL; partials holds 3 * cmpt_tile_blocks floats; params =
// (scale, tol, rtol, lmin, lmax); cap = the iteration cap; rr_out (1
// float), flags (4 ints: iterations, indefinite, converged, healthy) and
// hist (nblocks + 1 floats) are written.  x0 may be NULL (x0 = 0).  2D
// grids pass (n0, n1, n2) = (nx, 1, ny) and three_d = 0.  degree 0 runs
// the unpreconditioned variant.  instance 0 takes B12's body at one shard
// when the grid's tiles fit its slots (dist_geometry(n0, n1, n2, three_d,
// 1, SMs).fits), else the tile walk; 1 takes B12's body or refuses the
// grid (cudaErrorCooperativeLaunchTooLarge); 2 takes the tile walk (1 and
// 2 are for checks only).  B12's body needs region: a zeroed exchange
// region of cmpt_resident_dist_exchange_bytes(n1 * n2, 1) bytes, which
// the tile walk ignores.  Returns the launch's cudaError_t
// (cudaErrorCooperativeLaunchTooLarge and the like when the card refuses
// it).
int cmpt_cg_resident(const float* b, const float* x0, float* x, float* r,
                     float* p, float* ap, float* z2, float* d,
                     const float* params, const int* cap, float* partials,
                     float* rr_out, int* flags, float* hist, char* region,
                     int64_t n0, int64_t n1, int64_t n2, int three_d,
                     int nblocks, int check_every, int degree, int instance,
                     cudaStream_t stream) {
  const cmpt::Grid g{n0, n1, n2};
  if (instance < 0 || instance > 2) return (int)cudaErrorInvalidValue;
  if (instance != 2) {
    int sms = 0;
    const cudaError_t err = cmpt::sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    // p's two planes are p and ap, the first z buffer is d (Ap and d lie
    // in shared memory there)
    if (cmpt::dist_geometry(n0, n1, n2, three_d != 0, 1, sms).fits)
      return cmpt::launch_dist(b, x0, x, r, p, ap, z2, d, params, cap,
                               partials, nullptr, region, rr_out, flags,
                               hist, g, three_d != 0, 1, nblocks,
                               check_every, degree, stream);
    if (instance == 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  return cmpt::launch_resident<float>(
      b, x0, x, r, p, ap, z2, d, params, cap, partials, rr_out, flags, hist,
      g, three_d != 0, nblocks, check_every, degree, stream);
}

// B11: the same in float64: every plane, partial, params entry, rr_out
// and hist is a double; params = (scale, tol, rtol, theta, delta).
int cmpt_cg_resident_f64(const double* b, const double* x0, double* x,
                         double* r, double* p, double* ap, double* z2,
                         double* d, const double* params, const int* cap,
                         double* partials, double* rr_out, int* flags,
                         double* hist, int64_t n0, int64_t n1, int64_t n2,
                         int three_d, int nblocks, int check_every,
                         int degree, cudaStream_t stream) {
  return cmpt::launch_resident<double>(
      b, x0, x, r, p, ap, z2, d, params, cap, partials, rr_out, flags, hist,
      cmpt::Grid{n0, n1, n2}, three_d != 0, nblocks, check_every, degree,
      stream);
}

// B10's cg1 kernel: one cooperative launch of the whole Chronopoulos-Gear
// solve on `stream`.  x, r, p, s, w, s2, w2 are grid planes (written);
// partials holds 2 * cmpt_tile_blocks floats; params = (scale, tol, rtol);
// cap, rr_out, flags and hist as for cmpt_cg_resident.  x0 may be NULL.
// instance 0 takes the one-barrier body when the grid's tiles fit B12's
// slots (dist_geometry(n0, n1, n2, three_d, 1, SMs).fits), else the tile
// walk; 1 takes the one-barrier body or refuses the grid
// (cudaErrorCooperativeLaunchTooLarge); 2 takes the tile walk (1 and 2 are
// for checks only).  The one-barrier body keeps r, s and w in two planes
// each - (r, p), (s, s2), (w, w2) - and its barrier in region, a zeroed
// exchange region of cmpt_resident_dist_exchange_bytes(n1 * n2, 1) bytes;
// the tile walk ignores s2, w2 and region.
int cmpt_cg_resident_cg1(const float* b, const float* x0, float* x, float* r,
                         float* p, float* s, float* w, float* s2, float* w2,
                         const float* params, const int* cap,
                         float* partials, float* rr_out, int* flags,
                         float* hist, char* region, int64_t n0, int64_t n1,
                         int64_t n2, int three_d, int nblocks,
                         int check_every, int instance, cudaStream_t stream) {
  const cmpt::Grid g{n0, n1, n2};
  if (instance < 0 || instance > 2) return (int)cudaErrorInvalidValue;
  if (instance != 2) {
    int sms = 0;
    const cudaError_t err = cmpt::sm_count(&sms);
    if (err != cudaSuccess) return (int)err;
    if (cmpt::dist_geometry(n0, n1, n2, three_d != 0, 1, sms).fits)
      return cmpt::launch_cg1_shard(b, x0, x, r, p, s, s2, w, w2, params,
                                    cap, partials, region, rr_out, flags,
                                    hist, g, three_d != 0, nblocks,
                                    check_every, stream);
    if (instance == 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  return cmpt::launch_cg1(b, x0, x, r, p, s, w, params, cap, partials,
                          rr_out, flags, hist, g, three_d != 0, nblocks,
                          check_every, stream);
}

// Resident 256-thread blocks per SM of the 2D/3D, plain/preconditioned,
// f32/f64 variant on the current device (with cg1 != 0: the f32 cg1
// kernel, precond and f64 ignored), or minus a cudaError_t: an occupancy
// report for benchmarks, which the solver never calls.  An f32 variant
// reports B12's body at its slots (what 1024^2 and 128^3 launch; for cg1
// the one-barrier body), or with tile_walk != 0 the tile walk.
int cmpt_cg_resident_blocks_per_sm(int three_d, int precond, int f64,
                                   int cg1, int tile_walk) {
  int per_sm = 0;
  cudaError_t err;
  if (cg1 && !tile_walk) {
    err = cmpt::cg1_shard_per_sm(three_d != 0, &per_sm);
  } else if (!cg1 && !f64 && !tile_walk) {
    err = cmpt::dist_per_sm(three_d != 0, precond != 0, &per_sm);
  } else {
    const void* fn =
        cg1 ? cmpt::cg1_fn(three_d != 0)
            : f64 ? cmpt::resident_fn<double>(three_d != 0, precond != 0)
                  : cmpt::resident_fn<float>(three_d != 0, precond != 0);
    err = cmpt::per_sm_of(fn, three_d != 0, &per_sm);
  }
  return err == cudaSuccess ? per_sm : -(int)err;
}

}  // extern "C"
