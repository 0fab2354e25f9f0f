// B12: the per-shard resident CG solve (f32, Chebyshev degree 0..k) of a
// row-partitioned stencil, every shard of the mesh in ONE cooperative
// launch on one card.
//
// Replaces cuda_mpi_parallel_tpu/ops/pallas/resident_dist.py:
// cg_resident_dist_local (_resident_dist_kernel), which runs one kernel per
// TPU chip and moves halo rows and dot partials between chips by in-kernel
// remote DMA.  Semantics are _resident_dist_kernel's: x0 = 0, r0 = b,
// p0 = b (or z0 = P(A) b); per iteration a halo exchange of p, the stencil
// with -scale * halo added to the slab's edge planes (both neighbours on a
// one-plane slab, as -scale * (above + below)), the p.Ap allreduce, the x
// and r updates, the ||r||^2 allreduce, at degree > 0 the Chebyshev steps
// (each with its own halo exchange of z) and the rho = r.z allreduce, and
// the p update.  The check blocks, the threshold max(tol, rtol ||r0||)^2,
// safe_div, the indefinite flag, the ||r||^2 trace (slot 0 = rr0, one slot
// per block that ran, -1 elsewhere) and the converged/healthy outputs are
// B10's, so each shard runs B10's recurrence on its slab.
//
// Design for one card.  A shard is a group of CTAs: CTAs [s * nb, (s + 1)
// * nb) of the launch own shard s's slab planes (b, x, r, p, Ap and, with
// the preconditioner, z2 and d) and walk its tiles as B10's grid walks the
// whole grid.  P shards are P groups of one cooperative launch, so every
// CTA is resident and no spin-wait can deadlock.  The TPU design's 8-row
// halo blocks exist only for Mosaic's tiling; here a halo is one plane.
//  * A shard synchronises its own CTAs with its own barrier (shard_sync:
//    an arrival counter and a generation flag in its exchange region).
//    Nothing synchronises the whole grid: no grid.sync(), so no data
//    crosses shards through a grid-wide barrier.
//  * Data crosses shards only through the exchange regions.  Each shard
//    owns one region: two halo planes per parity (the plane above its slab
//    from the left neighbour, the plane below from the right), one dot row
//    of two floats per sender per parity, and their flags.  The kernel
//    takes a table of the P regions' addresses (here they point into one
//    allocation; a multi-card lane can pass peer-mapped addresses without a
//    kernel change).  A producer writes its edge plane (during the pass
//    that computes it) or its partials into the peer's slot with __stcg,
//    then, after its shard barrier and a __threadfence, stores the slot's
//    flag with st.release.gpu, tagged with the exchange's or the
//    allreduce's sequence number + 1.  The consumer's thread 0 polls with
//    ld.acquire.gpu until the tag arrives and the data is read with __ldcg.
//  * Slot reuse is safe by construction, by parity double-buffering with
//    tagged flags.  Exchange e and e + 2 share a slot.  A producer writes
//    e + 2 in a pass it starts only after its neighbour's e + 1 flag
//    arrived (every exchange is between neighbours, both ways), and the
//    neighbour published e + 1 after its shard barrier, which every one of
//    its CTAs passed after the pass that read e.  Likewise allreduce a and
//    a + 2 share a dot slot: a sender pushes a + 2 only after completing
//    a + 1, which needs the receiver's a + 1 row, which the receiver's
//    leader pushes after a shard barrier that each of its CTAs reaches
//    after reading a.  Two allreduces never follow each other without a
//    shard barrier between them: at degree 1, where rr and rho come from
//    the same pass, they travel as ONE allreduce of two values.  (The TPU
//    kernel instead relies on the allreduces to order single slots, and
//    needed a third dot buffer once a race was found at three shards.)
//  * Sums are fixed-order and bit-identical on every shard: each CTA sums
//    its shard's CTA partials in slot order (B10's grid_total), the
//    shard's leader pushes that total, and every CTA adds the P rows in
//    shard order 0..P-1.  Every CTA of every shard so holds the same bits
//    of alpha, beta and rr and takes the same branch.
//  * The first and last shards have no neighbour on their outer side: no
//    correction there (the global Dirichlet edge), no push, no wait.  At
//    one shard nothing is exchanged and the allreduce returns the shard's
//    own total, so x, the trace and the iterations are B10's bit for bit
//    when the grid has B10's CTA count (the same occupancy).
//  * A spin that waits more than 2 s traps: a broken protocol ends the
//    launch with an error instead of hanging the card.
//
// Bound on an H100: as B10's, the barriers and the passes over the
// L2-resident planes (B10's five planes, seven with the preconditioner,
// over the whole grid), plus per iteration two halo planes per shard per
// exchange and P dot rows per allreduce, which are small.  The exchange
// adds a flag round trip through L2 to each barrier-bound phase.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "resident.cuh"

namespace cmpt {

// The exchange region of one shard: offsets in bytes.
struct XchLayout {
  int64_t halo;   // float [2 parity][2 side][plane]; side 0 above, 1 below
  int64_t dots;   // float [2 parity][P sender][2]
  int64_t hflag;  // unsigned [2 parity][2 side]
  int64_t dflag;  // unsigned [2 parity][P sender]
  int64_t bar;    // unsigned long long arrivals; unsigned generation
  int64_t bytes;
};

__host__ __device__ inline XchLayout xch_layout(int64_t plane, int n_shards) {
  XchLayout l;
  int64_t off = 0;
  l.halo = off;
  off += 4 * plane * (int64_t)sizeof(float);
  l.dots = off;
  off += 4 * (int64_t)n_shards * (int64_t)sizeof(float);
  l.hflag = off;
  off += 4 * (int64_t)sizeof(unsigned);
  l.dflag = off;
  off += 2 * (int64_t)n_shards * (int64_t)sizeof(unsigned);
  off = (off + 15) / 16 * 16;
  l.bar = off;
  off += 16;
  l.bytes = (off + 255) / 256 * 256;
  return l;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until the (monotone) flag reaches want; trap after 2 s.
__device__ __forceinline__ void wait_flag(const unsigned* f, unsigned want) {
  if (ld_acquire(f) >= want) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(f) < want)
    if (global_ns() - t0 > 2000000000ULL) __trap();
}

struct DistArgs {
  const float* b;        // P stacked slabs of cells floats each
  float* x;
  float* r;
  float* p;
  float* ap;             // with PRECOND also the first z buffer
  float* z2;             // the second z buffer (degree >= 3)
  float* d;              // Chebyshev d (degree >= 2)
  const float* params;   // scale, tol, rtol, lmin, lmax
  const int* cap;
  float* partials;       // [P][3][tiles]: pap, rr, rz slots
  char* const* peers;    // the P exchange regions
  float* rr_out;         // [P]
  int* flags;            // [P][4]: iterations, indefinite, converged, healthy
  float* hist;           // [P][nblocks + 1]
  Grid g;                // one shard's slab (nx / P, n1, n2)
  int64_t tiles;         // tiles of the slab walk
  int nb;                // CTAs per shard
  int n_shards;
  int nblocks;
  int check_every;
  int degree;
};

// One shard's view of the protocol.
struct Shard {
  int s, P, lb, nb;
  int64_t plane, n0;
  XchLayout l;
  char* mine;
  char* left;    // the shard above (s - 1), or null
  char* right;   // the shard below (s + 1), or null
  bool lead;     // CTA 0's thread 0: publishes for the shard
  bool t0;       // thread 0 of this CTA
  unsigned long long* arrivals;
  unsigned* generation;
  char* const* table;   // the P exchange regions

  __device__ float* halo(char* region, int parity, int side) const {
    return (float*)(region + l.halo) + ((int64_t)parity * 2 + side) * plane;
  }
  __device__ unsigned* hflag(char* region, int parity, int side) const {
    return (unsigned*)(region + l.hflag) + parity * 2 + side;
  }
  __device__ float* dots(char* region, int parity, int sender) const {
    return (float*)(region + l.dots) + ((int64_t)parity * P + sender) * 2;
  }
  __device__ unsigned* dflag(char* region, int parity, int sender) const {
    return (unsigned*)(region + l.dflag) + parity * P + sender;
  }

  // Barrier of this shard's CTAs (writes before it are seen after it).
  __device__ void sync(unsigned& epoch) const {
    __syncthreads();
    ++epoch;
    if (t0) {
      __threadfence();
      const unsigned long long n = atomicAdd(arrivals, 1ULL) + 1ULL;
      if (n == (unsigned long long)nb * epoch)
        st_release(generation, epoch);
      else
        wait_flag(generation, epoch);
      __threadfence();
    }
    __syncthreads();
  }

  // A point of exchange e at plane i: the edge planes go to the
  // neighbours' halo slots (my first plane is the left one's "below", my
  // last plane the right one's "above").
  __device__ void push(int e, int64_t i, int64_t c, float v) const {
    if (i == 0 && left) __stcg(halo(left, e & 1, 1) + c, v);
    if (i == n0 - 1 && right) __stcg(halo(right, e & 1, 0) + c, v);
  }

  // After the pass that pushed exchange e and a shard barrier.
  __device__ void publish(int e) const {
    if (!lead) return;
    __threadfence();
    if (left) st_release(hflag(left, e & 1, 1), (unsigned)e + 1);
    if (right) st_release(hflag(right, e & 1, 0), (unsigned)e + 1);
  }

  // Before a pass that reads exchange e.
  __device__ void await(int e) const {
    if (t0) {
      if (left) wait_flag(hflag(mine, e & 1, 0), (unsigned)e + 1);
      if (right) wait_flag(hflag(mine, e & 1, 1), (unsigned)e + 1);
    }
    __syncthreads();
  }

  // scale * lap at (i, c) plus the halo corrections of exchange e.
  __device__ float stencil(int e, int64_t i, int64_t c, float scale,
                           float lap) const {
    float v = mul_rn(scale, lap);
    const bool up = i == 0 && left, down = i == n0 - 1 && right;
    if (!up && !down) return v;
    const float above = up ? __ldcg(halo(mine, e & 1, 0) + c) : 0.f;
    const float below = down ? __ldcg(halo(mine, e & 1, 1) + c) : 0.f;
    if (n0 == 1) return add_rn(v, mul_rn(-scale, add_rn(above, below)));
    return add_rn(v, mul_rn(-scale, up ? above : below));
  }

  // ONE allreduce a of nv (1 or 2) shard totals; every CTA returns the
  // same sums (rows added in shard order).
  __device__ void allreduce(int a, float v0, float v1, int nv, float& s0,
                            float& s1) const {
    __shared__ float sums[2];
    const int parity = a & 1;
    const unsigned tag = (unsigned)a + 1;
    if (lead) {
      for (int q = 0; q < P; ++q) {
        float* dst = dots(peer(q), parity, s);
        __stcg(dst, v0);
        if (nv > 1) __stcg(dst + 1, v1);
      }
      __threadfence();
      for (int q = 0; q < P; ++q) st_release(dflag(peer(q), parity, s), tag);
    }
    if (t0) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < P; ++j) {
        wait_flag(dflag(mine, parity, j), tag);
        const float* src = dots(mine, parity, j);
        const float w0 = __ldcg(src), w1 = nv > 1 ? __ldcg(src + 1) : 0.f;
        a0 = j == 0 ? w0 : add_rn(a0, w0);
        a1 = j == 0 ? w1 : add_rn(a1, w1);
      }
      sums[0] = a0;
      sums[1] = a1;
    }
    __syncthreads();
    s0 = sums[0];
    s1 = sums[1];
    __syncthreads();
  }

  __device__ char* peer(int q) const { return table[q]; }
};

template <bool THREE_D, bool PRECOND>
__global__ void __launch_bounds__(256, THREE_D ? 2 : 4)
    resident_dist_kernel(DistArgs a) {
  Shard sh;
  sh.s = blockIdx.x / a.nb;
  sh.P = a.n_shards;
  sh.nb = a.nb;
  sh.lb = blockIdx.x - sh.s * a.nb;
  sh.plane = a.g.n1 * a.g.n2;
  sh.n0 = a.g.n0;
  sh.l = xch_layout(sh.plane, a.n_shards);
  sh.table = a.peers;
  sh.mine = a.peers[sh.s];
  sh.left = sh.s > 0 ? a.peers[sh.s - 1] : nullptr;
  sh.right = sh.s + 1 < a.n_shards ? a.peers[sh.s + 1] : nullptr;
  sh.t0 = threadIdx.x == 0 && threadIdx.y == 0;
  sh.lead = sh.lb == 0 && sh.t0;
  sh.arrivals = (unsigned long long*)(sh.mine + sh.l.bar);
  sh.generation = (unsigned*)(sh.mine + sh.l.bar + 8);

  const Grid g = a.g;
  const int64_t off = (int64_t)sh.s * g.n0 * g.n1 * g.n2;
  const float* b = a.b + off;
  float* x = a.x + off;
  float* r = a.r + off;
  float* p = a.p + off;
  float* ap = a.ap + off;
  float* z2 = PRECOND && a.z2 ? a.z2 + off : nullptr;
  float* d = PRECOND && a.d ? a.d + off : nullptr;
  float* part_pap = a.partials + (int64_t)sh.s * 3 * a.tiles;
  float* part_rr = part_pap + a.tiles;
  float* part_rz = part_rr + a.tiles;
  float* hist = a.hist + (int64_t)sh.s * (a.nblocks + 1);
  const float scale = a.params[0], tol = a.params[1], rtol = a.params[2];
  const int cap = *a.cap;
  const int nb = a.nb;
  const int64_t first = sh.lb;
  Cheb<float> cb{1.f, 1.f, 1.f};
  bool by_theta = false;
  if constexpr (PRECOND) {
    cb = cheb_of(a.params[3], a.params[4]);
    by_theta = a.degree == 1;
  }
  const float theta = cb.theta;
  const auto zero = [](int64_t) { return 0.f; };  // no plane past a slab
  unsigned epoch = 0;
  int ex = 0;    // the next halo exchange to push
  int ar = 0;    // the next allreduce
  float unused;

  // z = P(A) r for degree >= 2 (B10's cheb_apply with the halo exchanges):
  // step j reads exchange ex - 1 (r / theta at step 0, z_j after) and,
  // but for the last step, pushes its z as the next exchange.  Returns the
  // plane of z; the last step writes the r.z partials.
  auto cheb_apply = [&]() -> float* {
    float rho_c = div_rn(1.f, cb.sigma);
    const float* zin = r;
    float* zout = ap;
    for (int j = 0; j < a.degree - 1; ++j) {
      const float rho_n = div_rn(1.f, sub_rn(mul_rn(2.f, cb.sigma), rho_c));
      const float c1 = mul_rn(rho_n, rho_c);
      const float c2 = div_rn(mul_rn(2.f, rho_n), cb.delta);
      const bool last = j == a.degree - 2;
      zout = (j % 2 == 0) ? ap : z2;
      float* out = zout;
      const int e_in = ex - 1;
      sh.await(e_in);
      float acc = 0.f;
      for (int64_t tile = first; tile < a.tiles; tile += nb) {
        auto visit = [&](int64_t o, int64_t i, int64_t c, float z,
                         float lap) {
          const float rv = __ldcg(r + o);
          const float dv = j == 0 ? z : d[o];
          const float dn =
              add_rn(mul_rn(c1, dv),
                     mul_rn(c2, sub_rn(rv, sh.stencil(e_in, i, c, scale, lap))));
          const float zn = add_rn(z, dn);
          __stcg(out + o, zn);
          d[o] = dn;
          if (last) acc = add_rn(acc, mul_rn(rv, zn));
          else sh.push(ex, i, c, zn);
        };
        if (j == 0)
          walk_column_ix<float, THREE_D>(
              g, tile,
              [&](int64_t o) { return div_rn(__ldcg(r + o), theta); }, zero,
              zero, visit);
        else
          walk_column_ix<float, THREE_D>(
              g, tile, [&](int64_t o) { return __ldcg(zin + o); }, zero,
              zero, visit);
      }
      if (last) put_partial_at(part_rz, sh.lb, acc);
      sh.sync(epoch);
      if (!last) sh.publish(ex++);
      zin = zout;
      rho_c = rho_n;
    }
    return zout;
  };

  // init: x = 0, r = b, the r.r partials; p = b unpreconditioned, b / theta
  // at degree 1 (with the r.z partials), and at degree >= 2 the exchange of
  // b / theta for the first Chebyshev step
  float acc = 0.f, acc_rz = 0.f;
  for (int64_t tile = first; tile < a.tiles; tile += nb)
    points_ix(g, tile, [&](int64_t o, int64_t i, int64_t c) {
      const float r0 = b[o];
      x[o] = 0.f;
      if constexpr (PRECOND) {
        __stcg(r + o, r0);
        if (by_theta) {
          const float z0 = div_rn(r0, theta);
          __stcg(p + o, z0);
          acc_rz = add_rn(acc_rz, mul_rn(r0, z0));
          sh.push(ex, i, c, z0);
        } else {
          sh.push(ex, i, c, div_rn(r0, theta));
        }
      } else {
        r[o] = r0;
        __stcg(p + o, r0);
        sh.push(ex, i, c, r0);
      }
      acc = add_rn(acc, mul_rn(r0, r0));
    });
  put_partial_at(part_rr, sh.lb, acc);
  if (by_theta) put_partial_at(part_rz, sh.lb, acc_rz);
  {
    const int64_t stride = (int64_t)nb * blockDim.x * blockDim.y;
    for (int64_t j = (int64_t)sh.lb * blockDim.x * blockDim.y +
                     threadIdx.y * blockDim.x + threadIdx.x;
         j <= a.nblocks; j += stride)
      hist[j] = -1.f;  // sentinel: the block never ran
  }
  sh.sync(epoch);
  sh.publish(ex++);
  float rr, rho;
  if (by_theta) {
    sh.allreduce(ar++, grid_total(part_rr, nb), grid_total(part_rz, nb), 2,
                 rr, rho);
  } else {
    sh.allreduce(ar++, grid_total(part_rr, nb), 0.f, 1, rr, unused);
    rho = rr;
  }
  if constexpr (PRECOND) {
    if (!by_theta) {
      // p0 = z0 = P(A) r0, then the exchange of p
      const float* z = cheb_apply();
      sh.allreduce(ar++, grid_total(part_rz, nb), 0.f, 1, rho, unused);
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        points_ix(g, tile, [&](int64_t o, int64_t i, int64_t c) {
          const float zv = __ldcg(z + o);
          __stcg(p + o, zv);
          sh.push(ex, i, c, zv);
        });
      sh.sync(epoch);
      sh.publish(ex++);
    }
  }
  const float thresh2 = threshold2(tol, rtol, rr);
  if (sh.lead) hist[0] = rr;
  int k = 0, indefinite = 0;

  for (int blk = 0; blk < a.nblocks; ++blk) {
    const bool healthy = isfinite(rr) && isfinite(rho) && rho > 0.f;
    if (!(rr >= thresh2 && rr > 0.f && k < cap && healthy)) break;
    const int nsteps = min(a.check_every, cap - k);
    for (int step = 0; step < nsteps; ++step) {
      // phase 1: Ap = A p with the halo of p, partials of p.Ap
      const int e_p = ex - 1;
      sh.await(e_p);
      acc = 0.f;
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        walk_column_ix<float, THREE_D>(
            g, tile, [&](int64_t o) { return __ldcg(p + o); }, zero, zero,
            [&](int64_t o, int64_t i, int64_t c, float u, float lap) {
              const float v = sh.stencil(e_p, i, c, scale, lap);
              if constexpr (PRECOND) __stcg(ap + o, v);
              else ap[o] = v;
              acc = add_rn(acc, mul_rn(u, v));
            });
      put_partial_at(part_pap, sh.lb, acc);
      sh.sync(epoch);
      float pap;
      sh.allreduce(ar++, grid_total(part_pap, nb), 0.f, 1, pap, unused);
      if (pap <= 0.f && rr > 0.f) indefinite = 1;
      const float alpha = safe_div(rho, pap);

      // phase 2: x += alpha p, r -= alpha Ap, partials of r.r (and of
      // r . r / theta at degree 1); at degree >= 2 r / theta's edge planes
      // are the first Chebyshev step's exchange
      acc = 0.f;
      acc_rz = 0.f;
      const bool cheb_steps = PRECOND && !by_theta;
      for (int64_t tile = first; tile < a.tiles; tile += nb)
        points_ix(g, tile, [&](int64_t o, int64_t i, int64_t c) {
          x[o] = add_rn(x[o], mul_rn(alpha, __ldcg(p + o)));
          if constexpr (PRECOND) {
            const float rn = sub_rn(__ldcg(r + o), mul_rn(alpha, __ldcg(ap + o)));
            __stcg(r + o, rn);
            acc = add_rn(acc, mul_rn(rn, rn));
            if (by_theta) acc_rz = add_rn(acc_rz, mul_rn(rn, div_rn(rn, theta)));
            if (cheb_steps) sh.push(ex, i, c, div_rn(rn, theta));
          } else {
            const float rn = sub_rn(r[o], mul_rn(alpha, ap[o]));
            r[o] = rn;
            acc = add_rn(acc, mul_rn(rn, rn));
          }
        });
      put_partial_at(part_rr, sh.lb, acc);
      if (by_theta) put_partial_at(part_rz, sh.lb, acc_rz);
      sh.sync(epoch);
      if (cheb_steps) sh.publish(ex++);
      float rr_new, rho_new;
      if (by_theta) {
        sh.allreduce(ar++, grid_total(part_rr, nb), grid_total(part_rz, nb),
                     2, rr_new, rho_new);
      } else {
        sh.allreduce(ar++, grid_total(part_rr, nb), 0.f, 1, rr_new, unused);
        rho_new = rr_new;
      }

      // phase 3: p = z + beta p, its edge planes the next exchange
      if constexpr (PRECOND) {
        const float* z = by_theta ? nullptr : cheb_apply();
        if (!by_theta)
          sh.allreduce(ar++, grid_total(part_rz, nb), 0.f, 1, rho_new, unused);
        const float beta = safe_div(rho_new, rho);
        for (int64_t tile = first; tile < a.tiles; tile += nb)
          points_ix(g, tile, [&](int64_t o, int64_t i, int64_t c) {
            const float zo = by_theta ? div_rn(__ldcg(r + o), theta)
                                      : __ldcg(z + o);
            const float pn = add_rn(zo, mul_rn(beta, __ldcg(p + o)));
            __stcg(p + o, pn);
            sh.push(ex, i, c, pn);
          });
      } else {
        const float beta = safe_div(rr_new, rho);
        for (int64_t tile = first; tile < a.tiles; tile += nb)
          points_ix(g, tile, [&](int64_t o, int64_t i, int64_t c) {
            const float pn = add_rn(r[o], mul_rn(beta, __ldcg(p + o)));
            __stcg(p + o, pn);
            sh.push(ex, i, c, pn);
          });
      }
      sh.sync(epoch);
      sh.publish(ex++);
      rr = rr_new;
      rho = rho_new;
    }
    k += nsteps;
    if (sh.lead) hist[blk + 1] = rr;
  }

  if (sh.lead) {
    a.rr_out[sh.s] = rr;
    int* f = a.flags + 4 * sh.s;
    f[0] = k;
    f[1] = indefinite;
    f[2] = (rr < thresh2 || rr == 0.f) ? 1 : 0;
    f[3] = (isfinite(rr) && isfinite(rho) && (rho > 0.f || rr == 0.f)) ? 1 : 0;
  }
}

static const void* dist_fn(bool three_d, bool precond) {
  if (three_d)
    return precond ? (const void*)resident_dist_kernel<true, true>
                   : (const void*)resident_dist_kernel<true, false>;
  return precond ? (const void*)resident_dist_kernel<false, true>
                 : (const void*)resident_dist_kernel<false, false>;
}

static cudaError_t dist_per_sm(bool three_d, bool precond, int* per_sm) {
  const dim3 block = tile_block(three_d);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, dist_fn(three_d, precond), (int)(block.x * block.y), 0);
}

static int launch_dist(const float* b, float* x, float* r, float* p,
                       float* ap, float* z2, float* d, const float* params,
                       const int* cap, float* partials, char* const* peers,
                       float* rr_out, int* flags, float* hist, Grid g,
                       bool three_d, int n_shards, int nblocks,
                       int check_every, int degree, cudaStream_t stream) {
  const int64_t tiles = tile_blocks(g, three_d);
  if (tiles <= 0 || n_shards < 1 || nblocks < 0 || check_every < 1 ||
      degree < 0 || (degree >= 2 && d == nullptr) ||
      (degree >= 3 && z2 == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = dist_per_sm(three_d, degree > 0, &per_sm);
  if (err != cudaSuccess) return (int)err;
  // the occupancy's CTAs, divided evenly over the shards (at most one
  // per tile of a slab)
  int64_t nb = (int64_t)per_sm * sms / n_shards;
  if (nb > tiles) nb = tiles;
  if (nb < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  DistArgs args{b, x, r, p, ap, z2, d, params, cap, partials, peers, rr_out,
                flags, hist, g, tiles, (int)nb, n_shards, nblocks,
                check_every, degree};
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel(dist_fn(three_d, degree > 0),
                                    dim3((unsigned)(nb * n_shards)),
                                    tile_block(three_d), kargs, 0, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace cmpt

extern "C" {

// Bytes of one shard's exchange region for slabs of plane floats per
// plane and n_shards shards (the regions must be zeroed before a launch).
int64_t cmpt_resident_dist_exchange_bytes(int64_t plane, int n_shards) {
  return cmpt::xch_layout(plane, n_shards).bytes;
}

// One cooperative launch of the whole distributed solve on `stream`: P =
// n_shards slabs of (n0, n1, n2) stacked in b, x, r, p, ap (and z2 for
// degree >= 3, d for degree >= 2; else NULL); params = (scale, tol, rtol,
// lmin, lmax); partials holds 3 * P * cmpt_tile_blocks floats; peers is a
// device array of P pointers to zeroed exchange regions of
// cmpt_resident_dist_exchange_bytes each; rr_out (P floats), flags (4 P
// ints: iterations, indefinite, converged, healthy) and hist (P * (nblocks
// + 1) floats) are written per shard.  2D slabs pass (nx, 1, ny) and
// three_d = 0.  Returns the launch's cudaError_t.
int cmpt_cg_resident_dist(const float* b, float* x, float* r, float* p,
                          float* ap, float* z2, float* d, const float* params,
                          const int* cap, float* partials, char* const* peers,
                          float* rr_out, int* flags, float* hist, int64_t n0,
                          int64_t n1, int64_t n2, int three_d, int n_shards,
                          int nblocks, int check_every, int degree,
                          cudaStream_t stream) {
  return cmpt::launch_dist(b, x, r, p, ap, z2, d, params, cap, partials,
                           peers, rr_out, flags, hist, cmpt::Grid{n0, n1, n2},
                           three_d != 0, n_shards, nblocks, check_every,
                           degree, stream);
}

// Resident CTAs per SM of the 2D/3D, plain/preconditioned B12 instance on
// the current device, or minus a cudaError_t.
int cmpt_cg_resident_dist_blocks_per_sm(int three_d, int precond) {
  int per_sm = 0;
  const cudaError_t err = cmpt::dist_per_sm(three_d != 0, precond != 0,
                                            &per_sm);
  return err == cudaSuccess ? per_sm : -(int)err;
}

}  // extern "C"
