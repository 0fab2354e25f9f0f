// B12: the per-shard resident CG solve (f32, Chebyshev degree 0..k) of a
// row-partitioned stencil, every shard of the mesh in ONE cooperative
// launch on one card.
//
// Replaces cuda_mpi_parallel_tpu/ops/pallas/resident_dist.py:
// cg_resident_dist_local (_resident_dist_kernel), which runs one kernel per
// TPU chip and moves halo rows and dot partials between chips by in-kernel
// remote DMA.  Semantics are _resident_dist_kernel's: x0 = 0, r0 = b,
// p0 = b (or z0 = P(A) b); per iteration the stencil of p with -scale *
// halo added to the slab's edge planes (both neighbours on a one-plane
// slab, as -scale * (above + below)), the p.Ap allreduce, the x and r
// updates, the ||r||^2 allreduce, at degree > 0 the Chebyshev steps (each
// with the halo of its input) and the rho = r.z allreduce, and p = z +
// beta p.  The check blocks, the threshold max(tol, rtol ||r0||)^2,
// safe_div, the indefinite flag, the ||r||^2 trace (slot 0 = rr0, one slot
// per block that ran, -1 elsewhere) and the converged/healthy outputs are
// B10's, so each shard runs B10's recurrence on its slab.
//
// B10 (resident.cu's cmpt_cg_resident) runs its f32 solves on this body
// at one shard wherever the slab's tiles fit the shared slots: with a
// warm start too (x0, one shard only: r0 = b - A x0 in the init pass, as
// B10's), and with its own region in place of the table of regions.
// B10's cg1 form (cmpt_cg_resident_cg1) runs on the same machinery at one
// shard, for the same grids, as a body of its own: resident_cg1_shard_kernel
// below, one pass and one barrier an iteration.
//
// What bounds it on an H100.  The operations, about 16 flops a point an
// iteration, take 0.25 us an iteration at 1024^2; the planes stay in the
// 50 MB L2 and DRAM sees b and x about once a solve.  An iteration costs
// latency instead: the shard barriers (a fence, an atomic on one arrival
// counter, a flag, each a round trip through L2), and the passes over the
// L2-resident planes (4 MB a plane at 1024^2), whose loads a thread waits
// for in turn.  The first design spent three passes and three barriers an
// iteration at degree 0, each barrier followed by a second flag round trip
// for its allreduce and each flag store fenced on its own; a thread waited
// for L2 once a plane.  This one spends two passes and two barriers (at
// degree k >= 2, 2 + (k - 1) barriers), one fence a barrier each way, and
// one L2 wait per chunk of planes:
//  * p is formed where it is read.  Every point of p_new is add_rn(z,
//    mul_rn(beta, p_old)), z = r at degree 0, r / theta at degree 1, the
//    last Chebyshev step's z at degree >= 2.  The Ap pass forms it at its
//    own points and at every stencil neighbour it reads, from z and p_old
//    in L2, so every copy of a point has the same bits, and the owner
//    writes it into the other of two p planes: p of iteration it lies in
//    plane it & 1, so no CTA overwrites a p_old that a neighbour still
//    reads.  The p pass and its barrier are gone (p0 = z0 is formed so too).
//  * Ap stays on chip: only its own thread reads it back (the x/r pass),
//    so it lies in shared memory, one slot per point of the CTA's tiles,
//    and its plane is p's second buffer.  The Chebyshev d, also read only
//    by its own thread, takes the same slots during the steps, and x,
//    read and written only by its own thread, a second set of slots: it
//    reaches its plane once, at the end.  B10's planes remain: five (b,
//    x, r, p's two), seven with the preconditioner (its two z buffers);
//    an iteration touches r, p's two and the z buffers.  The slots cap
//    the tiles a CTA walks (resident_dist.cuh's dist_max_tiles: 3 in 2D,
//    7 in 3D), and so the slabs one launch takes; the wrapper's gate reads
//    the same geometry.
//  * the halo exchange carries z's edge plane, which p_new is formed from.
//    Each shard keeps in its region the p edge planes of its neighbours,
//    formed there each iteration from the received z edge and its own
//    previous copy (at iteration 0, p = z) with the neighbour's
//    operations, so the copies hold the neighbour's bits.
//  * each allreduce rides the barrier before it.  The CTA whose arrival
//    completes a shard barrier (its atomicAdd acq_rel) sums the shard's CTA
//    partials in slot order (grid_total) and, after one fence, stores that
//    total into its row of every shard's dots - a 64-bit word holding the
//    value and the allreduce's tag, so a waiter's poll returns the value
//    too - the halo flags of the exchange the barrier publishes, and the
//    generation, all as relaxed stores.  The other CTAs poll the P rows
//    (the generation at a barrier without an allreduce) with relaxed loads
//    and fence once.  At one shard barrier and allreduce are one hop; the
//    halo publish rides the barrier of the x/r pass (of the last Chebyshev
//    step), so its flag is up by the time the allreduce completes.  Thread
//    0 derives alpha, beta, rr and rho there and leaves them in shared
//    memory.
//  * only the CTAs whose tiles hold the slab's first or last plane wait for
//    a halo flag.
//  * the tile walk (walk_slab) visits B10's points in B10's order with
//    32-bit offsets; a thread loads a chunk of its column's planes (their
//    row neighbours in 3D, the columns beside a warp's end lanes) before
//    it computes any, so their loads are in flight together, and takes
//    the neighbours along n2 from the neighbouring lanes of its warp.  The
//    chunk is as large as the registers hold without spilling; the
//    shard's pointers, the slab's dimensions and the scalars lie in shared
//    memory.  The 2D instances keep B10's four CTAs per SM (64 registers),
//    the 3D ones two, at the slots of the most tiles a CTA walks; every
//    launch takes exactly these (or refuses), so at one shard the grid is
//    B10's.
//
// Protocol.
//  * A shard is a group of CTAs: CTAs [s * nb, (s + 1) * nb) of the launch
//    own shard s's slab and walk its tiles as B10's grid walks the whole
//    grid.  P shards are P groups of one cooperative launch, so every CTA
//    is resident and no spin-wait can deadlock.  A shard synchronises its
//    own CTAs (shard_barrier: an arrival counter and a generation flag in
//    its region); nothing synchronises the whole grid (no grid.sync()).
//    The TPU design's 8-row halo blocks exist only for Mosaic's tiling;
//    here a halo is one plane.
//  * Data crosses shards only through the exchange regions
//    (resident_dist.cuh).  The kernel takes a table of the P regions'
//    addresses (here they point into one allocation; a multi-card lane
//    can pass peer-mapped addresses without a kernel change).  A producer
//    writes its edge plane into the neighbour's slot of parity e & 1 with
//    __stcg during the pass that computes it (exchange e), the last
//    arriver of the barrier ending that pass stores the slot's flag,
//    tagged e + 1, after its fence, and the consumer's thread 0 polls it
//    and fences before the pass that reads it with __ldcg.
//  * Slot reuse, by parity double-buffering with tagged flags.  Exchanges
//    are numbered in the order every shard pushes them.  (i) A CTA pushes
//    exchange e + 1 only after it awaited exchange e on the same side: at
//    degree 0 the x/r pass of iteration it pushes it + 1 after the Ap pass
//    read it; at degree >= 2 the x/r pass pushes r / theta after the Ap
//    pass read z, and Chebyshev step j pushes z_j after reading the
//    exchange before it.  A CTA pushes to a side exactly when its tiles
//    hold that edge plane, and then it is also the one that awaits that
//    side (a one-plane slab pushes to and awaits both).  (ii) A shard
//    publishes e + 1 at a barrier that each of its CTAs reaches after its
//    last read of e.  Exchange e + 2 takes e's slot: its producer pushes
//    only after awaiting e + 1 from that neighbour (i), published after
//    every CTA there had read e (ii).  Allreduce a and a + 2 share a dot
//    slot: the last arriver of shard S pushes S's row for a + 2 when every
//    CTA of S has arrived, so each has finished allreduce a + 1, which
//    needed the receiver's row for a + 1, pushed only when all the
//    receiver's CTAs had arrived after reading a.  Every allreduce rides its
//    own barrier, so two never follow each other without one (at degree 1,
//    where rr and rho come from the same pass, they travel as ONE allreduce
//    of two values).  (The TPU kernel relies on the allreduces to order
//    single slots, and needed a third dot buffer once a race was found at
//    three shards.)  A reduction's partial slots are written before a
//    barrier and read by its last arriver only; the next write follows the
//    next barrier, which that CTA reaches after its read.
//  * Sums are fixed-order and bit-identical on every shard: the last
//    arriver sums its shard's CTA partials in slot order (B10's
//    grid_total), and every CTA adds the P rows in shard order 0..P-1.
//    Every CTA of every shard so holds the same bits of alpha, beta and rr
//    and takes the same branch.
//  * The first and last shards have no neighbour on their outer side: no
//    correction there (the global Dirichlet edge), no push, no wait.  At
//    one shard nothing is exchanged and the allreduce returns the shard's
//    own total, so x, the trace and the iterations are B10's bit for bit
//    when the grid has B10's CTA count (the same occupancy).
//  * A spin that waits more than 2 s traps: a broken protocol ends the
//    launch with an error instead of hanging the card.
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "resident.cuh"
#include "resident_dist.cuh"

namespace cmpt {

// The flags are strong relaxed stores and loads; a fence.acq_rel before a
// thread's stores makes them release what it wrote and acquired before
// them, and one after its polls makes them acquire (one fence each way,
// where st.release and ld.acquire would fence at every store and poll).
__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long atom_add_acq_rel(
    unsigned long long* p, unsigned long long v) {
  unsigned long long old;
  asm volatile("atom.acq_rel.gpu.global.add.u64 %0, [%1], %2;"
               : "=l"(old)
               : "l"(p), "l"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until the (monotone) flag reaches want; trap after 2 s.  The
// caller fences after its last poll.
__device__ __forceinline__ void wait_flag(const unsigned* f, unsigned want) {
  if (ld_relaxed(f) >= want) return;
  const unsigned long long t0 = global_ns();
  while (ld_relaxed(f) < want)
    if (global_ns() - t0 > 2000000000ULL) __trap();
}

// A dot row's word: the value's bits, tagged with its allreduce's number
// + 1, so one store and one load carry both.
__device__ __forceinline__ unsigned long long dot_word(unsigned tag,
                                                       float v) {
  return (unsigned long long)tag << 32 | __float_as_uint(v);
}

// Spin until the word carries tag; its value.  Trap after 2 s.
__device__ __forceinline__ float wait_word(const unsigned long long* w,
                                           unsigned tag) {
  unsigned long long v = ld_relaxed(w);
  if ((unsigned)(v >> 32) != tag) {
    const unsigned long long t0 = global_ns();
    while ((unsigned)((v = ld_relaxed(w)) >> 32) != tag)
      if (global_ns() - t0 > 2000000000ULL) __trap();
  }
  return __uint_as_float((unsigned)v);
}

constexpr int kThreads = 256;  // a CTA: common.cuh's tile_block, 2D and 3D
static_assert(kThreads == kDistThreads && kPlanes == kDistPlanes,
              "resident_dist.cuh's geometry walks common.cuh's tiles");

struct DistArgs {
  const float* b;        // P stacked slabs of cells floats each
  const float* x0;       // a warm start (one shard only), or nullptr: x0 = 0
  float* x;
  float* r;
  float* p0;             // p at even iterations
  float* p1;             // p at odd iterations
  float* z2;             // the second z buffer (degree >= 3)
  float* z1;             // the first z buffer (degree >= 2)
  const float* params;   // scale, tol, rtol, lmin, lmax
  const int* cap;
  float* partials;       // [P][3][tiles]: pap, rr, rz slots
  char* const* peers;    // the P exchange regions, or nullptr at one shard:
  char* region;          // then its region
  float* rr_out;         // [P]
  int* flags;            // [P][4]: iterations, indefinite, converged, healthy
  float* hist;           // [P][nblocks + 1]
  int n0, n1, n2;        // one shard's slab (nx / P, n1, n2)
  int tiles;             // tiles of the slab walk
  int nb;                // CTAs per shard
  int n_shards;
  int nblocks;
  int check_every;
  int degree;
};

// A CTA's view of its shard, in shared memory (thread 0 sets it once), so
// the pointers do not hold registers across the solve.
struct Shard {
  XchLayout l;
  char* mine;
  char* left;    // the shard above (s - 1), or null
  char* right;   // the shard below (s + 1), or null
  char* const* table;
  const float* b;
  float* x;
  float* r;
  float* p[2];
  float* z1;
  float* z2;
  float* part[3];  // this shard's pap, rr, rz slots
  float* hist;
  float scale;
  float theta;
  float thresh2;
  // the recurrence's scalars, set by thread 0 at the barriers that reduce
  // them and read by every thread after: they hold no registers between
  float rr, rho, alpha, beta;
  int cap;
  int n0, n1, n2;  // the slab
  int tiles;       // of the slab walk
  int s;
  int lb;        // this CTA's place in the shard
  int nb;
  unsigned epoch;  // barriers so far (thread 0's)
  int ar;          // allreduces so far (thread 0's)
  int indefinite;  // thread 0's
  int up;        // this CTA's tiles hold the slab's first plane, and s > 0
  int down;      // ... its last plane, and s + 1 < P
  int last;      // this CTA completed the barrier (broadcast)
};

__device__ __forceinline__ bool lead_thread() {
  return threadIdx.x == 0 && threadIdx.y == 0;
}

template <typename T>
__device__ __forceinline__ T* at(char* region, int64_t offset) {
  return (T*)(region + offset);
}

// Planes of a tile column whose loads a thread puts in flight together,
// in the stencil walks and in the point passes: as many as the registers
// hold without spilling (ptxas, -Xptxas -v).  3D (128 registers at two
// CTAs per SM): all eight, four with the preconditioner.  2D (64 at
// four): four planes of the walk and two of the point passes, and with
// the preconditioner one plane of the walk.
template <bool THREE_D, bool PRECOND>
__host__ __device__ constexpr int walk_chunk() {
  return THREE_D ? (PRECOND ? 4 : 8) : (PRECOND ? 1 : 4);
}
template <bool THREE_D, bool PRECOND>
__host__ __device__ constexpr int points_chunk() {
  return THREE_D ? (PRECOND ? 4 : 8) : 2;
}

// What the stencil reads of a column entry of walk_tile: the entry itself
// (B12), or the cg1 body's r of the next iteration (Cg1Col below).
__device__ __forceinline__ float lap_value(float v) { return v; }

// B12's tile walk: common.cuh's walk_column_ix (the same tiles, points and
// order, so a CTA's partials are B10's) with 32-bit offsets (a slab holds
// fewer than 2^31 points).  For each chunk of C planes a thread first loads
// everything the chunk reads - column() at the column's next planes,
// load() at its row neighbours (3D) and at the column beside a warp's two
// end lanes, and own() at its points - so the loads are in flight together
// and the chunk waits for L2 once, not once a plane; the previous and
// current planes carry over from chunk to chunk, and the neighbours along
// n2 come from the neighbouring lanes of the warp (a warp is 32
// consecutive columns of one row).  Planes past the slab read as zero.
// visit(o, i, c, q, w, u, lap): offset o, plane i, in-plane offset c, q =
// i % kPlanes (the point's shared slot), w = own(o), u = column(o), lap the
// Laplacian term of lap_value(column) along n0 and load() beside it.
template <bool THREE_D, int C, typename Column, typename Load, typename Own,
          typename Visit>
__device__ __forceinline__ void walk_tile(int n0, int n1, int n2, int tile,
                                          Column column, Load load, Own own,
                                          Visit visit) {
  using V = decltype(column(0));
  constexpr int BX = THREE_D ? 32 : 256, BY = THREE_D ? 8 : 1;
  if (!THREE_D) n1 = 1;
  const int t2n = (n2 + BX - 1) / BX, t1n = (n1 + BY - 1) / BY;
  const int rest = tile / t2n;
  const int k = (tile - rest * t2n) * BX + threadIdx.x;
  const int j = THREE_D ? (rest % t1n) * BY + threadIdx.y : 0;
  const int i0 = (rest / t1n) * kPlanes;
  if (j >= n1) return;  // the whole warp: a warp is one row
  const bool in = k < n2;
  const int lane = threadIdx.x & 31;
  const int s0 = n1 * n2, col = j * n2 + k;
  const int nq = min(kPlanes, n0 - i0);
  // lane 0's left and lane 31's right neighbour column
  const int side = lane == 0 ? -1 : (lane == 31 ? 1 : 0);
  const bool has_side = in && side != 0 && k + side >= 0 && k + side < n2;
  V prev = in && i0 > 0 ? column((i0 - 1) * s0 + col) : V{};
  V cur = in ? column(i0 * s0 + col) : V{};
#pragma unroll
  for (int q0 = 0; q0 < kPlanes; q0 += C) {
    if (q0 >= nq) break;  // the same for the whole warp
    V next[C];
    float e[C], ym[C], yp[C];
    decltype(own(0)) w[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int i = i0 + q0 + q, o = i * s0 + col;
      const bool here = in && q0 + q < nq;
      next[q] = here && i + 1 < n0 ? column(o + s0) : V{};
      e[q] = has_side && q0 + q < nq ? load(o + side) : 0.f;
      ym[q] = THREE_D && here && j > 0 ? load(o - n2) : 0.f;
      yp[q] = THREE_D && here && j + 1 < n1 ? load(o + n2) : 0.f;
      if (here) w[q] = own(o);
    }
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (q0 + q < nq) {  // the same for the whole warp
        const float mid = lap_value(cur);
        float zm = __shfl_up_sync(0xffffffffu, mid, 1);
        float zp = __shfl_down_sync(0xffffffffu, mid, 1);
        if (lane == 0) zm = e[q];
        if (lane == 31) zp = e[q];
        if (k + 1 >= n2) zp = 0.f;
        const int i = i0 + q0 + q;
        if (in)
          visit(i * s0 + col, i, col, q0 + q, w[q], cur,
                laplacian<float, THREE_D>(mid, lap_value(prev),
                                          lap_value(next[q]), ym[q], yp[q],
                                          zm, zp));
        prev = cur;
        cur = next[q];
      }
    }
  }
}

// B12's walk: the same load() along n0 and beside, in chunks of
// walk_chunk planes.
template <bool THREE_D, bool PRECOND, typename Load, typename Own,
          typename Visit>
__device__ __forceinline__ void walk_slab(int n0, int n1, int n2, int tile,
                                          Load load, Own own, Visit visit) {
  walk_tile<THREE_D, walk_chunk<THREE_D, PRECOND>()>(n0, n1, n2, tile, load,
                                                     load, own, visit);
}

// The points of this thread's column in tile `tile`, in walk_slab's order,
// a chunk's fetch(o) loaded first, together: visit(o, i, c, q, fetch(o)).
template <bool THREE_D, bool PRECOND, typename Fetch, typename Visit>
__device__ __forceinline__ void points_slab(int n0, int n1, int n2, int tile,
                                            Fetch fetch, Visit visit) {
  constexpr int BX = THREE_D ? 32 : 256, BY = THREE_D ? 8 : 1;
  constexpr int C = points_chunk<THREE_D, PRECOND>();
  if (!THREE_D) n1 = 1;
  const int t2n = (n2 + BX - 1) / BX, t1n = (n1 + BY - 1) / BY;
  const int rest = tile / t2n;
  const int k = (tile - rest * t2n) * BX + threadIdx.x;
  const int j = THREE_D ? (rest % t1n) * BY + threadIdx.y : 0;
  const int i0 = (rest / t1n) * kPlanes;
  if (j >= n1 || k >= n2) return;
  const int s0 = n1 * n2, col = j * n2 + k;
  const int nq = min(kPlanes, n0 - i0);
#pragma unroll
  for (int q0 = 0; q0 < kPlanes; q0 += C) {
    decltype(fetch(0)) v[C];
#pragma unroll
    for (int q = 0; q < C; ++q)
      if (q0 + q < nq) v[q] = fetch((i0 + q0 + q) * s0 + col);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int i = i0 + q0 + q;
      if (q0 + q < nq) visit(i * s0 + col, i, col, q0 + q, v[q]);
    }
  }
}

// The shard's next barrier, and what it carries.  The CTA whose arrival
// completes it (its atomic acq_rel acquires what every CTA released by
// arriving) does, for the shard: with nv > 0 the next allreduce, of the
// totals of part0 (and part1 with nv == 2), each summed over the shard's
// CTA slots in slot order and stored, tagged, into its row of every
// shard's dots; with pub >= 0 the publish of halo exchange pub to both
// neighbours; and the generation, all after one fence.  The other CTAs
// wait for the P rows (with nv == 0, for the generation).  With nv > 0
// each CTA's thread 0 adds the P rows in shard order and hands the sums to
// done(s0, s1) before the CTA leaves the barrier.
template <typename Done>
__device__ __forceinline__ void shard_barrier(Shard& S, int nv,
                                              const float* part0,
                                              const float* part1, int pub,
                                              Done done) {
  const bool t0 = lead_thread();
  // the counters are thread 0's: no other thread needs them
  unsigned epoch = 0;
  int ar = 0;
  __syncthreads();
  if (t0) {
    epoch = ++S.epoch;
    ar = S.ar;
    if (nv > 0) S.ar = ar + 1;
    const unsigned long long n =
        atom_add_acq_rel(at<unsigned long long>(S.mine, xch_arrivals(S.l)),
                         1ULL) + 1ULL;
    S.last = n == (unsigned long long)S.nb * epoch;
  }
  __syncthreads();
  const int parity = ar & 1;
  const unsigned tag = (unsigned)ar + 1;
  const int P = S.l.n_shards;
  if (S.last) {
    const float v0 = nv > 0 ? grid_total(part0, S.nb) : 0.f;
    const float v1 = nv > 1 ? grid_total(part1, S.nb) : 0.f;
    if (t0) {
      fence_acq_rel();
      if (pub >= 0) {
        if (S.left)
          st_relaxed(at<unsigned>(S.left, xch_hflag(S.l, pub & 1, 1)),
                     (unsigned)pub + 1);
        if (S.right)
          st_relaxed(at<unsigned>(S.right, xch_hflag(S.l, pub & 1, 0)),
                     (unsigned)pub + 1);
      }
      for (int q = 0; q < (nv > 0 ? P : 0); ++q) {
        unsigned long long* row =
            at<unsigned long long>(S.table[q], xch_dots(S.l, parity, S.s));
        st_relaxed(row, dot_word(tag, v0));
        if (nv > 1) st_relaxed(row + 1, dot_word(tag, v1));
      }
      st_relaxed(at<unsigned>(S.mine, xch_generation(S.l)), epoch);
    }
  }
  if (t0) {
    if (nv > 0) {
      float a0 = 0.f, a1 = 0.f;
      for (int q = 0; q < P; ++q) {
        const unsigned long long* row =
            at<unsigned long long>(S.mine, xch_dots(S.l, parity, q));
        const float w0 = wait_word(row, tag);
        const float w1 = nv > 1 ? wait_word(row + 1, tag) : 0.f;
        a0 = q == 0 ? w0 : add_rn(a0, w0);
        a1 = q == 0 ? w1 : add_rn(a1, w1);
      }
      done(a0, a1);
    } else if (!S.last) {
      wait_flag(at<unsigned>(S.mine, xch_generation(S.l)), epoch);
    }
    fence_acq_rel();
  }
  __syncthreads();
}

// A barrier that reduces nothing.
__device__ __forceinline__ void shard_barrier(Shard& S, int pub) {
  shard_barrier(S, 0, nullptr, nullptr, pub, [](float, float) {});
}

// Before a pass that reads exchange e: the CTAs whose tiles hold an edge
// plane wait for that side's flag.
__device__ __forceinline__ void await_halo(const Shard& S, int e) {
  if (!(S.up | S.down)) return;
  if (lead_thread()) {
    if (S.up) wait_flag(at<unsigned>(S.mine, xch_hflag(S.l, e & 1, 0)),
                        (unsigned)e + 1);
    if (S.down) wait_flag(at<unsigned>(S.mine, xch_hflag(S.l, e & 1, 1)),
                          (unsigned)e + 1);
    fence_acq_rel();
  }
  __syncthreads();
}

// A point of exchange e at plane i: the edge planes go to the neighbours'
// slots (my first plane is the left one's "below", my last plane the right
// one's "above").
__device__ __forceinline__ void push(const Shard& S, int e, int i, int c,
                                     float v) {
  if (i == 0 && S.up)
    __stcg(at<float>(S.left, xch_halo(S.l, e & 1, 1)) + c, v);
  if (i == S.n0 - 1 && S.down)
    __stcg(at<float>(S.right, xch_halo(S.l, e & 1, 0)) + c, v);
}

// v = scale * lap plus -scale * the halo (both halos on a one-plane slab).
__device__ __forceinline__ float edge_fix(float v, float scale, int n0,
                                          bool up, float above, float below) {
  if (n0 == 1) return add_rn(v, mul_rn(-scale, add_rn(above, below)));
  return add_rn(v, mul_rn(-scale, up ? above : below));
}

// scale * lap at (i, c) with exchange e's halos (the Chebyshev steps).
__device__ __forceinline__ float halo_stencil(const Shard& S, int e, int i,
                                              int c, float scale, float lap) {
  const float v = mul_rn(scale, lap);
  const bool up = i == 0 && S.up, down = i == S.n0 - 1 && S.down;
  if (!up && !down) return v;
  const float above =
      up ? __ldcg(at<float>(S.mine, xch_halo(S.l, e & 1, 0)) + c) : 0.f;
  const float below =
      down ? __ldcg(at<float>(S.mine, xch_halo(S.l, e & 1, 1)) + c) : 0.f;
  return edge_fix(v, scale, S.n0, up, above, below);
}

// The neighbour's p at column c of side `side` for this iteration, from
// exchange e's z edge and this shard's copy of the neighbour's previous p
// (p = z at iteration 0), kept for the next iteration.  Only the thread
// that owns column c at that edge plane reads and writes the copy.
__device__ __forceinline__ float p_edge(const Shard& S, int e, int side,
                                        int c, bool fresh, float beta) {
  const float z = __ldcg(at<float>(S.mine, xch_halo(S.l, e & 1, side)) + c);
  float* own = at<float>(S.mine, xch_phalo(S.l, side)) + c;
  const float pv = fresh ? z : add_rn(z, mul_rn(beta, *own));
  *own = pv;
  return pv;
}

// What the x/r pass loads at a point (x lies in shared memory).
struct PR {
  float p, r;
};

template <bool THREE_D, bool PRECOND>
__global__ void __launch_bounds__(kThreads, dist_blocks_per_sm(THREE_D))
    resident_dist_kernel(DistArgs a) {
  // [2][the CTA's tiles][kPlanes][kThreads]: a point's Ap, then its d; and
  // its x
  extern __shared__ float slots[];
  __shared__ Shard S;
  const int s = blockIdx.x / a.nb;
  const int lb = blockIdx.x - s * a.nb;
  const int n0 = a.n0, n1 = a.n1, n2 = a.n2;
  const int nb = a.nb;
  if (lead_thread()) {
    const int64_t cells = (int64_t)n0 * n1 * n2, off = s * cells;
    S.l = xch_layout((int64_t)n1 * n2, a.n_shards);
    // at one shard without a table: its region, and a table of it
    S.mine = a.peers != nullptr ? a.peers[s] : a.region;
    S.table = a.peers != nullptr ? a.peers : &S.mine;
    S.left = s > 0 ? a.peers[s - 1] : nullptr;
    S.right = s + 1 < a.n_shards ? a.peers[s + 1] : nullptr;
    S.b = a.b + off;
    S.x = a.x + off;
    S.r = a.r + off;
    S.p[0] = a.p0 + off;
    S.p[1] = a.p1 + off;
    S.z1 = PRECOND && a.z1 ? a.z1 + off : nullptr;
    S.z2 = PRECOND && a.z2 ? a.z2 + off : nullptr;
    for (int q = 0; q < 3; ++q)
      S.part[q] = a.partials + ((int64_t)s * 3 + q) * a.tiles;
    S.n0 = n0;
    S.n1 = n1;
    S.n2 = n2;
    S.tiles = a.tiles;
    S.hist = a.hist + (int64_t)s * (a.nblocks + 1);
    S.s = s;
    S.lb = lb;
    S.nb = nb;
    S.epoch = 0;
    S.ar = 0;
    S.indefinite = 0;
    S.scale = a.params[0];
    S.theta = PRECOND ? cheb_of(a.params[3], a.params[4]).theta : 1.f;
    S.cap = *a.cap;
    // the layers of kPlanes planes that hold the first and last plane
    const int layer = ((n2 + (THREE_D ? 31 : 255)) / (THREE_D ? 32 : 256)) *
                      ((n1 + (THREE_D ? 7 : 0)) / (THREE_D ? 8 : 1));
    int up = 0, down = 0;
    for (int t = lb; t < a.tiles; t += nb) {
      up |= t / layer == 0;
      down |= t / layer == (n0 - 1) / kPlanes;
    }
    S.up = up && S.left != nullptr;
    S.down = down && S.right != nullptr;
  }
  __syncthreads();

  float* const slot =
      slots + threadIdx.y * (THREE_D ? 32 : 256) + threadIdx.x;
  // x's slots, after those of Ap and d
  const auto xslot = [&]() {
    return slot + (S.tiles + S.nb - 1) / S.nb * kPlanes * kThreads;
  };
  // at degree 1 z = r / theta is formed where it is used
  const bool by_theta = PRECOND && a.degree == 1;
  int ex = 0;    // the next halo exchange to push

  // the plane of the last Chebyshev step's z (step degree - 2 writes z1
  // when even, z2 when odd)
  const auto zl = [&]() -> const float* {
    return a.degree % 2 == 0 ? S.z1 : S.z2;
  };

  // z = P(A) r for degree >= 2 (B10's cheb_apply with the halo exchanges):
  // step j reads exchange ex - 1 (r / theta at step 0, z_{j-1} after) and
  // pushes its z as the next one, the last step's for the next Ap pass;
  // its barrier publishes that and, at the last step, carries the r.z
  // allreduce: rho, and beta after the first.  z lies in plane zl.
  auto cheb_apply = [&](bool first) {
    const Cheb<float> cb = cheb_of(a.params[3], a.params[4]);
    float rho_c = div_rn(1.f, cb.sigma);
    for (int j = 0; j < a.degree - 1; ++j) {
      const float rho_n = div_rn(1.f, sub_rn(mul_rn(2.f, cb.sigma), rho_c));
      const float c1 = mul_rn(rho_n, rho_c);
      const float c2 = div_rn(mul_rn(2.f, rho_n), cb.delta);
      const bool last = j == a.degree - 2;
      float* const out = (j % 2 == 0) ? S.z1 : S.z2;
      const float* const zin = (j % 2 == 0) ? S.z2 : S.z1;  // step j - 1's
      const float* const r = S.r;
      const float scale = S.scale, theta = cb.theta;
      const int e_in = ex - 1;
      await_halo(S, e_in);
      float acc = 0.f;
      int lt = 0;
      for (int tile = S.lb; tile < S.tiles; tile += S.nb, ++lt) {
        float* const sl = slot + lt * kPlanes * kThreads;
        auto own = [&](int o) { return __ldcg(r + o); };
        auto visit = [&](int o, int i, int c, int q, float rv, float z,
                         float lap) {
          const float dv = j == 0 ? z : sl[q * kThreads];
          const float dn = add_rn(
              mul_rn(c1, dv),
              mul_rn(c2, sub_rn(rv, halo_stencil(S, e_in, i, c, scale, lap))));
          const float zn = add_rn(z, dn);
          __stcg(out + o, zn);
          sl[q * kThreads] = dn;
          if (last) acc = add_rn(acc, mul_rn(rv, zn));
          push(S, ex, i, c, zn);
        };
        if (j == 0)
          walk_slab<THREE_D, PRECOND>(
              S.n0, S.n1, S.n2, tile,
              [&](int o) { return div_rn(__ldcg(r + o), theta); }, own,
              visit);
        else
          walk_slab<THREE_D, PRECOND>(
              S.n0, S.n1, S.n2, tile, [&](int o) { return __ldcg(zin + o); },
              own, visit);
      }
      if (last) {
        put_partial_at(S.part[2], S.lb, acc);
        shard_barrier(S, 1, S.part[2], nullptr, ex++,
                      [&](float rho, float) {
                        if (!first) S.beta = safe_div(rho, S.rho);
                        S.rho = rho;
                      });
      } else {
        shard_barrier(S, ex++);
      }
      rho_c = rho_n;
    }
  };

  // init: x = x0 and r = b - scale * A x0 (B10's operations, in B10's
  // order), or x = 0 and r = b; the r.r partials (and at degree 1 the r.z
  // ones, z = r / theta); z0's edge planes (r0, or r0 / theta for every
  // preconditioned degree: at degree >= 2 the first Chebyshev step's
  // input) are the first exchange.  The init barrier below completes r0
  // before any CTA reads a neighbour's.  A warm start runs at one shard
  // only (the launch refuses it over several), so A x0 needs no halo.
  {
    const float theta = S.theta, scale = S.scale;
    const float* const b = S.b;
    const float* const x0 = a.x0;
    float* const r = S.r;
    float acc = 0.f, acc_rz = 0.f;
    int lt = 0;
    for (int tile = S.lb; tile < S.tiles; tile += S.nb, ++lt) {
      float* const xl = xslot() + lt * kPlanes * kThreads;
      auto seed = [&](int o, int i, int c, int q, float xv, float r0) {
        xl[q * kThreads] = xv;
        __stcg(r + o, r0);
        acc = add_rn(acc, mul_rn(r0, r0));
        const float ze = PRECOND ? div_rn(r0, theta) : r0;
        if (by_theta) acc_rz = add_rn(acc_rz, mul_rn(r0, ze));
        push(S, ex, i, c, ze);
      };
      if (x0 != nullptr)
        walk_slab<THREE_D, PRECOND>(
            S.n0, S.n1, S.n2, tile, [&](int o) { return x0[o]; },
            [&](int o) { return b[o]; },
            [&](int o, int i, int c, int q, float bv, float xv, float lap) {
              seed(o, i, c, q, xv, sub_rn(bv, mul_rn(scale, lap)));
            });
      else
        points_slab<THREE_D, PRECOND>(
            S.n0, S.n1, S.n2, tile, [&](int o) { return b[o]; },
            [&](int o, int i, int c, int q, float r0) {
              seed(o, i, c, q, 0.f, r0);
            });
    }
    put_partial_at(S.part[1], S.lb, acc);
    if (by_theta) put_partial_at(S.part[2], S.lb, acc_rz);
  }
  {
    float* const hist = S.hist;
    for (int j = S.lb * kThreads + threadIdx.y * (THREE_D ? 32 : 256) +
                 threadIdx.x;
         j <= a.nblocks; j += nb * kThreads)
      hist[j] = -1.f;  // sentinel: the block never ran
  }
  shard_barrier(S, by_theta ? 2 : 1, S.part[1], S.part[2],
                ex++, [&](float rr, float rz) {
                  S.rr = rr;
                  S.rho = by_theta ? rz : rr;
                  S.thresh2 = threshold2(a.params[1], a.params[2], rr);
                  if (S.lb == 0) S.hist[0] = rr;
                });
  if (PRECOND && !by_theta) cheb_apply(true);
  int it = 0;  // iterations so far

  for (int blk = 0; blk < a.nblocks; ++blk) {
    {
      const float rr = S.rr, rho = S.rho;
      const bool healthy = isfinite(rr) && isfinite(rho) && rho > 0.f;
      if (!(rr >= S.thresh2 && rr > 0.f && it < S.cap && healthy)) break;
    }
    for (const int end = it + min(a.check_every, S.cap - it); it < end;
         ++it) {
      const bool fresh = it == 0;  // p = z; after, p = z + beta p_old
      float* const pnew = S.p[it & 1];

      // phase 1: p = z + beta p_old at the points and the neighbours it
      // reads (the neighbour shards' edges from exchange e_p's z and this
      // shard's copies), written at its own points into plane it & 1;
      // Ap = A p into the shared slots; partials of p.Ap
      float acc = 0.f;
      {
        const int e_p = ex - 1;
        const float* const pold = S.p[(it & 1) ^ 1];
        const float* const z = PRECOND && !by_theta ? zl() : S.r;
        const float scale = S.scale, theta = S.theta, beta = S.beta;
        await_halo(S, e_p);
        int lt = 0;
        for (int tile = S.lb; tile < S.tiles; tile += S.nb, ++lt) {
          float* const sl = slot + lt * kPlanes * kThreads;
          walk_slab<THREE_D, PRECOND>(
              S.n0, S.n1, S.n2, tile,
              [&](int o) {
                float zv = __ldcg(z + o);
                if (by_theta) zv = div_rn(zv, theta);
                const float pv = __ldcg(pold + o);  // unused at it == 0
                return fresh ? zv : add_rn(zv, mul_rn(beta, pv));
              },
              [](int) { return 0.f; },
              [&](int o, int i, int c, int q, float, float u, float lap) {
                __stcg(pnew + o, u);
                float v = mul_rn(scale, lap);
                const bool up = i == 0 && S.up;
                const bool down = i == S.n0 - 1 && S.down;
                if (up || down) {
                  const float above =
                      up ? p_edge(S, e_p, 0, c, fresh, beta) : 0.f;
                  const float below =
                      down ? p_edge(S, e_p, 1, c, fresh, beta) : 0.f;
                  v = edge_fix(v, scale, S.n0, up, above, below);
                }
                sl[q * kThreads] = v;
                acc = add_rn(acc, mul_rn(u, v));
              });
        }
      }
      put_partial_at(S.part[0], S.lb, acc);
      shard_barrier(S, 1, S.part[0], nullptr, -1, [&](float pap, float) {
        if (pap <= 0.f && S.rr > 0.f) S.indefinite = 1;
        S.alpha = safe_div(S.rho, pap);
      });

      // phase 2: x += alpha p, r -= alpha Ap, partials of r.r (and of
      // r . r / theta at degree 1); z's edge planes (r, or r / theta for
      // the next p at degree 1 and for the first Chebyshev step at degree
      // >= 2) are the next exchange, published by this pass's barrier
      acc = 0.f;
      float acc_rz = 0.f;
      {
        float* const r = S.r;
        const float theta = S.theta, alpha = S.alpha;
        int lt = 0;
        for (int tile = S.lb; tile < S.tiles; tile += S.nb, ++lt) {
          float* const sl = slot + lt * kPlanes * kThreads;
          float* const xl = xslot() + lt * kPlanes * kThreads;
          points_slab<THREE_D, PRECOND>(
              S.n0, S.n1, S.n2, tile,
              [&](int o) { return PR{__ldcg(pnew + o), __ldcg(r + o)}; },
              [&](int o, int i, int c, int q, PR v) {
                xl[q * kThreads] =
                    add_rn(xl[q * kThreads], mul_rn(alpha, v.p));
                const float rn =
                    sub_rn(v.r, mul_rn(alpha, sl[q * kThreads]));
                __stcg(r + o, rn);
                acc = add_rn(acc, mul_rn(rn, rn));
                const float ze = PRECOND ? div_rn(rn, theta) : rn;
                if (by_theta) acc_rz = add_rn(acc_rz, mul_rn(rn, ze));
                push(S, ex, i, c, ze);
              });
        }
      }
      put_partial_at(S.part[1], S.lb, acc);
      if (by_theta) put_partial_at(S.part[2], S.lb, acc_rz);
      shard_barrier(S, by_theta ? 2 : 1, S.part[1], S.part[2], ex++,
                    [&](float rr, float rz) {
                      // rho = r.z: r.r, r.(r / theta), or at degree >= 2
                      // the Chebyshev steps' (their last barrier)
                      if (!PRECOND || by_theta) {
                        const float rho = by_theta ? rz : rr;
                        S.beta = safe_div(rho, S.rho);
                        S.rho = rho;
                      }
                      S.rr = rr;
                    });
      if (PRECOND && !by_theta) cheb_apply(false);
    }
    if (S.lb == 0 && lead_thread()) S.hist[blk + 1] = S.rr;
  }

  // x leaves the chip once
  {
    float* const x = S.x;
    int lt = 0;
    for (int tile = S.lb; tile < S.tiles; tile += S.nb, ++lt) {
      const float* const xl = xslot() + lt * kPlanes * kThreads;
      points_slab<THREE_D, PRECOND>(
          S.n0, S.n1, S.n2, tile, [](int) { return 0.f; },
          [&](int o, int, int, int q, float) { x[o] = xl[q * kThreads]; });
    }
  }
  if (S.lb == 0 && lead_thread()) {
    const float rr = S.rr, rho = S.rho;
    a.rr_out[S.s] = rr;
    int* f = a.flags + 4 * S.s;
    f[0] = it;
    f[1] = S.indefinite;
    f[2] = (rr < S.thresh2 || rr == 0.f) ? 1 : 0;
    f[3] = (isfinite(rr) && isfinite(rho) && (rho > 0.f || rr == 0.f)) ? 1 : 0;
  }
}

// B10's cg1 form (resident.cu's resident_cg1_kernel, the Chronopoulos-Gear
// recurrence of _resident_kernel_cg1) on this body's machinery at one
// shard: B12's tile walk, shard barrier, shared slots and geometry.  The
// tile walk of resident.cu spends two grid barriers and two passes an
// iteration, x += alpha p and r -= alpha s in one and w = A r in the other,
// with all six planes in L2 (11 plane accesses an iteration), and every
// block sums every partial after each barrier.  Here an iteration is ONE
// pass and ONE barrier:
//  * r is formed where it is read.  Of the recurrence's planes only r is
//    read across CTAs (w = A r).  Pass t forms, at its own points and at
//    every stencil neighbour it reads, s_t = w_t + beta s_{t-1} (iteration
//    t - 1's direction update, deferred as in the tile walk; s_0 = w_0) and
//    r_{t+1} = r_t - alpha s_t, from r_t, w_t and s_{t-1}, which were in L2
//    before the barrier, with the owner's operations in the owner's order,
//    so every copy of a point has the owner's bits.  It then takes w_{t+1}
//    = A r_{t+1} and the partials of r.r and w.r.
//  * the owner writes r_{t+1}, w_{t+1} and s_t into the other parity of two
//    planes each (r, w and s of pass t are read from parity t & 1 and
//    written to (t + 1) & 1), so no CTA overwrites a value a neighbour
//    still reads in the same pass.  An edge copy of the tile faces instead
//    would keep one plane each but copy the faces in two parities: 26 % of
//    a 2D tile, 56 % of a 3D one (47 % as distinct points), three values
//    each - at 128^3 as many bytes in L2 as the second parity, and a face
//    pass more.
//  * p and x lie in the shared slots (only the owning thread reads them:
//    p = r + beta p, x += alpha p), x reaches its plane once, at the end.
//  * the barrier carries the reduction: the CTA that completes it sums the
//    CTA partials of r.r and w.r once, in slot order (grid_total, the tile
//    walk's order), and thread 0 of every CTA derives beta, denom, alpha
//    and the indefinite flag from them into shared memory.
// So an iteration reads r, w, s of one parity (the neighbours' again at the
// tile faces) and writes those of the other: 6 plane accesses, one
// barrier.  The grid is the tile walk's (dist_geometry at one shard: B10's
// CTAs per SM, at most one a tile) and every CTA walks the same tiles in
// the same order with the same operations, so x, the trace and the
// iteration count are the tile walk's bits.  A warm start keeps the tile
// walk's extra init barrier (r0 = b - A x0 is complete before w0 = A r0).
struct Cg1ShardArgs {
  const float* b;
  const float* x0;      // a warm start, or nullptr: x0 = 0
  float* x;
  float *r0, *r1;       // r_t in r0 at even t, r1 at odd
  float *s0, *s1;       // s_{t-1}, the same
  float *w0, *w1;       // w_t = A r_t, the same
  const float* params;  // scale, tol, rtol
  const int* cap;
  float* part_rr;       // one slot per CTA
  float* part_delta;    // one slot per CTA
  char* region;         // the shard's zeroed exchange region (its barrier)
  float* rr_out;
  int* flags;           // iterations, indefinite, converged, healthy
  float* hist;          // nblocks + 1 slots
  int n0, n1, n2;
  int tiles;
  int nb;               // CTAs
  int nblocks;
  int check_every;
};

// A column entry of the cg1 pass: r_t, r_{t+1} and s_t at a point; the
// stencil reads r_{t+1}.
struct Cg1Col {
  float r, rn, sn;
};
__device__ __forceinline__ float lap_value(const Cg1Col& v) { return v.rn; }

// The cg1 pass walks one plane of a tile column at a time: a neighbour
// costs three loads there (r, w and s), and on the H100 chunks of two or
// four planes, the registers they hold, ran slower than one, in 2D and
// in 3D.
constexpr int kCg1Chunk = 1;

template <bool THREE_D>
__global__ void __launch_bounds__(kThreads, dist_blocks_per_sm(THREE_D))
    resident_cg1_shard_kernel(Cg1ShardArgs a) {
  // [2][the CTA's tiles][kPlanes][kThreads]: a point's p, and its x
  extern __shared__ float slots[];
  __shared__ Shard S;
  const int lb = blockIdx.x;
  if (lead_thread()) {
    S.l = xch_layout((int64_t)a.n1 * a.n2, 1);
    S.mine = a.region;
    S.table = &S.mine;
    S.left = S.right = nullptr;
    S.n0 = a.n0;
    S.n1 = a.n1;
    S.n2 = a.n2;
    S.tiles = a.tiles;
    S.hist = a.hist;
    S.s = 0;
    S.lb = lb;
    S.nb = a.nb;
    S.epoch = 0;
    S.ar = 0;
    S.indefinite = 0;
    S.up = S.down = 0;
    S.scale = a.params[0];
    S.cap = *a.cap;
    S.beta = 0.f;
  }
  __syncthreads();
  float* const slot =
      slots + threadIdx.y * (THREE_D ? 32 : 256) + threadIdx.x;
  const auto xslot = [&]() {
    return slot + (S.tiles + S.nb - 1) / S.nb * kPlanes * kThreads;
  };

  // init (the tile walk's): x = x0 and r0 = b - A x0, completed by a
  // barrier, or x = 0 and r0 = b; then w0 = A r0 and the partials of r.r
  // and w.r; the barrier reduces them to rr0 and delta0
  {
    const float scale = S.scale;
    const float* const b = a.b;
    const float* const x0 = a.x0;
    float* const r = a.r0;
    float* const w = a.w0;
    if (x0 != nullptr) {
      int lt = 0;
      for (int tile = lb; tile < S.tiles; tile += S.nb, ++lt) {
        float* const xl = xslot() + lt * kPlanes * kThreads;
        walk_slab<THREE_D, false>(
            S.n0, S.n1, S.n2, tile, [&](int o) { return x0[o]; },
            [&](int o) { return b[o]; },
            [&](int o, int, int, int q, float bv, float xv, float lap) {
              xl[q * kThreads] = xv;
              __stcg(r + o, sub_rn(bv, mul_rn(scale, lap)));
            });
      }
      shard_barrier(S, -1);
    }
    float acc_rr = 0.f, acc_d = 0.f;
    int lt = 0;
    for (int tile = lb; tile < S.tiles; tile += S.nb, ++lt) {
      float* const xl = xslot() + lt * kPlanes * kThreads;
      walk_slab<THREE_D, false>(
          S.n0, S.n1, S.n2, tile,
          [&](int o) { return x0 != nullptr ? __ldcg(r + o) : b[o]; },
          [](int) { return 0.f; },
          [&](int o, int, int, int q, float, float u, float lap) {
            if (x0 == nullptr) {
              xl[q * kThreads] = 0.f;
              __stcg(r + o, u);
            }
            const float wv = mul_rn(scale, lap);
            __stcg(w + o, wv);
            acc_rr = add_rn(acc_rr, mul_rn(u, u));
            acc_d = add_rn(acc_d, mul_rn(wv, u));
          });
    }
    put_partial_at(a.part_rr, lb, acc_rr);
    put_partial_at(a.part_delta, lb, acc_d);
  }
  for (int j = lb * kThreads + threadIdx.y * (THREE_D ? 32 : 256) +
               threadIdx.x;
       j <= a.nblocks; j += S.nb * kThreads)
    a.hist[j] = -1.f;  // sentinel: the block never ran
  shard_barrier(S, 2, a.part_rr, a.part_delta, -1,
                [&](float rr, float delta0) {
                  S.rr = rr;
                  S.alpha = safe_div(rr, delta0);  // one step ahead
                  S.indefinite = (delta0 <= 0.f && rr > 0.f) ? 1 : 0;
                  S.thresh2 = threshold2(a.params[1], a.params[2], rr);
                  if (lb == 0) S.hist[0] = rr;
                });
  int it = 0;  // iterations so far

  for (int blk = 0; blk < a.nblocks; ++blk) {
    {
      const float rr = S.rr;
      const bool healthy = isfinite(rr) && isfinite(S.alpha);
      if (!(rr >= S.thresh2 && rr > 0.f && it < S.cap && healthy)) break;
    }
    for (const int end = it + min(a.check_every, S.cap - it); it < end;
         ++it) {
      // iteration t = it: p_t = r_t + beta p_{t-1} (p_0 = r_0), x += alpha
      // p_t, s_t, r_{t+1}, w_{t+1} = A r_{t+1}, partials of r.r and w.r
      const bool odd = it & 1;
      const float* const r = odd ? a.r1 : a.r0;
      const float* const w = odd ? a.w1 : a.w0;
      const float* const s = odd ? a.s1 : a.s0;
      float* const rn = odd ? a.r0 : a.r1;
      float* const wn = odd ? a.w0 : a.w1;
      float* const sn = odd ? a.s0 : a.s1;
      const float scale = S.scale, alpha = S.alpha, beta = S.beta;
      float acc_rr = 0.f, acc_d = 0.f;
      // the pass, with t = 0 (s_0 = w_0, p_0 = r_0) decided at compile
      // time: a test of t at each load kept the walk's loads from going
      // out together, which slowed the 3D pass markedly on the H100
      const auto pass = [&](auto first) {
        constexpr bool fresh = decltype(first)::value;
        // s_t and r_{t+1} at a point, with r_t beside them
        const auto step = [&](int o) {
          const float rv = __ldcg(r + o);
          const float wv = __ldcg(w + o);
          float sv = wv;
          if constexpr (!fresh) sv = add_rn(wv, mul_rn(beta, __ldcg(s + o)));
          return Cg1Col{rv, sub_rn(rv, mul_rn(alpha, sv)), sv};
        };
        int lt = 0;
        for (int tile = lb; tile < S.tiles; tile += S.nb, ++lt) {
          float* const pl = slot + lt * kPlanes * kThreads;
          float* const xl = xslot() + lt * kPlanes * kThreads;
          walk_tile<THREE_D, kCg1Chunk>(
              S.n0, S.n1, S.n2, tile, step,
              [&](int o) { return step(o).rn; }, [](int) { return 0.f; },
              [&](int o, int, int, int q, float, Cg1Col u, float lap) {
                float pv = u.r;
                if constexpr (!fresh)
                  pv = add_rn(u.r, mul_rn(beta, pl[q * kThreads]));
                pl[q * kThreads] = pv;
                xl[q * kThreads] =
                    add_rn(xl[q * kThreads], mul_rn(alpha, pv));
                const float wv = mul_rn(scale, lap);
                __stcg(rn + o, u.rn);
                __stcg(sn + o, u.sn);
                __stcg(wn + o, wv);
                acc_rr = add_rn(acc_rr, mul_rn(u.rn, u.rn));
                acc_d = add_rn(acc_d, mul_rn(wv, u.rn));
              });
        }
      };
      if (it == 0)
        pass(std::true_type{});
      else
        pass(std::false_type{});
      put_partial_at(a.part_rr, lb, acc_rr);
      put_partial_at(a.part_delta, lb, acc_d);
      shard_barrier(S, 2, a.part_rr, a.part_delta, -1,
                    [&](float rr_new, float delta) {
                      const float bt = safe_div(rr_new, S.rr);
                      const float denom = sub_rn(
                          delta, mul_rn(bt, safe_div(rr_new, S.alpha)));
                      S.alpha = safe_div(rr_new, denom);
                      if (denom <= 0.f && rr_new > 0.f) S.indefinite = 1;
                      S.beta = bt;
                      S.rr = rr_new;
                    });
    }
    if (lb == 0 && lead_thread()) S.hist[blk + 1] = S.rr;
  }

  // x leaves the chip once
  {
    float* const x = a.x;
    int lt = 0;
    for (int tile = lb; tile < S.tiles; tile += S.nb, ++lt) {
      const float* const xl = xslot() + lt * kPlanes * kThreads;
      points_slab<THREE_D, false>(
          S.n0, S.n1, S.n2, tile, [](int) { return 0.f; },
          [&](int o, int, int, int q, float) { x[o] = xl[q * kThreads]; });
    }
  }
  if (lb == 0 && lead_thread()) {
    const float rr = S.rr;
    *a.rr_out = rr;
    a.flags[0] = it;
    a.flags[1] = S.indefinite;
    a.flags[2] = (rr < S.thresh2 || rr == 0.f) ? 1 : 0;
    a.flags[3] = (isfinite(rr) && isfinite(S.alpha)) ? 1 : 0;
  }
}

static const void* dist_fn(bool three_d, bool precond) {
  if (three_d)
    return precond ? (const void*)resident_dist_kernel<true, true>
                   : (const void*)resident_dist_kernel<true, false>;
  return precond ? (const void*)resident_dist_kernel<false, true>
                 : (const void*)resident_dist_kernel<false, false>;
}

static const void* cg1_shard_fn(bool three_d) {
  return three_d ? (const void*)resident_cg1_shard_kernel<true>
                 : (const void*)resident_cg1_shard_kernel<false>;
}

// CTAs per SM of kernel fn when its CTAs take the slots of the most tiles a
// CTA walks (dist_max_tiles), at most B10's: a launch takes B10's, and
// fails when the card gives fewer.
static cudaError_t slots_per_sm(const void* fn, bool three_d, int* per_sm) {
  const int smem = (int)dist_slot_bytes(dist_max_tiles(three_d));
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kThreads,
                                                      smem);
  if (*per_sm > dist_blocks_per_sm(three_d))
    *per_sm = dist_blocks_per_sm(three_d);
  return err;
}

cudaError_t dist_per_sm(bool three_d, bool precond, int* per_sm) {
  return slots_per_sm(dist_fn(three_d, precond), three_d, per_sm);
}

cudaError_t cg1_shard_per_sm(bool three_d, int* per_sm) {
  return slots_per_sm(cg1_shard_fn(three_d), three_d, per_sm);
}

// The SMs of the current device, if it takes cooperative launches.
static cudaError_t coop_sms(int* sms) {
  int dev = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

int launch_cg1_shard(const float* b, const float* x0, float* x, float* r0,
                     float* r1, float* s0, float* s1, float* w0, float* w1,
                     const float* params, const int* cap, float* partials,
                     char* region, float* rr_out, int* flags, float* hist,
                     Grid g, bool three_d, int nblocks, int check_every,
                     cudaStream_t stream) {
  if (nblocks < 0 || check_every < 1 || region == nullptr)
    return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err = coop_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  const DistGeometry d = dist_geometry(g.n0, g.n1, g.n2, three_d, 1, sms);
  if (!d.fits) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cg1_shard_per_sm(three_d, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < dist_blocks_per_sm(three_d))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  // the partials: the tile walk's two arrays of one slot a tile
  Cg1ShardArgs args{b, x0, x, r0, r1, s0, s1, w0, w1, params, cap,
                    partials, partials + d.tiles, region, rr_out, flags,
                    hist, (int)g.n0, (int)g.n1, (int)g.n2, (int)d.tiles,
                    (int)d.ctas, nblocks, check_every};
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel(
      cg1_shard_fn(three_d), dim3((unsigned)d.ctas), tile_block(three_d),
      kargs, (size_t)dist_slot_bytes(d.tiles_per_cta), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_dist(const float* b, const float* x0, float* x, float* r,
                float* p0, float* p1, float* z2, float* z1,
                const float* params, const int* cap, float* partials,
                char* const* peers, char* region, float* rr_out, int* flags,
                float* hist, Grid g, bool three_d, int n_shards, int nblocks,
                int check_every, int degree, cudaStream_t stream) {
  if (n_shards < 1 || nblocks < 0 || check_every < 1 || degree < 0 ||
      (degree >= 2 && z1 == nullptr) || (degree >= 3 && z2 == nullptr) ||
      (x0 != nullptr && n_shards != 1) ||
      (peers == nullptr && (n_shards != 1 || region == nullptr)))
    return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  cudaError_t err = coop_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  // one geometry (resident_dist.cuh), which the wrapper's gate reads too
  const DistGeometry d = dist_geometry(g.n0, g.n1, g.n2, three_d, n_shards,
                                       sms);
  if (!d.fits) return (int)cudaErrorCooperativeLaunchTooLarge;
  const bool precond = degree > 0;
  err = dist_per_sm(three_d, precond, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < dist_blocks_per_sm(three_d))
    return (int)cudaErrorCooperativeLaunchTooLarge;
  const int64_t tiles = d.tiles, nb = d.ctas;
  const size_t smem = (size_t)dist_slot_bytes(d.tiles_per_cta);
  DistArgs args{b, x0, x, r, p0, p1, z2, z1, params, cap, partials, peers,
                region, rr_out, flags, hist, (int)g.n0, (int)g.n1, (int)g.n2,
                (int)tiles, (int)nb, n_shards, nblocks, check_every, degree};
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel(dist_fn(three_d, precond),
                                    dim3((unsigned)(nb * n_shards)),
                                    tile_block(three_d), kargs, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace cmpt

extern "C" {

// One cooperative launch of the whole distributed solve on `stream`: P =
// n_shards slabs of (n0, n1, n2) that the geometry of resident_dist.cuh
// admits (else cudaErrorCooperativeLaunchTooLarge), stacked in b, x, r and
// p's two planes p0, p1 (and z2 for degree >= 3, z1 for degree >= 2; else
// NULL); params = (scale, tol, rtol, lmin, lmax); partials holds 3 * P *
// tiles floats (the geometry's tiles of a slab); peers is a device array
// of P pointers to zeroed exchange regions of the header's size each;
// rr_out (P floats), flags (4 P ints: iterations, indefinite, converged,
// healthy) and hist (P * (nblocks + 1) floats) are written per shard.
// 2D slabs pass (nx, 1, ny) and three_d = 0.  Returns the launch's
// cudaError_t.
int cmpt_cg_resident_dist(const float* b, float* x, float* r, float* p0,
                          float* p1, float* z2, float* z1,
                          const float* params, const int* cap,
                          float* partials, char* const* peers, float* rr_out,
                          int* flags, float* hist, int64_t n0, int64_t n1,
                          int64_t n2, int three_d, int n_shards, int nblocks,
                          int check_every, int degree, cudaStream_t stream) {
  return cmpt::launch_dist(b, nullptr, x, r, p0, p1, z2, z1, params, cap,
                           partials, peers, nullptr, rr_out, flags, hist,
                           cmpt::Grid{n0, n1, n2}, three_d != 0, n_shards,
                           nblocks, check_every, degree, stream);
}

// Resident CTAs per SM of the 2D/3D, plain/preconditioned B12 instance on
// the current device, at the shared slots of the most tiles a CTA walks
// and at most B10's - what every launch takes - or minus a cudaError_t.
int cmpt_cg_resident_dist_blocks_per_sm(int three_d, int precond) {
  int per_sm = 0;
  const cudaError_t err =
      cmpt::dist_per_sm(three_d != 0, precond != 0, &per_sm);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// Bytes of one shard's exchange region for slabs of plane floats a plane
// and n_shards shards (zeroed before a launch): what a launch allocates.
int64_t cmpt_resident_dist_exchange_bytes(int64_t plane, int n_shards) {
  return cmpt::xch_layout(plane, n_shards).bytes;
}

}  // extern "C"
