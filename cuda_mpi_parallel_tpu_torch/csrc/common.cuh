// Shared pieces of the port's Hopper kernels: grid geometry, the tile
// walk every kernel uses, rounding-pinned arithmetic and the fixed-order
// block reduction, each for float and double (the f64 lane's kernels are
// the f32 kernels instantiated with T = double).
//
// Geometry.  A 3D grid (nx, ny, nz) is walked as (n0, n1, n2) =
// (nx, ny, nz); a 2D grid (nx, ny) as (n0, n1, n2) = (nx, 1, ny), so one
// kernel body serves both and the 2D form simply has no y-neighbours.
// A block covers a tile of kPlanes planes along n0, blockDim.y rows along
// n1 and blockDim.x contiguous columns along n2 (threads of a warp sit on
// neighbouring addresses).  Each thread walks its column of kPlanes
// points along n0 (walk_column below); a persistent kernel's block walks
// tiles blockIdx.x, blockIdx.x + gridDim.x, ...  Offsets are int64: a 46341^2
// grid already overflows int32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cmpt {

constexpr int kPlanes = 8;        // points each thread walks along n0
constexpr int kSumThreads = 1024; // threads of the partial-sum kernel

struct Grid {
  int64_t n0, n1, n2;
};

inline dim3 tile_block(bool three_d) {
  // 3D: 32 columns x 8 rows; 2D (n1 == 1): 256 columns of one row
  return three_d ? dim3(32, 8, 1) : dim3(256, 1, 1);
}

inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Number of blocks the tile walk launches (also the number of per-block
// partial sums a reducing kernel writes).  -1 when it exceeds the launch
// limit of gridDim.x.
inline int64_t tile_blocks(Grid g, bool three_d) {
  dim3 b = tile_block(three_d);
  int64_t n = ceil_div(g.n0, kPlanes) * ceil_div(g.n1, b.y) *
              ceil_div(g.n2, b.x);
  return n > 0x7fffffffLL ? -1 : n;
}

// Where this thread's column starts: plane i0, row j, column k.
struct Tile {
  int64_t i0, j, k;
};

// Tile number b of the walk (a block of a one-pass kernel walks tile
// blockIdx.x; a persistent block walks several).
__device__ __forceinline__ Tile tile_of(Grid g, int64_t b) {
  int64_t t2n = (g.n2 + blockDim.x - 1) / blockDim.x;
  int64_t t1n = (g.n1 + blockDim.y - 1) / blockDim.y;
  int64_t t2 = b % t2n;
  b /= t2n;
  int64_t t1 = b % t1n;
  int64_t t0 = b / t1n;
  Tile t;
  t.i0 = t0 * kPlanes;
  t.j = t1 * blockDim.y + threadIdx.y;
  t.k = t2 * blockDim.x + threadIdx.x;
  return t;
}

// The plain PyTorch twins round every product and every sum on its own.
// nvcc would contract a * b + c into one FMA; the _rn intrinsics are
// never contracted, so kernel and twin round alike.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// The Laplacian term of one point, in the JAX kernels' order:
// (c * mid - xm - xp [- ym - yp] - zm - zp), c = 6 in 3D and 4 in 2D.
template <typename T, bool THREE_D>
__device__ __forceinline__ T laplacian(T mid, T xm, T xp, T ym, T yp, T zm,
                                       T zp) {
  T acc = sub_rn(mul_rn(T(THREE_D ? 6 : 4), mid), xm);
  acc = sub_rn(acc, xp);
  if (THREE_D) {
    acc = sub_rn(acc, ym);
    acc = sub_rn(acc, yp);
  }
  acc = sub_rn(acc, zm);
  return sub_rn(acc, zp);
}

// The tile walk.  For each point of this thread's column it calls
// visit(o, u, lap): o the point's offset, u = load(o), lap the Laplacian
// term of load() over the point and its neighbours, read as zero outside
// the grid (Dirichlet edges).  The column's previous/current/next values
// stay in registers; the in-plane neighbours are loaded again (L1/L2
// serve the reuse).  Threads that fall outside the grid visit nothing.
// walk_column_edges is the walk with the planes just outside the grid along
// n0 given by lo(c) and hi(c) (c the point's in-plane offset) instead of
// zero: a slab of a row-partitioned grid with its neighbours' edge planes
// as halos.  walk_column is walk_column_edges with zero edges.
// walk_column_ix is walk_column_edges calling visit(o, i, c, u, lap) with
// the point's plane i and in-plane offset c too.
template <typename T, bool THREE_D, typename Load, typename Lo, typename Hi,
          typename Visit>
__device__ __forceinline__ void walk_column_ix(Grid g, int64_t tile,
                                               Load load, Lo lo, Hi hi,
                                               Visit visit) {
  const Tile t = tile_of(g, tile);
  if (t.j >= g.n1 || t.k >= g.n2 || t.i0 >= g.n0) return;
  const int64_t s0 = g.n1 * g.n2, s1 = g.n2;
  const int64_t col = t.j * s1 + t.k;
  const bool has_ym = t.j > 0, has_yp = t.j + 1 < g.n1;
  const bool has_zm = t.k > 0, has_zp = t.k + 1 < g.n2;
  const int64_t iend = t.i0 + kPlanes < g.n0 ? t.i0 + kPlanes : g.n0;

  T prev = t.i0 > 0 ? load((t.i0 - 1) * s0 + col) : lo(col);
  T cur = load(t.i0 * s0 + col);
  for (int64_t i = t.i0; i < iend; ++i) {
    const int64_t o = i * s0 + col;
    const T next = i + 1 < g.n0 ? load(o + s0) : hi(col);
    T ym = T(0), yp = T(0);
    if (THREE_D) {
      ym = has_ym ? load(o - s1) : T(0);
      yp = has_yp ? load(o + s1) : T(0);
    }
    const T zm = has_zm ? load(o - 1) : T(0);
    const T zp = has_zp ? load(o + 1) : T(0);
    visit(o, i, col, cur,
          laplacian<T, THREE_D>(cur, prev, next, ym, yp, zm, zp));
    prev = cur;
    cur = next;
  }
}

template <typename T, bool THREE_D, typename Load, typename Lo, typename Hi,
          typename Visit>
__device__ __forceinline__ void walk_column_edges(Grid g, int64_t tile,
                                                  Load load, Lo lo, Hi hi,
                                                  Visit visit) {
  walk_column_ix<T, THREE_D>(
      g, tile, load, lo, hi,
      [&](int64_t o, int64_t, int64_t, T u, T lap) { visit(o, u, lap); });
}

template <typename T, bool THREE_D, typename Load, typename Visit>
__device__ __forceinline__ void walk_column(Grid g, int64_t tile, Load load,
                                            Visit visit) {
  const auto zero = [](int64_t) { return T(0); };
  walk_column_edges<T, THREE_D>(g, tile, load, zero, zero, visit);
}

// The walk of tile blockIdx.x: what a one-pass kernel's block covers.
template <typename T, bool THREE_D, typename Load, typename Visit>
__device__ __forceinline__ void walk_column(Grid g, Load load, Visit visit) {
  walk_column<T, THREE_D>(g, (int64_t)blockIdx.x, load, visit);
}

// The points of this thread's column in tile number `tile`, without the
// neighbours: visit(o, i, c) for each (plane i, in-plane offset c), in the
// order walk_column visits them, so a thread owns the same points in both.
template <typename Visit>
__device__ __forceinline__ void points_ix(Grid g, int64_t tile,
                                          Visit visit) {
  const Tile t = tile_of(g, tile);
  if (t.j >= g.n1 || t.k >= g.n2 || t.i0 >= g.n0) return;
  const int64_t s0 = g.n1 * g.n2, col = t.j * g.n2 + t.k;
  const int64_t iend = t.i0 + kPlanes < g.n0 ? t.i0 + kPlanes : g.n0;
  for (int64_t i = t.i0; i < iend; ++i) visit(i * s0 + col, i, col);
}

// points_ix calling visit(o) alone.
template <typename Visit>
__device__ __forceinline__ void for_each_point(Grid g, int64_t tile,
                                               Visit visit) {
  points_ix(g, tile, [&](int64_t o, int64_t, int64_t) { visit(o); });
}

// Sum of v over the block, in a fixed order: a shuffle tree inside each
// warp, then the same tree over the warp sums.  The result is valid in
// thread 0.  Every thread of the block must call it.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[32];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y + 31) / 32;
  __syncthreads();  // a previous call may still be reading warp_sums
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  if (tid < 32) {
    v = tid < nwarps ? warp_sums[tid] : T(0);
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

}  // namespace cmpt
