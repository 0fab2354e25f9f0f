// The exchange region and the launch geometry of B12 (resident_dist.cu).
// The region of one shard holds its neighbours' edge planes and their
// flags, its own copy of their p edge planes, the dot rows of every shard
// and the shard's barrier.  The geometry says how many CTAs a shard takes
// and how many tiles each walks, and whether a launch can run a slab at
// all.  The kernel, its launch and the wrapper's capacity gate all take
// both from here: the gate through resident_dist_host.cpp, which the
// host's C++ compiler builds, so it decides the same with or without a
// card.  Apart from the __host__ __device__ marks this is plain C++.
#pragma once

#include <stdint.h>

#ifndef CMPT_HD
#ifdef __CUDACC__
#define CMPT_HD __host__ __device__
#else
#define CMPT_HD
#endif
#endif

namespace cmpt {

// Offsets in bytes from the start of a region, for slabs of `plane`
// floats a plane and n_shards shards.
struct XchLayout {
  int64_t plane;
  int64_t halo;   // float [2 parity][2 side][plane]: the neighbours' z edges
  int64_t phalo;  // float [2 side][plane]: p's neighbour edges, kept here
  int64_t dots;   // u64 [2 parity][n_shards sender][2]: the dot rows, each
                  // value's bits in the low half and its tag in the high
  int64_t hflag;  // unsigned [2 parity][2 side]
  int64_t bar;    // unsigned long long arrivals, then unsigned generation
  int64_t bytes;  // the whole region, a multiple of 256
  int n_shards;
};

// Side 0 is the plane above the slab (from shard s - 1), side 1 the plane
// below it (from shard s + 1).
CMPT_HD inline XchLayout xch_layout(int64_t plane, int n_shards) {
  XchLayout l;
  l.plane = plane;
  l.n_shards = n_shards;
  int64_t off = 0;
  l.halo = off;
  off += 4 * plane * (int64_t)sizeof(float);
  l.phalo = off;
  off += 2 * plane * (int64_t)sizeof(float);
  off = (off + 7) / 8 * 8;
  l.dots = off;
  off += 4 * (int64_t)n_shards * (int64_t)sizeof(unsigned long long);
  l.hflag = off;
  off += 4 * (int64_t)sizeof(unsigned);
  off = (off + 15) / 16 * 16;
  l.bar = off;
  off += 16;
  l.bytes = (off + 255) / 256 * 256;
  return l;
}

// Where each field's entry starts (bytes from the region's start).
CMPT_HD inline int64_t xch_halo(const XchLayout& l, int parity, int side) {
  return l.halo + ((int64_t)parity * 2 + side) * l.plane * 4;
}
CMPT_HD inline int64_t xch_phalo(const XchLayout& l, int side) {
  return l.phalo + (int64_t)side * l.plane * 4;
}
CMPT_HD inline int64_t xch_dots(const XchLayout& l, int parity, int sender) {
  return l.dots + ((int64_t)parity * l.n_shards + sender) * 2 * 8;
}
CMPT_HD inline int64_t xch_hflag(const XchLayout& l, int parity, int side) {
  return l.hflag + ((int64_t)parity * 2 + side) * 4;
}
CMPT_HD inline int64_t xch_arrivals(const XchLayout& l) { return l.bar; }
CMPT_HD inline int64_t xch_generation(const XchLayout& l) { return l.bar + 8; }

// B12 walks a slab in common.cuh's tiles (tile_blocks), as B10 walks its
// grid: kDistPlanes planes of 256 columns (2D) or of 8 rows of 32 columns
// (3D), one column a thread of a CTA of kDistThreads.
constexpr int kDistPlanes = 8;
constexpr int kDistThreads = 256;

// CTAs per SM: B10's f32 bound (resident.cu), for the registers and for
// the grid.  A launch takes exactly these, so at one shard the grid, and
// with it the order of every sum, is B10's.
CMPT_HD constexpr int dist_blocks_per_sm(bool three_d) {
  return three_d ? 2 : 4;
}

// Dynamic shared memory of a CTA that walks `tiles` tiles: for each point
// a slot for its Ap (then its Chebyshev d) and one for its x.
CMPT_HD constexpr int64_t dist_slot_bytes(int64_t tiles) {
  return 2 * tiles * kDistPlanes * kDistThreads * (int64_t)sizeof(float);
}

// The most tiles a CTA walks: as many slots as fit beside the other CTAs
// of its SM in an H100's 228 KB (1 KB reserved a CTA, under 1 KB of static
// shared memory): 2D 3 (48 KB, four CTAs), 3D 7 (112 KB, two).
CMPT_HD constexpr int dist_max_tiles(bool three_d) { return three_d ? 7 : 3; }

struct DistGeometry {
  int64_t tiles;  // of one slab
  int64_t ctas;   // of one shard: B10's CTAs per SM divided evenly over
                  // the shards, at most one a tile
  int64_t tiles_per_cta;  // the most a CTA walks
  bool fits;      // the launch runs it: its tiles fit the CTAs' slots and
                  // the slab holds fewer than 2^31 points
};

// The launch of n_shards slabs of (n0, n1, n2) (2D: (nx, 1, ny)) on a
// card of `sms` SMs.
CMPT_HD inline DistGeometry dist_geometry(int64_t n0, int64_t n1, int64_t n2,
                                          bool three_d, int n_shards,
                                          int sms) {
  DistGeometry d{0, 0, 0, false};
  if (n0 < 1 || n1 < 1 || n2 < 1 || n_shards < 1 || sms < 1 ||
      n1 > INT32_MAX / n2 || n0 > INT32_MAX / (n1 * n2))
    return d;
  const int64_t bx = three_d ? 32 : 256, by = three_d ? 8 : 1;
  d.tiles = (n0 + kDistPlanes - 1) / kDistPlanes * ((n1 + by - 1) / by) *
            ((n2 + bx - 1) / bx);
  d.ctas = (int64_t)dist_blocks_per_sm(three_d) * sms / n_shards;
  if (d.ctas > d.tiles) d.ctas = d.tiles;
  if (d.ctas < 1) return d;
  d.tiles_per_cta = (d.tiles + d.ctas - 1) / d.ctas;
  d.fits = d.tiles_per_cta <= dist_max_tiles(three_d);
  return d;
}

}  // namespace cmpt
