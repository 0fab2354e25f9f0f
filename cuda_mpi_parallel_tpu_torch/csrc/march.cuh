// The launch geometry of the plane-marching passes B3 and B4
// (pass_a_march and pass_b_march in fused_cg.cu): the tile a block owns,
// the run of planes it marches, and which part of the grid each block
// takes.  The launches, the kernels' own blockIdx split and the C entry
// cmpt_march_blocks (which sizes the wrapper's partials for both passes)
// all read it from here, and only fused_cg.cu includes it.  Apart from
// the __host__ __device__ marks it is plain C++, so a host compiler builds
// it too (the CPU tests hold its cover of the grid that way).
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define CMPT_HD __host__ __device__
#else
#define CMPT_HD
#endif

namespace cmpt {

// Tile of one block: BY rows x TX columns, each thread owning PTS columns
// BX apart in its row.  A shared plane holds the tile with RY ring rows
// above and below and PAD columns on each side, so that every 16-byte
// chunk of a row starts on a 16-byte boundary when n2 % 4 == 0 (of the
// PAD columns only the one beside the tile is read).
template <bool THREE_D>
struct MarchTile {
  static constexpr int BX = THREE_D ? 32 : 256;  // threads along n2
  static constexpr int BY = THREE_D ? 8 : 1;     // threads (= rows) along n1
  static constexpr int PTS = 2;                  // columns a thread owns
  static constexpr int TX = BX * PTS;            // tile columns
  static constexpr int RY = THREE_D ? 1 : 0;     // ring rows on each side
  static constexpr int PAD = 4;                  // columns on each side
  static constexpr int SW = TX + 2 * PAD;        // shared row width
  static constexpr int SH = BY + 2 * RY;         // shared rows
  static constexpr int CELLS = SW * SH;
  static constexpr int USED = SH * (TX + 2);     // cells the stencil reads
  static constexpr int THREADS = BX * BY;
};

// About two waves of four 256-thread blocks on each of an H100's 132 SMs.
constexpr int64_t kMarchTargetBlocks = 1024;
// The shortest run: the two edge planes a block forms again cost 2 / 8.
constexpr int64_t kMarchMinRun = 8;

CMPT_HD inline int64_t march_ceil(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// Runs of `run` planes along n0 x t1 tiles along n1 x t2 tiles along n2,
// one block each.  Nothing but the grid decides it, so the per-block
// partials, and the sums, repeat bit for bit.  blocks is 0 for an empty
// grid or one that needs more blocks than one launch allows.
struct MarchGeometry {
  int64_t run, t1, t2, blocks;
};

template <bool THREE_D>
inline MarchGeometry march_geometry(int64_t n0, int64_t n1, int64_t n2) {
  using M = MarchTile<THREE_D>;
  if (n0 < 1 || n1 < 1 || n2 < 1) return {1, 0, 0, 0};
  const int64_t t1 = march_ceil(n1, M::BY), t2 = march_ceil(n2, M::TX);
  int64_t run = march_ceil(n0 * t1 * t2, kMarchTargetBlocks);
  run = run < kMarchMinRun ? kMarchMinRun : run;
  run = run < n0 ? run : n0;
  const int64_t blocks = march_ceil(n0, run) * t1 * t2;
  return {run, t1, t2, blocks > 0x7fffffffLL ? 0 : blocks};
}

inline MarchGeometry march_geometry(int64_t n0, int64_t n1, int64_t n2,
                                    bool three_d) {
  return three_d ? march_geometry<true>(n0, n1, n2)
                 : march_geometry<false>(n0, n1, n2);
}

// The part of the grid block b owns: planes [i0, i1), rows [j0, j1),
// columns [k0, k1).  It takes tile b % t2 along n2, b / t2 % t1 along n1
// and run b / (t1 * t2).
struct MarchBlock {
  int64_t i0, i1, j0, j1, k0, k1;
};

template <bool THREE_D>
CMPT_HD inline MarchBlock march_block(int64_t b, int64_t n0, int64_t n1,
                                      int64_t n2, MarchGeometry m) {
  using M = MarchTile<THREE_D>;
  const int64_t i0 = b / (m.t1 * m.t2) * m.run;
  const int64_t j0 = b / m.t2 % m.t1 * M::BY;
  const int64_t k0 = b % m.t2 * M::TX;
  return {i0, i0 + m.run < n0 ? i0 + m.run : n0,
          j0, j0 + M::BY < n1 ? j0 + M::BY : n1,
          k0, k0 + M::TX < n2 ? k0 + M::TX : n2};
}

}  // namespace cmpt
