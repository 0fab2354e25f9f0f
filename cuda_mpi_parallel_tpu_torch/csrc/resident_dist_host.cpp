// The host side of B12's header (resident_dist.cuh): its exchange region
// and launch geometry as C entries, built by the host's C++ compiler
// (ops/cuda/_build.py host_library), so the wrapper's capacity gate and
// its allocations read the layout and the geometry the kernel compiles,
// on a host with or without a card.
#include "resident_dist.cuh"

extern "C" {

// Bytes of one shard's exchange region for slabs of plane floats per plane
// and n_shards shards (the regions must be zeroed before a launch).
int64_t cmpt_resident_dist_exchange_bytes(int64_t plane, int n_shards) {
  return cmpt::xch_layout(plane, n_shards).bytes;
}

// B12's launch of n_shards slabs of (n0, n1, n2) (2D: (nx, 1, ny)) on a
// card of sms SMs: out = (tiles of a slab, CTAs of a shard, the most tiles
// a CTA walks); returns 1 when the launch runs it, else 0.
int cmpt_resident_dist_geometry(int64_t n0, int64_t n1, int64_t n2,
                                int three_d, int n_shards, int sms,
                                int64_t* out) {
  const cmpt::DistGeometry d =
      cmpt::dist_geometry(n0, n1, n2, three_d != 0, n_shards, sms);
  out[0] = d.tiles;
  out[1] = d.ctas;
  out[2] = d.tiles_per_cta;
  return d.fits ? 1 : 0;
}

}  // extern "C"
