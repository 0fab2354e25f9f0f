// Pieces the resident kernels share (B10/B11 in resident.cu, B12 in
// resident_dist.cu): the breakdown-safe division, the NaN-propagating max,
// the squared convergence threshold of each lane, the per-block partial and
// its fixed-order total, and the Chebyshev interval's scalars.  One
// definition, so the kernels round every scalar alike and B12 at one shard
// takes B10's bits.  Also the entries of B12's body that B10 launches, and
// of the cg1 form's one-barrier body beside it.
#pragma once

#include <math.h>

#include "common.cuh"

namespace cmpt {

template <typename T>
__device__ __forceinline__ T safe_div(T num, T den) {
  return (num == T(0) && den == T(0)) ? T(0) : div_rn(num, den);
}

// max that propagates NaN, as jnp.maximum / torch.maximum do
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ double max_nan(double a, double b) {
  return (isnan(a) || isnan(b)) ? __longlong_as_double(0x7ff8000000000000LL)
                                : fmax(a, b);
}

// The squared convergence threshold from ||r0||^2.  f32 (solver.cg):
// max(tol, rtol * sqrt(rr0))^2; f64 (solver.df64._threshold):
// max(tol^2, rtol^2 * rr0).
__device__ __forceinline__ float threshold2(float tol, float rtol,
                                            float rr0) {
  const float t = max_nan(tol, mul_rn(rtol, __fsqrt_rn(rr0)));
  return mul_rn(t, t);
}
__device__ __forceinline__ double threshold2(double tol, double rtol,
                                             double rr0) {
  return max_nan(mul_rn(tol, tol), mul_rn(mul_rn(rtol, rtol), rr0));
}

// This block's partial into slot `slot` of part.
template <typename T>
__device__ __forceinline__ void put_partial_at(T* part, int64_t slot, T v) {
  v = block_sum(v);
  if (threadIdx.x == 0 && threadIdx.y == 0) __stcg(part + slot, v);
}

// This block's partial into its own slot.
template <typename T>
__device__ __forceinline__ void put_partial(T* part, T v) {
  put_partial_at(part, (int64_t)blockIdx.x, v);
}

// The sum of all n partials, in one fixed order, broadcast to every thread:
// the same code on the same slots, so every block gets the same bits.
template <typename T>
__device__ __forceinline__ T grid_total(const T* part, int n) {
  __shared__ T total;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  T v = T(0);
  for (int i = tid; i < n; i += nt) v = add_rn(v, __ldcg(part + i));
  v = block_sum(v);
  if (tid == 0) total = v;
  __syncthreads();
  return total;
}

// B12's body (resident_dist.cu), on which B10's f32 solves run at one
// shard (resident.cu's cmpt_cg_resident): its launch, and the CTAs per SM
// of its instance at the slots of the most tiles a CTA walks; and the
// one-barrier body of B10's cg1 form on the same machinery
// (cmpt_cg_resident_cg1), its launch and its CTAs per SM.
int launch_dist(const float* b, const float* x0, float* x, float* r,
                float* p0, float* p1, float* z2, float* z1,
                const float* params, const int* cap, float* partials,
                char* const* peers, char* region, float* rr_out, int* flags,
                float* hist, Grid g, bool three_d, int n_shards, int nblocks,
                int check_every, int degree, cudaStream_t stream);
cudaError_t dist_per_sm(bool three_d, bool precond, int* per_sm);
int launch_cg1_shard(const float* b, const float* x0, float* x, float* r0,
                     float* r1, float* s0, float* s1, float* w0, float* w1,
                     const float* params, const int* cap, float* partials,
                     char* region, float* rr_out, int* flags, float* hist,
                     Grid g, bool three_d, int nblocks, int check_every,
                     cudaStream_t stream);
cudaError_t cg1_shard_per_sm(bool three_d, int* per_sm);

// The Chebyshev interval's scalars (_resident_kernel's precond()).
template <typename T>
struct Cheb {
  T theta, delta, sigma;
};

// f32 lane: from the interval [lmin, lmax] (models.precond).
__device__ __forceinline__ Cheb<float> cheb_of(float lmin, float lmax) {
  Cheb<float> c;
  c.theta = mul_rn(add_rn(lmax, lmin), 0.5f);
  c.delta = mul_rn(sub_rn(lmax, lmin), 0.5f);
  c.sigma = div_rn(c.theta, c.delta);
  return c;
}
// f64 lane: the centre and half-width themselves
// (solver.df64.chebyshev_interval).
__device__ __forceinline__ Cheb<double> cheb_of(double theta, double delta) {
  Cheb<double> c;
  c.theta = theta;
  c.delta = delta;
  c.sigma = div_rn(theta, delta);
  return c;
}

}  // namespace cmpt
