// The bounding-sphere entry bound of one ray into one cluster block: the
// math of `_entry_math` in kdtreepathtraceroptimization_tpu_torch/ops/
// cluster.py, shared by cluster_cull.cu (kernel 9) and binned_argmin.cu
// (kernel 12).
//
// A ray record x is [o, d, t0, act] (ops/cluster.py). The block table
// gives each block k its centre c (the columns of cull_w: rows 3-5 of
// column k for d.c, rows 0-2 of column kp + k for o.c), radius, |c|^2 and
// r^2 (rows 3-5 of blk; r^2 = -1 marks a sentinel block). Then
//   t_ca   = d.c - o.d          (ray parameter of the closest approach)
//   dline2 = |c|^2 - 2 o.c + |o|^2 - t_ca^2
//   entry  = max(t_ca - radius, 0)
// and the pair is feasible when dline2 <= r^2, t_ca + radius > 0,
// entry < t0, the ray is live and the block is real; else the bound is BIG.
//
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn), three-term dot products summed left to right, so that nvcc
// contracts nothing into an FMA and the kernels equal the plain PyTorch
// version bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace entry {

constexpr float kBig = 1e30f;
constexpr int kBlockFloats = 9;  // staged per block: c (d.c), c (o.c), radius, cc, r2

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// One ray's quantities, read once from its [8] record.
struct Ray {
  float o[3], d[3];
  float t0, od, oo;
  bool live;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ row) {
  Ray r;
  for (int a = 0; a < 3; ++a) {
    r.o[a] = row[a];
    r.d[a] = row[3 + a];
  }
  r.t0 = row[6];
  r.live = row[7] > 0.f;
  r.od = dot3(r.o[0], r.o[1], r.o[2], r.d[0], r.d[1], r.d[2]);
  r.oo = dot3(r.o[0], r.o[1], r.o[2], r.o[0], r.o[1], r.o[2]);
  return r;
}

// Block k's nine staged floats from the [8, 2kp] cull_w and [8, kp] blk
// tables, into b[0..8]: the d.c weights, the o.c weights, radius, cc, r2.
__device__ __forceinline__ void load_block(const float* __restrict__ cull_w,
                                           const float* __restrict__ blk, int kp, int k,
                                           float* b) {
  const int w2 = 2 * kp;
  for (int a = 0; a < 3; ++a) {
    b[a] = cull_w[(3 + a) * w2 + k];
    b[3 + a] = cull_w[a * w2 + kp + k];
  }
  b[6] = blk[3 * kp + k];
  b[7] = blk[4 * kp + k];
  b[8] = blk[5 * kp + k];
}

// The entry bound of ray `r` into the block with staged floats `b`.
__device__ __forceinline__ float bound(const Ray& r, const float* b) {
  const float p1 = dot3(r.d[0], r.d[1], r.d[2], b[0], b[1], b[2]);  // d.c
  const float p2 = dot3(r.o[0], r.o[1], r.o[2], b[3], b[4], b[5]);  // o.c
  const float radius = b[6], cc = b[7], r2 = b[8];
  const float t_ca = __fsub_rn(p1, r.od);
  const float dline2 =
      __fsub_rn(__fadd_rn(__fsub_rn(cc, __fmul_rn(2.f, p2)), r.oo), __fmul_rn(t_ca, t_ca));
  const float e = fmaxf(__fsub_rn(t_ca, radius), 0.f);
  const bool feasible = (dline2 <= r2) && (__fadd_rn(t_ca, radius) > 0.f) && (e < r.t0) &&
                        r.live && (r2 >= 0.f);
  return feasible ? e : kBig;
}

}  // namespace entry
