// The bounding-sphere entry bound of one ray into one cluster block: the
// math of `_entry_math` in kdtreepathtraceroptimization_tpu_torch/ops/
// cluster.py, shared by cluster_cull.cu (kernel 9) and binned_argmin.cu
// (kernel 12); and the test of one ray against the bounding sphere of an
// aligned group of blocks, which kernel 9 runs before the member tests
// (`_group_sphere` and `_group_sphere_entry` in ops/cluster.py are its
// plain form).
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

// ---------------------------------------------------------------------------
// Group spheres
//
// A group is an aligned run of blocks (a subtree of the cluster table's
// tree: ops/cluster.py _kd_leaf_order). Its sphere (C, R) holds every real
// member's: R >= |c_k - C| + rb_k with rb_k = max(radius_k, sqrt(r2_k)).
// It is built in f64 (`group_sphere`) and staged as {C, R}, {CC, CR,
// nonempty (1) or empty (-1), 0}: CC = |C|^2 summed as the member's cc,
// CR >= |C| + R (both bounds rounded up to f32). The group test runs the
// member's own formula on (C, R) and widens it by margins that grow with
// the scene's scale S = |o| + |C| + R (>= |o| + |c_k| for every member).
//
// Why it is conservative (every block whose `bound` is below BIG lies in a
// group whose `group_bound` is below BIG, with an entry no later than the
// member's; tests/test_torch_cluster.py and chip_smoke.py hold it on the
// cluster and binned paths' calls and on adversarial rays). Write u =
// 2^-24, s = |d|, delta = |d|^2 - 1, v = c - o, T(c) = d.v (what t_ca
// computes), Q(c) = |v|^2 - T(c)^2 (what dline2 computes), and for the line
// o + t d / s the distance rho(c) and the parameter tau(c) = T(c) / s, so
// that Q(c) = rho(c)^2 - delta tau(c)^2.
//
//   Rounding. With the standard model (each rounded op exact times (1 +
//   e), |e| <= u; products and sums unfused; cc within 3u |c|^2 of |c|^2,
//   as numpy's f32 sum and dot3 make it), the computed t_ca is within E_t
//   = 4.0001 u s S of T, and the computed dline2 within E_D = 16 u m S^2 of
//   Q, m = max(1, |d|^2): 3u S^2 from cc, 2 o.c and |o|^2, u S^2 from each
//   of the two sums, 9u s^2 S^2 from t_ca^2 (its error doubled, plus its
//   own rounding) and u m S^2 from the last subtraction. The same holds
//   for the group's own (t_G, dline2_G), with |o| + |C| <= S.
//   Distance. A member passes dline2 <= r2 only if rho_k^2 <= rb_k^2 + E_D
//   + |delta| |v|^2, so rho_k <= rb_k + w S with w = sqrt(16 u m +
//   |delta|). By the triangle inequality rho_G <= rho_k + |c_k - C| <= R +
//   w S, and the group's computed dline2_G <= rho_G^2 + |delta| |v_G|^2 +
//   E_D <= (R + w S)^2 + (w S)^2 <= (R + 2 w S)^2. The test takes
//   dline2_G <= (R + w2 S)^2 with w2 = 2.01 sqrt(17 u m + db), db = |fl(|d|^2)
//   - 1| + 4 u m >= |delta|: the extra 0.5% of w2 S (>= 8e-6 S, since w >=
//   2^-10) covers the few roundings of the margin itself (a few u of R + S).
//   Behind. A member passes t_ca + radius > 0 only if T(c_k) > -radius_k -
//   E_t; |T(C) - T(c_k)| <= s |c_k - C| and |s - 1| <= |delta|, so t_G + R >
//   -(E_t + E_t,G + |delta| R). The test adds M = mu S with mu = 2 (db +
//   16 u m), which also covers the rounding of t_G + R (u (s S + R)).
//   Entry. Likewise t_G - R - M <= t_ca - radius - (M - E_t - E_t,G -
//   |delta| R), and M also covers the roundings of (t_G - R) - M and of the
//   member's t_ca - radius (together under 3u (s + 1) S): so
//   max((t_G - R) - M, 0) <= max(t_ca - radius, 0) < t0.
//   So the group passes wherever a member does. Subnormal underflow is
//   left out (the scene's scale is far above it). The argument assumes the
//   table's two centre halves and cc agree with blk's centres, as
//   build_cluster_mesh makes them.
// ---------------------------------------------------------------------------

constexpr float kU = 5.9604645e-08f;  // 2^-24

// One ray's margin factors for the group test, computed once per ray.
struct GroupMargins {
  float w2, mu, on;  // the distance factor, the t factor, |o| rounded up
};

__device__ __forceinline__ GroupMargins group_margins(const Ray& r) {
  const float dd = dot3(r.d[0], r.d[1], r.d[2], r.d[0], r.d[1], r.d[2]);
  const float m = fmaxf(dd, 1.f);
  const float db = __fadd_rn(fabsf(__fsub_rn(dd, 1.f)), __fmul_rn(4.f * kU, m));
  GroupMargins g;
  g.w2 = __fmul_rn(2.01f, __fsqrt_rn(__fadd_rn(__fmul_rn(17.f * kU, m), db)));
  g.mu = __fmul_rn(2.f, __fadd_rn(db, __fmul_rn(16.f * kU, m)));
  g.on = __fmul_rn(__fsqrt_rn(r.oo), 1.000001f);
  return g;
}

// The group sphere of the real members among blocks [k_begin, k_end) of
// the tables (load_block's columns: d.c weights as the centre, radius, r2),
// staged at out[0] = {C, R}, out[1] = {CC, CR, 1 or -1, 0}. In f64, each
// op rounded on its own, as `_group_sphere` in ops/cluster.py.
__device__ __forceinline__ void group_sphere(const float* __restrict__ cull_w,
                                             const float* __restrict__ blk, int kp,
                                             int k_begin, int k_end, float4* out) {
  const int w2 = 2 * kp;
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  bool real = false;
  for (int k = k_begin; k < k_end; ++k) {
    const float r2 = blk[5 * kp + k];
    if (!(r2 >= 0.f)) continue;  // sentinel block
    real = true;
    const double rb = fmax((double)blk[3 * kp + k], __dsqrt_rn((double)r2));
    for (int a = 0; a < 3; ++a) {
      const double c = cull_w[(3 + a) * w2 + k];
      lo[a] = fmin(lo[a], __dsub_rn(c, rb));
      hi[a] = fmax(hi[a], __dadd_rn(c, rb));
    }
  }
  if (!real) {
    out[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    out[1] = make_float4(0.f, 0.f, -1.f, 0.f);
    return;
  }
  float cf[3];
  for (int a = 0; a < 3; ++a) cf[a] = __double2float_rn(__dmul_rn(0.5, __dadd_rn(lo[a], hi[a])));
  double rmax = 0.0;
  for (int k = k_begin; k < k_end; ++k) {
    const float r2 = blk[5 * kp + k];
    if (!(r2 >= 0.f)) continue;
    const double rb = fmax((double)blk[3 * kp + k], __dsqrt_rn((double)r2));
    double q = 0.0;
    for (int a = 0; a < 3; ++a) {
      const double e = __dsub_rn((double)cull_w[(3 + a) * w2 + k], (double)cf[a]);
      q = __dadd_rn(q, __dmul_rn(e, e));
    }
    rmax = fmax(rmax, __dadd_rn(__dsqrt_rn(q), rb));
  }
  constexpr double kUp = 1.0 + 0x1p-30;  // covers the f64 roundings above
  const float R = __double2float_ru(__dmul_rn(rmax, kUp));
  double cc = 0.0;
  for (int a = 0; a < 3; ++a) cc = __dadd_rn(cc, __dmul_rn((double)cf[a], (double)cf[a]));
  const float cr = __double2float_ru(__dmul_rn(__dadd_rn(__dsqrt_rn(cc), (double)R), kUp));
  out[0] = make_float4(cf[0], cf[1], cf[2], R);
  out[1] = make_float4(dot3(cf[0], cf[1], cf[2], cf[0], cf[1], cf[2]), cr, 1.f, 0.f);
}

// The group test (the notes above): the group's widened entry bound, BIG
// where the ray can meet no member. `g` is group_sphere's staging.
__device__ __forceinline__ float group_bound(const Ray& r, const GroupMargins& m,
                                             float4 g0, float4 g1) {
  const float p1 = dot3(r.d[0], r.d[1], r.d[2], g0.x, g0.y, g0.z);  // d.C
  const float p2 = dot3(r.o[0], r.o[1], r.o[2], g0.x, g0.y, g0.z);  // o.C
  const float R = g0.w, cc = g1.x;
  const float t_ca = __fsub_rn(p1, r.od);
  const float dline2 =
      __fsub_rn(__fadd_rn(__fsub_rn(cc, __fmul_rn(2.f, p2)), r.oo), __fmul_rn(t_ca, t_ca));
  const float S = __fadd_rn(m.on, g1.y);
  const float X = __fadd_rn(R, __fmul_rn(m.w2, S));
  const float M = __fmul_rn(m.mu, S);
  const float e = fmaxf(__fsub_rn(__fsub_rn(t_ca, R), M), 0.f);
  const bool pass = (g1.z > 0.f) && (dline2 <= __fmul_rn(X, X)) &&
                    (__fadd_rn(__fadd_rn(t_ca, R), M) > 0.f) && (e < r.t0) && r.live;
  return pass ? e : kBig;
}

}  // namespace entry

