// The slab entry of a ray into an AABB and the group test over the union
// box of an aligned group of cluster blocks: the math of
// `_slab_entry_math`, `_group_entry` and `_group_slab` (ops/walk.py),
// shared by pair_extract.cu (kernel 5) and slab_cull.cu
// (kernel 1).
//
// A ray is its [16] `_ray16` record xr (t0 in xr[6], 1/d in xr[8..10], o/d
// in xr[11..13]). A block or a group is staged as two float4:
// {lo_x, lo_y, lo_z, hi_x} and {hi_y, hi_z, w, 0}, where w is the block's
// r2 (< 0: a sentinel block) or, for a group, 1 when it has a real member
// and -1 when it has none.
//
// Why the group test is conservative in f32 (every block the exact test
// passes lies in a group the group test passes; `_group_entry` in
// ops/walk.py is its plain form, and tests/test_torch_pairs.py and
// chip_smoke.py hold the premise on the calls of kernels 1 and 5). The
// group box [GL, GH] holds every real member's lo and hi on each axis. Per
// axis, t(x) = (x * invd) - oinv, each step rounded, is monotone in x, so
// the group's two values bracket every member's: tmin_g <= tmin_k and
// tmax_g >= tmax_k. The member test widens both by its slack s_k = 1e-6
// |tmin_k| + 1e-5, which is not monotone in the box: a group's tmin_g may
// be smaller in magnitude than a member's. So the group test widens by S =
// slack(B) with B = max(|tmin_g|, |tmax_g| * 1.00001 + 1e-4), which bounds
// |tmin_k| for every member k the exact test passes: if tmin_k <= 0,
// |tmin_k| <= |tmin_g|; if tmin_k > 0, passing needs tmin_k - s_k <= tmax_k
// + s_k (to within rounding), so tmin_k <= |tmax_g| (1 + 2.2e-6) + 2.1e-5 <
// B. The slack's rounding is monotone, so S >= s_k, and then (tmin_g - S)
// <= (tmin_k - s_k) and (tmax_g + S) >= (tmax_k + s_k) after rounding: the
// group's entry is at most the member's, its exit at least the member's,
// and each of the member's three conditions (exit >= entry, exit > 0,
// entry < t0) holds for the group.
//
// Products and sums use __fmul_rn / __fsub_rn / __fadd_rn so that nvcc
// does not contract them into FMAs: the results equal the plain PyTorch
// versions bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace sgroup {

constexpr float kBig = 1e30f;

// Slab parameters of box [lo, hi] along the ray: tmin, tmax.
__device__ __forceinline__ void slab_t(const float* xr, const float* lo, const float* hi,
                                       float& tmin, float& tmax) {
  tmin = -kBig;
  tmax = kBig;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float invd = xr[8 + a];
    const float oinv = xr[11 + a];
    const float tlo = __fsub_rn(__fmul_rn(lo[a], invd), oinv);
    const float thi = __fsub_rn(__fmul_rn(hi[a], invd), oinv);
    tmin = fmaxf(tmin, fminf(tlo, thi));
    tmax = fminf(tmax, fmaxf(tlo, thi));
  }
}

// The group test (the notes above; ops/walk.py _group_entry is its plain
// form): whether the ray may meet a member of the group whose union box is
// staged as {lo_xyz, hi_x}, {hi_y, hi_z, nonempty (1) or empty (-1), 0}.
__device__ __forceinline__ bool meets_group(const float* xr, float4 p, float4 q) {
  if (!(q.z > 0.f)) return false;  // no real member
  const float lo[3] = {p.x, p.y, p.z};
  const float hi[3] = {p.w, q.x, q.y};
  float tmin, tmax;
  slab_t(xr, lo, hi, tmin, tmax);
  const float bnd = fmaxf(fabsf(tmin), __fadd_rn(__fmul_rn(fabsf(tmax), 1.00001f), 1e-4f));
  const float s = __fadd_rn(__fmul_rn(1e-6f, bnd), 1e-5f);
  const float t_in = fmaxf(__fsub_rn(tmin, s), 0.f);
  const float t_out = __fadd_rn(tmax, s);
  return (t_out >= t_in) && (t_out > 0.f) && (t_in < xr[6]);
}

// The union box of the real members among the staged blocks sb[2k],
// sb[2k + 1] for k in [k_begin, k_end), staged at out[0], out[1].
__device__ __forceinline__ void union_box(const float4* sb, int k_begin, int k_end,
                                          float4* out) {
  float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
  bool real = false;
  for (int k = k_begin; k < k_end; ++k) {
    const float4 p = sb[2 * k], q = sb[2 * k + 1];
    if (!(q.z >= 0.f)) continue;  // sentinel block (r2 < 0)
    real = true;
    const float blo[3] = {p.x, p.y, p.z}, bhi[3] = {p.w, q.x, q.y};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], fminf(blo[a], bhi[a]));
      hi[a] = fmaxf(hi[a], fmaxf(blo[a], bhi[a]));
    }
  }
  out[0] = make_float4(lo[0], lo[1], lo[2], hi[0]);
  out[1] = make_float4(hi[1], hi[2], real ? 1.f : -1.f, 0.f);
}

}  // namespace sgroup
