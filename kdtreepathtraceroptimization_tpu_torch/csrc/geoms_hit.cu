// Nearest hit of N rays against every analytic geom (cubes and spheres).
//
// No TPU twin: the JAX package computes this with jnp alone. Plain
// version: `_intersect_geoms_plain` in
// kdtreepathtraceroptimization_tpu_torch/ops/intersect.py, which launches
// about 250 [N] elementwise kernels a geom. This kernel gives its results
// bit for bit: it applies the same float32 operations in the same order,
// each rounded on its own (no FMA contraction: __fmul_rn, __fadd_rn),
// with IEEE division and square root, and with torch.minimum /
// torch.maximum's NaN propagation, which fminf / fmaxf lack.
//
// Bound on this card: bytes. A lane reads 24 B of ray and writes 33 B of
// hit; its arithmetic is under 1e3 flops even with 16 geoms. Design: one
// thread a lane keeps the ray and its best hit in registers and runs the
// geom loop inside the thread; every thread of the grid reads the same
// geom at the same time, so the table travels in the kernel's parameters
// (read through the constant cache) and a call needs no host-to-device
// copy. A geom's type is uniform across the grid, so its branch does not
// diverge. Scenes of more than kMaxGeoms geoms take one launch a chunk;
// every launch but the first starts from the best hit the outputs hold.

#include <cuda_runtime.h>

constexpr int kMaxGeoms = 16;  // MAX_GEOMS in ops/intersect.py

// The entry point's two structs stay outside the unnamed namespace, so that
// the entry point keeps external linkage.

// One chunk of the scene's geoms, rows 0-2 of each 4x4 matrix, float32.
struct GeomTable {
  int count;
  int type[kMaxGeoms];
  int material[kMaxGeoms];
  float inv[kMaxGeoms][12];   // inverse transform, 3 rows of 4
  float fwd[kMaxGeoms][12];   // transform, 3 rows of 4
  float inv_t[kMaxGeoms][9];  // inverse transpose, 3 rows of 3
};

// The six ray channels ox oy oz dx dy dz, each contiguous (stride 1) or
// one value broadcast to every lane (stride 0).
struct Rays {
  const float* c[6];
  int stride[6];
};

namespace {

constexpr int kCube = 1;       // GEOM_CUBE in scene/structs.py
constexpr float kBig = 1e30f;  // intersect.BIG: a miss

struct V {
  float x, y, z;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.minimum / torch.maximum: a NaN in either operand is the result.
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float dot(V a, V b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}

// vecmath.normalizev: sqrt of max(|a|^2, 1e-12), then a divide a channel.
__device__ __forceinline__ V normalize(V a) {
  const float n = __fsqrt_rn(tmax(dot(a, a), 1e-12f));
  return {__fdiv_rn(a.x, n), __fdiv_rn(a.y, n), __fdiv_rn(a.z, n)};
}

// _xform_point: m[r][0] x + m[r][1] y + m[r][2] z + m[r][3], left to right.
__device__ __forceinline__ V xform_point(const float* m, V p) {
  return {add(add(add(mul(m[0], p.x), mul(m[1], p.y)), mul(m[2], p.z)), m[3]),
          add(add(add(mul(m[4], p.x), mul(m[5], p.y)), mul(m[6], p.z)), m[7]),
          add(add(add(mul(m[8], p.x), mul(m[9], p.y)), mul(m[10], p.z)), m[11])};
}

// _xform_vector with rows of `row` floats (4 for the transforms, 3 for the
// inverse transpose).
__device__ __forceinline__ V xform_vector(const float* m, int row, V v) {
  const float* a = m;
  const float* b = m + row;
  const float* c = m + 2 * row;
  return {add(add(mul(a[0], v.x), mul(a[1], v.y)), mul(a[2], v.z)),
          add(add(mul(b[0], v.x), mul(b[1], v.y)), mul(b[2], v.z)),
          add(add(mul(c[0], v.x), mul(c[1], v.y)), mul(c[2], v.z))};
}

struct GeomHit {
  bool hit;
  bool outside;
  V p;  // world space
  V n;  // world space, unit
};

// _box_test_g: the slab test against the centred unit cube, the
// reference's quirks included (the entry slab needs ta > 0; an inside ray
// reports the exit face with outside = false; normals go through the
// forward transform); axis-parallel rays explicitly.
__device__ __forceinline__ GeomHit box_test(V qo, V qd, const float* fwd) {
  const float o[3] = {qo.x, qo.y, qo.z};
  const float d[3] = {qd.x, qd.y, qd.z};
  float ta[3], tb[3], nsign[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool par = fabsf(d[a]) < 1e-12f;
    const float inv_d = __fdiv_rn(1.0f, par ? 1.0f : d[a]);
    const float t1 = mul(sub(-0.5f, o[a]), inv_d);
    const float t2 = mul(sub(0.5f, o[a]), inv_d);
    const bool inside_slab = (o[a] >= -0.5f) & (o[a] <= 0.5f);
    ta[a] = par ? (inside_slab ? -kBig : kBig) : tmin(t1, t2);
    tb[a] = par ? (inside_slab ? kBig : -kBig) : tmax(t1, t2);
    nsign[a] = t2 < t1 ? 1.0f : -1.0f;
  }
  float tav[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) tav[a] = ta[a] > 0.0f ? ta[a] : -kBig;
  const float t_near = tmax(tmax(tav[0], tav[1]), tav[2]);
  const bool en_x = (tav[0] >= tav[1]) & (tav[0] >= tav[2]);
  const bool en_y = !en_x & (tav[1] >= tav[2]);
  const bool en_z = !en_x & !en_y;
  const float t_far = tmin(tmin(tb[0], tb[1]), tb[2]);
  const bool ex_x = (tb[0] <= tb[1]) & (tb[0] <= tb[2]);
  const bool ex_y = !ex_x & (tb[1] <= tb[2]);
  const bool ex_z = !ex_x & !ex_y;

  GeomHit g;
  g.hit = (t_far >= t_near) & (t_far > 0.0f);
  const bool inside = t_near <= 0.0f;
  const float t_obj = g.hit ? (inside ? t_far : t_near) : 0.0f;
  const bool oh_x = inside ? ex_x : en_x;
  const bool oh_y = inside ? ex_y : en_y;
  const bool oh_z = inside ? ex_z : en_z;
  g.outside = g.hit & !inside;
  const float sign = oh_x ? nsign[0] : (oh_y ? nsign[1] : nsign[2]);
  const V n_obj = {oh_x ? sign : 0.0f, oh_y ? sign : 0.0f, oh_z ? sign : 0.0f};
  const V p_obj = {add(qo.x, mul(qd.x, t_obj)), add(qo.y, mul(qd.y, t_obj)),
                   add(qo.z, mul(qd.z, t_obj))};
  g.p = xform_point(fwd, p_obj);
  g.n = normalize(xform_vector(fwd, 4, n_obj));
  return g;
}

// _sphere_test_g: the radius-0.5 quadratic; the normal goes through the
// inverse transpose and flips when the ray starts inside.
__device__ __forceinline__ GeomHit sphere_test(V qo, V qd, const float* fwd,
                                               const float* inv_t) {
  const float v_dot_d = dot(qo, qd);
  const float radicand = sub(mul(v_dot_d, v_dot_d), sub(dot(qo, qo), 0.25f));
  const bool has_root = radicand >= 0.0f;
  float sq = __fsqrt_rn(has_root ? tmax(radicand, 1e-12f) : 1.0f);
  sq = has_root ? sq : 0.0f;
  const float t1 = add(-v_dot_d, sq);
  const float t2 = sub(-v_dot_d, sq);
  const bool both_neg = (t1 < 0.0f) & (t2 < 0.0f);
  const bool both_pos = (t1 > 0.0f) & (t2 > 0.0f);

  GeomHit g;
  g.outside = both_pos;
  g.hit = has_root & !both_neg;
  const float t_obj = g.hit ? (both_pos ? tmin(t1, t2) : tmax(t1, t2)) : 0.0f;
  const V p_obj = {add(qo.x, mul(qd.x, t_obj)), add(qo.y, mul(qd.y, t_obj)),
                   add(qo.z, mul(qd.z, t_obj))};
  g.p = xform_point(fwd, p_obj);
  const V n = normalize(xform_vector(inv_t, 3, p_obj));
  g.n = both_pos ? n : V{-n.x, -n.y, -n.z};
  return g;
}

__global__ void geoms_hit_kernel(const __grid_constant__ GeomTable table,
                                 const __grid_constant__ Rays rays,
                                 float* __restrict__ t_out, float* __restrict__ point,
                                 float* __restrict__ normal, int* __restrict__ material,
                                 bool* __restrict__ outside, int n, int init) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V o = {rays.c[0][(size_t)i * rays.stride[0]], rays.c[1][(size_t)i * rays.stride[1]],
               rays.c[2][(size_t)i * rays.stride[2]]};
  const V d = {rays.c[3][(size_t)i * rays.stride[3]], rays.c[4][(size_t)i * rays.stride[4]],
               rays.c[5][(size_t)i * rays.stride[5]]};
  float best_t = kBig;
  V best_p = {0.0f, 0.0f, 0.0f};
  V best_n = {0.0f, 0.0f, 0.0f};
  int best_m = -1;
  bool best_out = true;
  if (!init) {  // a later chunk: continue from the earlier chunks' best
    best_t = t_out[i];
    best_p = {point[i], point[n + i], point[2 * (size_t)n + i]};
    best_n = {normal[i], normal[n + i], normal[2 * (size_t)n + i]};
    best_m = material[i];
    best_out = outside[i];
  }
  for (int g = 0; g < table.count; ++g) {
    const V qo = xform_point(table.inv[g], o);
    const V qd = normalize(xform_vector(table.inv[g], 4, d));
    const GeomHit h = table.type[g] == kCube ? box_test(qo, qd, table.fwd[g])
                                             : sphere_test(qo, qd, table.fwd[g], table.inv_t[g]);
    const V r = {sub(h.p.x, o.x), sub(h.p.y, o.y), sub(h.p.z, o.z)};
    const float t_g = h.hit ? __fsqrt_rn(add(dot(r, r), 1e-12f)) : kBig;
    // Strict <: the first of equal hits wins. A lane that takes a geom's
    // hit has hit it, so the plain version's miss sanitising (times 0)
    // never touches what it keeps.
    if (t_g < best_t) {
      best_t = t_g;
      best_p = h.p;
      best_n = h.n;
      best_m = table.material[g];
      best_out = h.outside;
    }
  }
  t_out[i] = best_t;
  point[i] = best_p.x;
  point[n + i] = best_p.y;
  point[2 * (size_t)n + i] = best_p.z;
  normal[i] = best_n.x;
  normal[n + i] = best_n.y;
  normal[2 * (size_t)n + i] = best_n.z;
  material[i] = best_m;
  outside[i] = best_out;
}

}  // namespace

// table, rays: host structs, passed by value into the launch. point and
// normal: [3, n]. init: 1 for a call's first chunk of geoms, else 0.
extern "C" int geoms_hit(const GeomTable* table, const Rays* rays, float* t, float* point,
                         float* normal, int* material, bool* outside, int n, int init,
                         cudaStream_t stream) {
  const int threads = 256;
  geoms_hit_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      *table, *rays, t, point, normal, material, outside, n, init);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
