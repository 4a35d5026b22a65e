// A block of triangles' Moller-Trumbore weights, and the test of one ray
// against one staged triangle.
//
// The dense form (load_tri, accept) is used by cluster_sweep.cu (kernel 11)
// alone, which stages its rows itself; the sparse form (sparse_run,
// load_sparse, sparse_accept) by mxu_bf.cu (kernel 8), round_walk.cuh,
// whose round loop walk.cu and cluster_rounds.cu run (kernels 2 and 10),
// and pair_part.cuh, whose part loop pair_runs.cu and pair_bdiag.cu run
// (kernels 6 and 7); the cp.async helpers by all of these.
//
// A weight block is the cluster table's [16, 4B] layout (ops/cluster.py,
// ops/mxu_bf.py): for triangle j, column j holds a's weights, column B + j
// t_num's, 2B + j u_num's and 3B + j v_num's; rows 10-15 are zero. A ray's
// features r = [o, d, o x d, 1] dotted with a column give that quantity,
// and the epilogue of ops/mxu_bf.py (_epilogue) accepts a > eps, u, v >= 0,
// u + v <= a and t >= 0.
//
// The sparse form rests on the weight tables' zero pattern (ops/mxu_bf.py
// tri_weights, ops/cluster.py build_cluster_mesh; mxu_bf.check_sparse_pattern
// checks it): only 19 of a triangle's 40 weights can be non-zero, a's rows
// 3-5 (-n), t_num's rows 0-2 (n) and 9 (-c), and u_num's and v_num's rows
// 3-8; and a's three equal -(t_num's rows 0-2). So a triangle is 16
// distinct floats, and sparse_accept runs only the 19 non-zero FMAs, in
// the order of the dense chain (dot10). A dropped term fmaf(r, 0, acc)
// leaves acc unchanged but for the sign of a zero, which no accept test
// sees, and -(x y) rounds as (-x) y: the sparse test gives the dense
// test's a, t_num, u_num and v_num, hence the same hits and t.

#pragma once

#include <cuda_runtime.h>

namespace mt {

constexpr float kBig = 1e30f;
constexpr float kCullEps = 1.19e-7f;   // ops/mxu_bf.py _CULL_EPS
constexpr int kFeat = 10;              // non-zero feature rows of r and w
constexpr int kTriFloats = 4 * kFeat;  // one staged triangle: a | t | u | v

// Raise a kernel's dynamic shared memory limit when it needs more than
// the 48 KB every kernel may use.
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Staged triangle j's weights into registers (all threads read the same
// address at once: a broadcast).
__device__ __forceinline__ void load_tri(const float4* sw4, int j, float* wj) {
#pragma unroll
  for (int v = 0; v < kTriFloats / 4; ++v) {
    const float4 p = sw4[j * (kTriFloats / 4) + v];
    wj[4 * v + 0] = p.x;
    wj[4 * v + 1] = p.y;
    wj[4 * v + 2] = p.z;
    wj[4 * v + 3] = p.w;
  }
}

__device__ __forceinline__ float dot10(const float* r, const float* w) {
  float acc = r[0] * w[0];
#pragma unroll
  for (int f = 1; f < kFeat; ++f) acc = fmaf(r[f], w[f], acc);
  return acc;
}

// The epilogue's accept test of ray features `rf` against the staged
// triangle `wj` (front face, inside the edges, t >= 0), with the two
// quantities the hit's t = t_num / a needs; callers divide inside their
// accept branch.
__device__ __forceinline__ bool accept(const float* rf, const float* wj, float& a,
                                       float& tn) {
  a = dot10(rf, wj + 0 * kFeat);
  tn = dot10(rf, wj + 1 * kFeat);
  const float un = dot10(rf, wj + 2 * kFeat);
  const float vn = dot10(rf, wj + 3 * kFeat);
  return (a > kCullEps) && (un >= 0.f) && (vn >= 0.f) && (__fadd_rn(un, vn) <= a) &&
         (tn >= 0.f);
}

// ---------------------------------------------------------------------------
// The sparse form: a triangle's 16 distinct weights, in this order:
//   0-2  t_num rows 0-2 (n; a's rows 3-5 are their negation)
//   3    t_num row 9 (-c)
//   4-9  u_num rows 3-8
//   10-15 v_num rows 3-8
// ---------------------------------------------------------------------------

constexpr int kSparse = 16;  // distinct weights of one triangle

// Offset of sparse weight i's run (its B slots) in a [16, 4B] weight block.
__device__ __forceinline__ int sparse_run(int i, int block) {
  const int q = i < 4 ? 1 : (i < 10 ? 2 : 3);                   // t_num, u_num, v_num
  const int f = i < 3 ? i : (i == 3 ? 9 : (i < 10 ? i - 1 : i - 7));  // feature row
  return f * 4 * block + q * block;
}

// Triangle j's 16 weights from a [triangles, 16] staged table (four float4
// loads; every thread reads the same address at once: a broadcast).
__device__ __forceinline__ void load_sparse(const float4* tb4, int j, float* wj) {
#pragma unroll
  for (int v = 0; v < kSparse / 4; ++v) {
    const float4 p = tb4[j * (kSparse / 4) + v];
    wj[4 * v + 0] = p.x;
    wj[4 * v + 1] = p.y;
    wj[4 * v + 2] = p.z;
    wj[4 * v + 3] = p.w;
  }
}

// accept() on the 16 distinct weights: the 19 non-zero FMAs of the dense
// chains in their order. a = -(n . d): the dense chain multiplies d by -n
// term by term, and rounding to nearest is symmetric, so negating the sum
// of d n gives the same float.
__device__ __forceinline__ bool sparse_accept(const float* rf, const float* wj, float& a,
                                              float& tn) {
  a = -fmaf(rf[5], wj[2], fmaf(rf[4], wj[1], rf[3] * wj[0]));
  tn = fmaf(rf[9], wj[3], fmaf(rf[2], wj[2], fmaf(rf[1], wj[1], rf[0] * wj[0])));
  float un = rf[3] * wj[4];
  float vn = rf[3] * wj[10];
#pragma unroll
  for (int f = 4; f < 9; ++f) {
    un = fmaf(rf[f], wj[f + 1], un);
    vn = fmaf(rf[f], wj[f + 7], vn);
  }
  return (a > kCullEps) && (un >= 0.f) && (vn >= 0.f) && (__fadd_rn(un, vn) <= a) &&
         (tn >= 0.f);
}

// Asynchronous copies from global to shared memory (cp.async): 16 bytes
// (both addresses 16-byte aligned) or 4 bytes; a commit closes a group,
// and wait_all waits for every group this thread issued.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace mt
