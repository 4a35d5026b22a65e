// One block of triangles' Moller-Trumbore weights in shared memory, and
// the test of one ray against one staged triangle.
//
// Shared by pair_runs.cu, mxu_bf.cu, cluster_rounds.cu and
// cluster_sweep.cu. walk.cu keeps its own copy of the same code: built from
// this header, nvcc scheduled the walk's loops differently and the walk ran
// slower on the H100, with identical results.
//
// A weight block is the cluster table's [16, 4B] layout (ops/cluster.py,
// ops/mxu_bf.py): for triangle j, column j holds a's weights, column B + j
// t_num's, 2B + j u_num's and 3B + j v_num's; rows 10-15 are zero. A ray's
// features r = [o, d, o x d, 1] dotted with a column give that quantity,
// and the epilogue of ops/mxu_bf.py (_epilogue) accepts a > eps, u, v >= 0,
// u + v <= a and t >= 0.

#pragma once

#include <cuda_runtime.h>

namespace mt {

constexpr float kBig = 1e30f;
constexpr float kCullEps = 1.19e-7f;   // ops/mxu_bf.py _CULL_EPS
constexpr int kFeat = 10;              // non-zero feature rows of r and w
constexpr int kTriFloats = 4 * kFeat;  // one staged triangle: a | t | u | v

// Shared memory the staged block of `block` triangles takes (bytes).
inline int staged_bytes(int block) { return kTriFloats * block * (int)sizeof(float); }

// Raise a kernel's dynamic shared memory limit when it needs more than
// the 48 KB every kernel may use.
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Copy rows 0-9 of the weight block at `wk` into `sw`, transposed so that
// triangle j's 40 weights are sw[40 j .. 40 j + 39]: ten float4 loads
// when it is tested. Every thread of the thread block takes part; the
// caller synchronises before and after.
__device__ __forceinline__ void stage_block(float* sw, const float* __restrict__ wk,
                                            int block) {
  const int cols = 4 * block;
  const int nt = blockDim.x;  // a signed stride: the unsigned one compiled slower
  for (int e = threadIdx.x; e < kFeat * cols; e += nt) {
    const int f = e / cols;
    const int c = e - f * cols;
    const int q = c / block;
    const int j = c - q * block;
    sw[j * kTriFloats + q * kFeat + f] = wk[e];
  }
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

}  // namespace mt
