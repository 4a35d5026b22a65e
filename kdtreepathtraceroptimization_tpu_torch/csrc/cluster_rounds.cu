// Cluster rounds: per ray tile, a list of blocks intersected one after
// another, keeping each ray's nearest hit.
//
// Replaces the TPU kernel `_cluster_kernel` (launcher `_cluster_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/cluster.py, entry point
// `cluster_rounds`: round rr of tile g tests block sel[g, rr], and runs
// only when some live ray of the tile still has a best t above the round's
// entry bound lb[g, rr] (padded rounds carry lb = BIG and never run).
// Plain version: `_cluster_ref` in
// kdtreepathtraceroptimization_tpu_torch/ops/cluster.py. (The repair
// sweep, the other TPU kernel of that file, is csrc/cluster_sweep.cu.)
//
// Each round is the Moller-Trumbore test of every ray against the block's
// triangles (mt_block.cuh) with a running min: ties go to the smaller
// triangle within a block and to the earlier round across blocks (strict
// <), as in the TPU kernel. It starts from bt = t0 and btri = -1.
//
// Bound on this card: operations. Each (ray, triangle) test is 40 FMAs and
// about 10 more f32 operations, against weights (40 KB per block of 256)
// that stay in L2 and 76 bytes per ray read once.
// Design: one thread block per tile, kRpt rays per thread. Each round
// stages the block's weights in shared memory (mt::stage_block); every
// thread reads the same triangle at the same time (a broadcast) and reuses
// each loaded weight for its kRpt rays. The rounds' test is one
// __syncthreads_or, which is also the barrier before the staging buffer is
// written again. sel and lb are read from device memory, so any number of
// rounds fits (the binned repair passes R = kp). Staging is not overlapped
// with compute.

#include "mt_block.cuh"

namespace {

constexpr int kRpt = 4;  // rays per thread

__global__ void cluster_rounds_kernel(const int* __restrict__ sel,
                                      const float* __restrict__ lb,
                                      const float* __restrict__ r,
                                      const float* __restrict__ t0,
                                      const float* __restrict__ act,
                                      const float* __restrict__ w, float* __restrict__ bt_out,
                                      int* __restrict__ btri_out, int rounds, int tile,
                                      int block) {
  extern __shared__ float4 sw4[];
  float* sw = reinterpret_cast<float*>(sw4);
  const int g = blockIdx.x;
  const int nt = blockDim.x;

  float rf[kRpt][mt::kFeat];
  float bt[kRpt];
  int bi[kRpt];
  bool on[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const size_t ray = (size_t)g * tile + threadIdx.x + i * nt;
#pragma unroll
    for (int f = 0; f < mt::kFeat; ++f) rf[i][f] = r[ray * 16 + f];
    bt[i] = t0[ray];
    bi[i] = -1;
    on[i] = act[ray] > 0.f;
  }

  for (int rr = 0; rr < rounds; ++rr) {
    const float bound = lb[(size_t)g * rounds + rr];
    bool want = false;
#pragma unroll
    for (int i = 0; i < kRpt; ++i) want |= on[i] && bt[i] > bound;
    if (!__syncthreads_or(want)) continue;
    const int k = sel[(size_t)g * rounds + rr];
    mt::stage_block(sw, w + (size_t)k * 16 * 4 * block, block);
    __syncthreads();

    float cur[kRpt];
    int loc[kRpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      cur[i] = bt[i];
      loc[i] = -1;
    }
    for (int j = 0; j < block; ++j) {
      float wj[mt::kTriFloats];
      mt::load_tri(sw4, j, wj);
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        if (!on[i]) continue;  // dead rays have d = 0 and never hit
        float a, tn;
        if (mt::accept(rf[i], wj, a, tn)) {
          const float t = __fdiv_rn(tn, a);
          if (t < cur[i]) {
            cur[i] = t;
            loc[i] = j;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      if (loc[i] >= 0) {
        bt[i] = cur[i];
        bi[i] = k * block + loc[i];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const size_t ray = (size_t)g * tile + threadIdx.x + i * nt;
    bt_out[ray] = bt[i];
    btri_out[ray] = bi[i];
  }
}

}  // namespace

extern "C" int cluster_rounds(const int* sel, const float* lb, const float* r, const float* t0,
                              const float* act, const float* w, float* bt, int* btri, int n,
                              int rounds, int tile, int block, cudaStream_t stream) {
  const int smem = mt::staged_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)cluster_rounds_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cluster_rounds_kernel<<<n / tile, tile / kRpt, smem, stream>>>(sel, lb, r, t0, act, w, bt,
                                                                 btri, rounds, tile, block);
  return (int)cudaGetLastError();
}

// The launcher needs tile % RPT == 0 and tile / RPT <= 1024.
extern "C" int cluster_rays_per_thread() { return kRpt; }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
