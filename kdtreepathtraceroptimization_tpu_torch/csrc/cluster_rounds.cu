// Cluster rounds and the repair sweep: per ray tile, a list of blocks
// intersected one after another, keeping each ray's nearest hit.
//
// Replaces two TPU kernels in kdtreepathtraceroptimization_tpu/ops/cluster.py:
//   - `_cluster_kernel` (launcher `_cluster_pallas`), entry point
//     `cluster_rounds`: round rr of tile g tests block sel[g, rr], and runs
//     only when some live ray of the tile still has a best t above the
//     round's entry bound lb[g, rr] (padded rounds carry lb = BIG and never
//     run);
//   - `_sweep_kernel` (launcher `_sweep_pallas`), entry point
//     `cluster_sweep`: the exactness repair, every real block k = 0 ..
//     kreal-1 for every tile, with no bound, no order and no act input.
//     Dead lanes have d = 0, so every determinant is 0 and they never hit;
//     they are tested all the same, as on the TPU: skipping each dead lane
//     made the kernel slower, and skipping tiles of dead lanes only saved
//     nothing, as such tiles are rare (PERF.md, PR 4). The TPU kernel also
//     streams the lane-padding blocks past kreal, whose weights are zero:
//     they never hit.
// Plain versions: `_cluster_ref` in
// kdtreepathtraceroptimization_tpu_torch/ops/cluster.py (its lb-driven stop
// for the rounds; the real blocks with lb = None for the sweep).
//
// Each round is the Moller-Trumbore test of every ray against the block's
// triangles (mt_block.cuh) with a running min: ties go to the smaller
// triangle within a block and to the earlier round across blocks (strict
// <), as in the TPU kernels. Both start from bt = t0 and btri = -1.
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
// with compute (cp.async / TMA double buffering is left for later).

#include "mt_block.cuh"

namespace {

constexpr int kRpt = 4;  // rays per thread

template <bool kSweep>
__device__ __forceinline__ void rounds_body(const int* __restrict__ sel,
                                            const float* __restrict__ lb,
                                            const float* __restrict__ r,
                                            const float* __restrict__ t0,
                                            const float* __restrict__ act,
                                            const float* __restrict__ w,
                                            float* __restrict__ bt_out,
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
    on[i] = kSweep || act[ray] > 0.f;
  }

  for (int rr = 0; rr < rounds; ++rr) {
    int k = rr;
    if (kSweep) {
      __syncthreads();  // every thread is done reading sw
    } else {
      const float bound = lb[(size_t)g * rounds + rr];
      bool want = false;
#pragma unroll
      for (int i = 0; i < kRpt; ++i) want |= on[i] && bt[i] > bound;
      if (!__syncthreads_or(want)) continue;
      k = sel[(size_t)g * rounds + rr];
    }
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

__global__ void cluster_rounds_kernel(const int* __restrict__ sel,
                                      const float* __restrict__ lb,
                                      const float* __restrict__ r,
                                      const float* __restrict__ t0,
                                      const float* __restrict__ act,
                                      const float* __restrict__ w, float* __restrict__ bt,
                                      int* __restrict__ btri, int rounds, int tile,
                                      int block) {
  rounds_body<false>(sel, lb, r, t0, act, w, bt, btri, rounds, tile, block);
}

__global__ void cluster_sweep_kernel(const float* __restrict__ r,
                                     const float* __restrict__ t0,
                                     const float* __restrict__ w, float* __restrict__ bt,
                                     int* __restrict__ btri, int kreal, int tile, int block) {
  rounds_body<true>(nullptr, nullptr, r, t0, nullptr, w, bt, btri, kreal, tile, block);
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

extern "C" int cluster_sweep(const float* r, const float* t0, const float* w, float* bt,
                             int* btri, int n, int kreal, int tile, int block,
                             cudaStream_t stream) {
  const int smem = mt::staged_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)cluster_sweep_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cluster_sweep_kernel<<<n / tile, tile / kRpt, smem, stream>>>(r, t0, w, bt, btri, kreal,
                                                                tile, block);
  return (int)cudaGetLastError();
}

// The launchers need tile % RPT == 0 and tile / RPT <= 1024.
extern "C" int cluster_rays_per_thread() { return kRpt; }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
