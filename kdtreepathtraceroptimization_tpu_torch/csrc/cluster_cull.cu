// Sphere cull: per ray tile, the tile-min conservative bounding-sphere
// entry bound into every cluster block.
//
// Replaces the TPU kernel `_cull_kernel` (launcher `_cull_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/cluster.py. Plain version:
// `_cull_ref` in kdtreepathtraceroptimization_tpu_torch/ops/cluster.py.
//
// out[g, k] = min over the rays i of tile g of the entry bound of ray i
// into block k (cluster_entry.cuh), BIG when no ray of the tile can enter
// it. The TPU computed the d.c and o.c products as one [8, 2kp] matmul
// with five exactly-zero terms; here they are the three non-zero terms,
// rounded and summed as the plain version does, so the result is equal bit
// for bit.
//
// Bound on this card: operations. Each (ray, block) pair costs about 22 f32
// operations against 32 bytes read per ray and 36 per block, i.e. ~700
// operations per byte at kp = 512, far above the H100's ~20 per byte.
// Design: one thread block per ray tile stages the tile's rays (o, d, t0,
// act and the per-ray o.d, |o|^2) in shared memory; every thread then
// reads the same ray at the same time (a broadcast). Each thread owns
// blocks k, keeps the block's centre, radius, |c|^2 and r^2 in registers,
// loops over the tile's rays and keeps the min in a register, so there are
// no atomics and the [rays, blocks] matrix never exists.

#include "cluster_entry.cuh"

namespace {

constexpr int kRayFloats = 10;  // staged per ray: o(3) d(3) t0 live od oo
constexpr int kThreads = 256;

__global__ void cluster_cull_kernel(const float* __restrict__ x,
                                    const float* __restrict__ cull_w,
                                    const float* __restrict__ blk, float* __restrict__ out,
                                    int kp, int tile) {
  extern __shared__ float sr[];  // sr[f * tile + i]
  const int g = blockIdx.x;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const entry::Ray r = entry::load_ray(x + ((size_t)g * tile + i) * 8);
    for (int a = 0; a < 3; ++a) {
      sr[a * tile + i] = r.o[a];
      sr[(3 + a) * tile + i] = r.d[a];
    }
    sr[6 * tile + i] = r.t0;
    sr[7 * tile + i] = r.live ? 1.f : 0.f;
    sr[8 * tile + i] = r.od;
    sr[9 * tile + i] = r.oo;
  }
  __syncthreads();

  for (int k = threadIdx.x; k < kp; k += blockDim.x) {
    float b[entry::kBlockFloats];
    entry::load_block(cull_w, blk, kp, k, b);
    float best = entry::kBig;
    if (b[8] >= 0.f) {  // sentinel blocks (r2 < 0) stay BIG
      for (int i = 0; i < tile; ++i) {
        entry::Ray r;
        for (int a = 0; a < 3; ++a) {
          r.o[a] = sr[a * tile + i];
          r.d[a] = sr[(3 + a) * tile + i];
        }
        r.t0 = sr[6 * tile + i];
        r.live = sr[7 * tile + i] > 0.f;
        r.od = sr[8 * tile + i];
        r.oo = sr[9 * tile + i];
        best = fminf(best, entry::bound(r, b));
      }
    }
    out[(size_t)g * kp + k] = best;
  }
}

}  // namespace

extern "C" int cluster_cull(const float* x, const float* cull_w, const float* blk, float* out,
                            int n, int kp, int tile, cudaStream_t stream) {
  const int smem = kRayFloats * tile * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cluster_cull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cluster_cull_kernel<<<n / tile, kThreads, smem, stream>>>(x, cull_w, blk, out, kp, tile);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
