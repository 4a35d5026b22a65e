// Argmin cull: per ray, the feasible cluster block of least bounding-sphere
// entry bound (the first on ties), or kp when none is feasible.
//
// Replaces the TPU kernel `_argmin_kernel` (launcher `_argmin_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/binned.py. Plain version:
// `_argmin_ref` in kdtreepathtraceroptimization_tpu_torch/ops/binned.py.
//
// The entry bound is the sphere cull's (cluster_entry.cuh), rounded the
// same way, so the bins equal the plain version's bit for bit. A strict <
// over k = 0 .. kp-1 keeps the first minimum, as jnp.argmin and
// torch.argmin do; infeasible blocks (BIG) never replace the start value.
//
// Bound on this card: operations. Each (ray, block) pair costs about 22 f32
// operations against 32 bytes read and 4 written per ray.
// Design: one thread per ray, its record in registers. The block table
// (nine floats per block) is staged in shared memory in chunks of
// kChunk blocks; every thread reads the same block at the same time (a
// broadcast).

#include "cluster_entry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // blocks staged at once: 36 KB

__global__ void binned_argmin_kernel(const float* __restrict__ x,
                                     const float* __restrict__ cull_w,
                                     const float* __restrict__ blk, int* __restrict__ bins,
                                     int n, int kp) {
  __shared__ float sb[kChunk * entry::kBlockFloats];
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool mine = ray < n;
  entry::Ray r = {};
  if (mine) r = entry::load_ray(x + (size_t)ray * 8);
  float best = entry::kBig;
  int bin = kp;
  for (int k0 = 0; k0 < kp; k0 += kChunk) {
    const int nk = min(kChunk, kp - k0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int k = threadIdx.x; k < nk; k += blockDim.x)
      entry::load_block(cull_w, blk, kp, k0 + k, sb + k * entry::kBlockFloats);
    __syncthreads();
    if (!mine || !r.live) continue;  // a dead ray has no feasible block
    for (int k = 0; k < nk; ++k) {
      const float e = entry::bound(r, sb + k * entry::kBlockFloats);
      if (e < best) {
        best = e;
        bin = k0 + k;
      }
    }
  }
  if (mine) bins[ray] = bin;
}

}  // namespace

extern "C" int binned_argmin(const float* x, const float* cull_w, const float* blk, int* bins,
                             int n, int kp, cudaStream_t stream) {
  binned_argmin_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      x, cull_w, blk, bins, n, kp);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
