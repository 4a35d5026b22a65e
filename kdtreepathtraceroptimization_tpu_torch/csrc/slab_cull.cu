// Slab cull: per ray tile, the tile-min conservative AABB entry bound into
// every cluster block.
//
// Replaces the TPU kernel `_slab_cull_kernel` (launcher `_slab_cull_pallas`)
// in kdtreepathtraceroptimization_tpu/ops/walk.py. Plain version:
// `_slab_cull_ref` in kdtreepathtraceroptimization_tpu_torch/ops/walk.py.
//
// out[g, k] = min over the rays i of tile g of entry(i, k), where entry is
// the ray parameter at which ray i can first be inside block k's AABB,
// widened by a slack, or BIG when the block is infeasible for the ray
// (missed, behind, beyond t0, dead ray, sentinel block).
//
// Bound on this card: operations. Each (ray, block) pair costs ~30 f32
// operations against 64 bytes read per ray, i.e. ~180 operations per byte
// at kp = 384 blocks, far above the H100's ~20 f32 operations per byte.
// Design: one thread block per ray tile stages the tile's 8 needed ray
// columns in shared memory (every thread then reads the same ray at the
// same time: a broadcast); each thread owns blocks k and loops over the
// tile's rays, so the tile-min is a register and the [rays, blocks] matrix
// never exists. The TPU kernel's 8-row partial output was a layout
// artefact and is gone: the kernel writes [tiles, kp] directly.
//
// Products and sums use __fmul_rn / __fsub_rn / __fadd_rn so that nvcc
// does not contract them into FMAs: the result equals the plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;

__global__ void slab_cull_kernel(const float* __restrict__ x,
                                 const float* __restrict__ slab,
                                 const float* __restrict__ blk,
                                 float* __restrict__ out, int kp, int tile) {
  // sx rows: t0, act, invd_x, invd_y, invd_z, oinv_x, oinv_y, oinv_z.
  extern __shared__ float sx[];
  const int g = blockIdx.x;
  const float* xt = x + (size_t)g * tile * 16;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const float* row = xt + (size_t)i * 16;
    sx[0 * tile + i] = row[6];
    sx[1 * tile + i] = row[7];
    for (int a = 0; a < 3; ++a) {
      sx[(2 + a) * tile + i] = row[8 + a];
      sx[(5 + a) * tile + i] = row[11 + a];
    }
  }
  __syncthreads();

  for (int k = threadIdx.x; k < kp; k += blockDim.x) {
    float best = kBig;
    if (blk[5 * kp + k] >= 0.f) {  // sentinel blocks (r2 < 0) stay BIG
      float lo[3], hi[3];
      for (int a = 0; a < 3; ++a) {
        lo[a] = slab[a * kp + k];
        hi[a] = slab[(3 + a) * kp + k];
      }
      for (int i = 0; i < tile; ++i) {
        float tmin = -kBig, tmax = kBig;
        for (int a = 0; a < 3; ++a) {
          const float invd = sx[(2 + a) * tile + i];
          const float oinv = sx[(5 + a) * tile + i];
          const float tlo = __fsub_rn(__fmul_rn(lo[a], invd), oinv);
          const float thi = __fsub_rn(__fmul_rn(hi[a], invd), oinv);
          tmin = fmaxf(tmin, fminf(tlo, thi));
          tmax = fminf(tmax, fmaxf(tlo, thi));
        }
        const float slack = __fadd_rn(__fmul_rn(1e-6f, fabsf(tmin)), 1e-5f);
        tmin = __fsub_rn(tmin, slack);
        tmax = __fadd_rn(tmax, slack);
        const float entry = fmaxf(tmin, 0.f);
        const bool feasible = (tmax >= entry) && (tmax > 0.f) &&
                              (entry < sx[i]) && (sx[tile + i] > 0.f);
        if (feasible) best = fminf(best, entry);
      }
    }
    out[(size_t)g * kp + k] = best;
  }
}

}  // namespace

extern "C" int slab_cull(const float* x, const float* slab, const float* blk,
                         float* out, int n, int kp, int tile,
                         cudaStream_t stream) {
  const int smem = 8 * tile * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        slab_cull_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  slab_cull_kernel<<<n / tile, 128, smem, stream>>>(x, slab, blk, out, kp,
                                                    tile);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
