// Walk: per ray tile, intersect the tile's entry-ordered feasible blocks
// one after another, keeping each ray's nearest hit, and stop as soon as no
// live ray can still improve.
//
// Replaces the TPU kernel `_walk_kernel` (launcher `_walk_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/walk.py. Plain version: `_walk_ref`
// (the round loop `_cluster_ref`) in kdtreepathtraceroptimization_tpu_torch.
//
// The round loop, its skips and its staging are round_walk.cuh's, which
// the cluster rounds (cluster_rounds.cu) share: here the list of tile g is
// row g of sel and lb [n / tile, K], every feasible block in entry order,
// nsel[g] of them.
//
// Bound on this card: operations, by a little over bytes. Each needed (live
// ray, real triangle) test is 19 FMAs and 8 more f32 operations, but at ray
// granularity few tests are needed: most rays of a tile meet few of the
// boxes on the tile's list, and the bytes are a ray's features and bounds
// and the 16 weights of each real triangle those tests read, once.
// What the kernel spends its time on is the list itself: per round a staged
// block, two barriers and a box test per ray, and the tests of the ray
// groups that take part, in the few warps that have any.
// Launch shape: small parts (one ray a thread, 128 threads, six thread
// blocks an SM: the fastest of the shapes chip_smoke.py --shapes times)
// keep more independent lists in flight on an SM, so that the few warps
// with tests to run in a round are not alone.

#include "round_walk.cuh"

namespace {

constexpr int kRpt = 1;         // rays a thread
constexpr int kThreads = 128;   // threads a thread block
constexpr int kMinBlocks = 6;   // thread blocks an SM must hold (__launch_bounds__)
constexpr int kUnroll = 0;      // the triangle loop's unroll (0: the compiler's)
constexpr int kPart = kRpt * kThreads;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
walk_kernel(const int* __restrict__ sel, const float* __restrict__ lb,
            const int* __restrict__ nsel, const int* __restrict__ order,
            const float* __restrict__ r, const float* __restrict__ t0,
            const float* __restrict__ act, const float* __restrict__ w,
            const int* __restrict__ real, const float* __restrict__ slab,
            float* __restrict__ bt_out,
            int* __restrict__ btri_out, int* __restrict__ rounds_out, int kp, int tile,
            int block, int parts) {
  extern __shared__ float4 smem4[];
  const int g = order[blockIdx.x / parts];
  rw::walk_part<kRpt, kThreads, kUnroll>(
      sel + (size_t)g * kp, lb + (size_t)g * kp, nsel[g], g, (blockIdx.x % parts) * kPart, r,
      t0, act, w, real, slab, kp, tile, block, bt_out, btri_out, rounds_out,
      reinterpret_cast<float*>(smem4));
}

}  // namespace

// sel, lb [n / tile, kp], nsel [n / tile] and order [n / tile] (the tiles,
// longest list first); r [n, 16], t0, act [n]; w [kp, 16, 4 block], real
// [kp] and slab [8, kp] (rows lo_xyz hi_xyz); outputs bt, btri [n] and,
// unless null, rounds [n / tile, 2] (zeroed by the caller; each tile's
// thread blocks add the rounds they ran and the (32-ray group, real slot)
// tests their warps ran).
extern "C" int walk(const int* sel, const float* lb, const int* nsel, const int* order,
                    const float* r, const float* t0, const float* act, const float* w,
                    const int* real, const float* slab, float* bt, int* btri, int* rounds,
                    int n, int kp, int tile, int block, cudaStream_t stream) {
  if (tile <= 0 || block <= 0 || n % tile) return (int)cudaErrorInvalidValue;
  const int smem = rw::staged_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)walk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int parts = (tile + kPart - 1) / kPart;
  walk_kernel<<<(n / tile) * parts, kThreads, smem, stream>>>(
      sel, lb, nsel, order, r, t0, act, w, real, slab, bt, btri, rounds, kp, tile, block, parts);
  return (int)cudaGetLastError();
}

// Shared memory a thread block takes for blocks of `block` triangles (bytes).
extern "C" int walk_smem_bytes(int block) { return rw::staged_bytes(block); }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
