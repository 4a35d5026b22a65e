// Cluster rounds: per ray tile, a budgeted list of blocks intersected one
// after another in entry order, keeping each ray's nearest hit.
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
// The rounds are the walk with a budget, so this kernel runs the walk's
// round loop (round_walk.cuh): the list of tile g is row g of sel and lb
// [n / tile, R], the first R blocks of the sphere cull in entry order
// (ops/cluster.py _select: lb ascends and pads with BIG), nsel[g] of them
// below BIG. A ray takes part in a round only while its best t exceeds
// lb[g, rr] and it meets the block's widened box (cm.slab) before it; a
// part of the tile stops at the first round none of its live rays wants.
// Any R fits (the binned repair passes R = K): sel and lb are read from
// device memory.
//
// Bound on this card: operations, as the walk's. Each needed (live ray,
// real triangle) test is 19 FMAs and 8 more f32 operations, and at ray
// granularity few are needed; the bytes are a ray's features, bounds and
// outputs, the listed entries of sel and lb, and the 16 weights of each
// real triangle some needed test reads. As on the walk, the time goes to
// the list: a staged block, two barriers and a box test per ray a round.
// Launch shape (the fastest of those chip_smoke.py --shapes times on the
// cluster path's call): one ray a thread, parts of 256 rays, four thread
// blocks an SM, the triangle loop unrolled 8 times; the walk's 128-ray
// parts took 1.72 ms there against 1.46 for 256 (both unrolled as the
// compiler chose), and unrolling 8 times took 1.46 to 1.26 (H100 80GB
// HBM3, 700 W). Parts are launched longest list first.

#include "round_walk.cuh"

namespace {

constexpr int kRpt = 1;         // rays a thread
constexpr int kThreads = 256;   // threads a thread block
constexpr int kMinBlocks = 4;   // thread blocks an SM must hold (__launch_bounds__)
constexpr int kUnroll = 8;      // the triangle loop's unroll (0: the compiler's)
constexpr int kPart = kRpt * kThreads;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
cluster_rounds_kernel(const int* __restrict__ sel, const float* __restrict__ lb,
                      const int* __restrict__ nsel, const int* __restrict__ order,
                      const float* __restrict__ r, const float* __restrict__ t0,
                      const float* __restrict__ act, const float* __restrict__ w,
                      const int* __restrict__ real, const float* __restrict__ slab,
                      float* __restrict__ bt_out, int* __restrict__ btri_out,
                      int* __restrict__ rounds_out, int rounds, int kp, int tile, int block,
                      int parts) {
  extern __shared__ float4 smem4[];
  const int g = order[blockIdx.x / parts];
  rw::walk_part<kRpt, kThreads, kUnroll>(
      sel + (size_t)g * rounds, lb + (size_t)g * rounds, nsel[g], g, (blockIdx.x % parts) * kPart,
      r, t0, act, w, real, slab, kp, tile, block, bt_out, btri_out, rounds_out,
      reinterpret_cast<float*>(smem4));
}

}  // namespace

// sel, lb [n / tile, rounds], nsel [n / tile] (each tile's lb < BIG
// entries) and order [n / tile] (the tiles, longest list first); r [n, 16],
// t0, act [n]; w [kp, 16, 4 block], real [kp] and slab [8, kp] (rows
// lo_xyz hi_xyz); outputs bt, btri [n] and, unless null, rounds_out
// [n / tile, 2] (zeroed by the caller; each tile's thread blocks add the
// rounds they ran and the (32-ray group, real slot) tests their warps ran).
extern "C" int cluster_rounds(const int* sel, const float* lb, const int* nsel, const int* order,
                              const float* r, const float* t0, const float* act, const float* w,
                              const int* real, const float* slab, float* bt, int* btri,
                              int* rounds_out, int n, int rounds, int kp, int tile, int block,
                              cudaStream_t stream) {
  if (tile <= 0 || block <= 0 || n % tile) return (int)cudaErrorInvalidValue;
  const int smem = rw::staged_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)cluster_rounds_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int parts = (tile + kPart - 1) / kPart;
  cluster_rounds_kernel<<<(n / tile) * parts, kThreads, smem, stream>>>(
      sel, lb, nsel, order, r, t0, act, w, real, slab, bt, btri, rounds_out, rounds, kp, tile,
      block, parts);
  return (int)cudaGetLastError();
}

// Shared memory a thread block takes for blocks of `block` triangles (bytes).
extern "C" int cluster_rounds_smem_bytes(int block) { return rw::staged_bytes(block); }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
