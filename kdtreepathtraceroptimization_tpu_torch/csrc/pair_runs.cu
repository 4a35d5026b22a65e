// Pair test: per tile of block-sorted (ray, block) pairs, each run of
// pairs with the same block against that block's triangles; per pair the
// nearest hit packed as one int32 (t | loc).
//
// Replaces the TPU kernel `_pair_runs_kernel` (launcher `_pair_runs_pallas`)
// in kdtreepathtraceroptimization_tpu/ops/pairs.py. Plain version:
// `_pair_runs_ref` in kdtreepathtraceroptimization_tpu_torch/ops/pairs.py.
// The function, its precondition (the table's zero pattern and real slots)
// and the part loop are pair_part.cuh's, which kernel 7 (pair_bdiag.cu)
// runs too: on the same pairs the two give the same keys bit for bit. The
// JAX package has two kernels because its matrix unit wants short runs
// packed into one 128-deep product; on this card both come to the part loop.
//
// Bound on this card: operations. Each (real pair, real triangle) test is
// 19 FMAs and 8 more f32 operations, against 64 bytes read and 4 written a
// pair and the 16 weights of each real triangle of a block some pair
// names.
// What held the first version of this kernel back, and what the part loop
// does about it:
//   - it ran the dense test (40 FMAs) on all `block` slots; the part loop
//     runs the sparse test (19) on the block's real slots only (160 of 256
//     on the icosphere-6 table);
//   - it staged the dense block between two barriers with nothing in
//     flight; the part loop copies the real slots' sparse runs by cp.async,
//     the next round's while this one tests;
//   - it took one run at a time while the tile's other threads waited; a
//     round of the part loop stages up to `slots` runs, and all their pairs
//     test at once;
//   - a part of many short runs (pass 2: a few thousand real pairs over
//     most of the 512 blocks) would take its rounds one after another, on
//     the few SMs that hold such parts; above kDirectRounds rounds the part
//     stages nothing and each pair reads its block's weights through the
//     cache (pair_part.cuh).
// Launch shape: one thread per pair, a tile of ptile pairs (pair_tile, 256
// on the default path) in parts of kThreads pairs, kMinBlocks thread blocks
// an SM, which set the slots (pair_runs_slots), and kDirectRounds: 256, 3
// and 2, the fastest of those chip_smoke.py --shapes times on the pair
// path's pass-1 and pass-2 calls and bounce 0's heaviest launch (0.070,
// 0.055 and 0.108 ms; without the direct form 0.069, 0.133 and 0.289;
// 256, 4: 0.089, 0.042, 0.074; H100 80GB HBM3, 700 W).

#include "pair_part.cuh"

namespace {

constexpr int kThreads = 256;   // pairs (threads) a thread block
constexpr int kMinBlocks = 3;   // thread blocks an SM must hold
constexpr int kDirectRounds = 2;  // rounds above which a part reads weights directly (0: never)

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pair_runs_kernel(const int* __restrict__ blk_s, const float* __restrict__ feat,
                     const float* __restrict__ w, const int* __restrict__ real,
                     int* __restrict__ out, int ptile, int parts, int block, int kreal,
                     int slots) {
  extern __shared__ float4 smem4[];
  __shared__ int run_blk[kThreads];  // block id of each run of the part
  __shared__ int warp_sum[kThreads / 32];
  pp::part<kThreads, kDirectRounds>(blk_s, feat, w, real, out, ptile, parts, block, kreal,
                                     slots, smem4, run_blk, warp_sum);
}

}  // namespace

// Weight slots one round stages for blocks of `block` triangles
// (pp::slots: room for kMinBlocks thread blocks an SM, at most 8).
extern "C" int pair_runs_slots(int block, int max_smem) {
  return pp::slots<kThreads, kMinBlocks>(block, max_smem);
}

// blk_s [p] (ascending), feat [p, 16], w [kp, 16, 4 block], real [kp];
// out [p]: p pairs in tiles of ptile, slots from pair_runs_slots.
extern "C" int pair_runs(const int* blk_s, const float* feat, const float* w, const int* real,
                         int* out, int p, int ptile, int block, int kreal, int slots,
                         cudaStream_t stream) {
  if (ptile <= 0 || p % ptile || slots < 1) return (int)cudaErrorInvalidValue;
  const int smem = slots * rw::staged_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)pair_runs_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int parts = (ptile + kThreads - 1) / kThreads;
  pair_runs_kernel<<<(p / ptile) * parts, kThreads, smem, stream>>>(
      blk_s, feat, w, real, out, ptile, parts, block, kreal, slots);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
