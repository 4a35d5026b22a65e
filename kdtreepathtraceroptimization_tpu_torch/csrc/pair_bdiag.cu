// Pair test on supertiles: the function of pair_runs.cu (per block-sorted
// (ray, block) pair, the nearest hit over its block's triangles packed as
// one int32 (t | loc)), with several runs' weight blocks staged at once so
// that the pairs of all of them test in the same pass.
//
// Replaces the TPU kernel `_pair_bdiag_kernel` (launcher `_pair_bdiag_pallas`)
// in kdtreepathtraceroptimization_tpu/ops/pairs.py. Plain version:
// `_pair_runs_ref` in kdtreepathtraceroptimization_tpu_torch/ops/pairs.py
// (the same function as kernel 6's, whose results these equal bit for bit:
// both run the part loop of pair_part.cuh).
//
// The TPU kernel packs up to 8 runs into one 128-deep matmul so that short
// runs still fill its matrix unit. The GPU's counterpart is idle threads:
// a round stages up to `slots` runs' blocks, one shared-memory slot each,
// and every thread whose pair lies in one of them tests its own slot's
// triangles at the same time. On this card that is kernel 6's design too;
// the two differ in their tiles (supertiles of pair_bdiag_tile pairs here)
// and launch shapes only.
//
// Precondition: pair_part.cuh's (the table's zero pattern and real slots).
//
// The part loop is pair_part.cuh's, which kernel 6 (pair_runs.cu) runs
// too: one thread per pair; a supertile of ptile pairs is taken by parts of
// kThreads pairs, one thread block each (a supertile of 1024 pairs is
// four); rounds stage up to `slots` runs' real slots by cp.async, the next
// round's copies in flight while a round runs the sparse test.
// Launch shape (the fastest of those chip_smoke.py --shapes times on the
// pair_bdiag path's call): 256 pairs a thread block, three an SM, 0.069 ms
// against 0.072 for two (three slots) and 0.072 for 512-pair blocks (H100
// 80GB HBM3, 700 W). On the main path a part of 256 pairs holds 1.68 runs
// on average and 3 at most.
//
// Bound on this card: operations, as kernel 6's: each (real pair, real
// triangle) test is 19 FMAs and 8 more f32 operations, against 64 bytes
// read and 4 written a pair and the 16 weights of each real triangle of a
// block some pair names.

#include "pair_part.cuh"

namespace {

constexpr int kThreads = 256;   // pairs (threads) a thread block
constexpr int kMinBlocks = 3;   // thread blocks an SM must hold

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pair_bdiag_kernel(const int* __restrict__ blk_s, const float* __restrict__ feat,
                      const float* __restrict__ w, const int* __restrict__ real,
                      int* __restrict__ out, int ptile, int parts, int block, int kreal,
                      int slots) {
  extern __shared__ float4 smem4[];
  __shared__ int run_blk[kThreads];  // block id of each run of the part
  __shared__ int warp_sum[kThreads / 32];
  pp::part<kThreads>(blk_s, feat, w, real, out, ptile, parts, block, kreal, slots, smem4,
                     run_blk, warp_sum);
}

}  // namespace

// Weight slots one round stages for blocks of `block` triangles
// (pp::slots: room for kMinBlocks thread blocks an SM, at most 8).
extern "C" int pair_bdiag_slots(int block, int max_smem) {
  return pp::slots<kThreads, kMinBlocks>(block, max_smem);
}

// blk_s [p] (ascending), feat [p, 16], w [kp, 16, 4 block], real [kp];
// out [p]: p pairs in supertiles of ptile, slots from pair_bdiag_slots.
extern "C" int pair_bdiag(const int* blk_s, const float* feat, const float* w, const int* real,
                          int* out, int p, int ptile, int block, int kreal, int slots,
                          cudaStream_t stream) {
  if (ptile <= 0 || p % ptile || slots < 1) return (int)cudaErrorInvalidValue;
  const int smem = slots * rw::staged_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)pair_bdiag_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int parts = (ptile + kThreads - 1) / kThreads;
  pair_bdiag_kernel<<<(p / ptile) * parts, kThreads, smem, stream>>>(
      blk_s, feat, w, real, out, ptile, parts, block, kreal, slots);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
