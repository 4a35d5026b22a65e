// Pair test on supertiles: the function of pair_runs.cu (per block-sorted
// (ray, block) pair, the nearest hit over its block's triangles packed as
// one int32 (t | loc)), with several runs' weight blocks staged at once so
// that the pairs of all of them test in the same pass.
//
// Replaces the TPU kernel `_pair_bdiag_kernel` (launcher `_pair_bdiag_pallas`)
// in kdtreepathtraceroptimization_tpu/ops/pairs.py. Plain version:
// `_pair_runs_ref` in kdtreepathtraceroptimization_tpu_torch/ops/pairs.py
// (the same function as kernel 6's, whose results these equal bit for bit:
// the same accept chain, division and packing per (pair, triangle)).
//
// The TPU kernel packs up to 8 runs into one 128-deep matmul so that short
// runs still fill its matrix unit. The GPU's counterpart is idle threads:
// in pair_runs.cu only the current run's threads test while the rest of the
// thread block waits at the barrier. Here a round stages up to `slots` runs'
// blocks, one shared-memory slot each, and every thread whose pair lies in
// one of them tests its own slot's triangles at the same time.
//
// Design: one thread block of ptile threads per supertile of ptile pairs,
// one thread per pair (ptile <= 1024, a multiple of 32). A block-wide scan
// of run starts (a ballot per warp, then the warp totals) gives each pair
// its run's index within the tile, and each run's block id goes into a
// shared table. Rounds take the runs slots at a time, in order, until the
// first sentinel run (ids >= kreal sort last) or the tile's end: stage each
// of the round's blocks into its slot (mt::stage_block), synchronise, and
// let each thread whose run is in the round test that slot. A slot is read
// only by the pairs of the run staged into it in the same round, so no
// thread ever reads a slot that was not written in its round (the TPU
// kernel multiplies every slot and relies on unstaged ones holding zeros,
// which nothing guarantees). Staging is not overlapped with compute
// (cp.async / TMA double buffering is left for later).
//
// Registers: 1024 threads leave at most 64 a thread; __launch_bounds__(1024)
// holds the compiler to that, and `-Xptxas -v` reports any spill.
//
// Bound on this card: operations, as kernel 6's: each (pair, triangle)
// test is 40 FMAs and about 10 more f32 operations, against 64 bytes read
// and 4 written per pair.

#include "mt_block.cuh"

namespace {

constexpr int kLocMask = (1 << 10) - 1;
constexpr int kMaxTile = 1024;
constexpr int kMaxSlots = 8;  // the TPU kernel's runs per round
// The kernel's static shared memory (run_blk and warp_sum), which the
// dynamic slots share the thread block's limit with.
constexpr int kStaticBytes = (kMaxTile + kMaxTile / 32) * (int)sizeof(int);

__global__ void __launch_bounds__(kMaxTile)
    pair_bdiag_kernel(const int* __restrict__ blk_s, const float* __restrict__ feat,
                      const float* __restrict__ w, int* __restrict__ out, int block,
                      int kreal, int slots) {
  extern __shared__ float4 sw4[];
  float* sw = reinterpret_cast<float*>(sw4);
  __shared__ int run_blk[kMaxTile];  // block id of each run of the tile
  __shared__ int warp_sum[kMaxTile / 32];

  const int ptile = blockDim.x;
  const int me = threadIdx.x;
  const int lane = me & 31;
  const int warp = me >> 5;
  const size_t row = (size_t)blockIdx.x * ptile + me;
  const int mine = blk_s[row];
  const bool starts = me == 0 || blk_s[row - 1] != mine;

  // Inclusive scan of the run starts: my run's index is the count of
  // starts up to me, less one.
  const unsigned ballot = __ballot_sync(0xffffffffu, starts);
  int run = __popc(ballot & (0xffffffffu >> (31 - lane)));
  if (lane == 31) warp_sum[warp] = run;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = ptile >> 5;
    int v = lane < n_warps ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (lane < n_warps) warp_sum[lane] = v;  // inclusive totals
  }
  __syncthreads();
  run += (warp > 0 ? warp_sum[warp - 1] : 0) - 1;
  if (starts) run_blk[run] = mine;
  // Sentinel ids sort after every real one, so the real runs are a prefix:
  // their count is the count of real run starts. (Also the barrier after
  // run_blk is written.)
  const int real_runs = __syncthreads_count(starts && mine < kreal);

  float rf[mt::kFeat];
#pragma unroll
  for (int f = 0; f < mt::kFeat; ++f) rf[f] = feat[row * 16 + f];
  const float t0 = feat[row * 16 + 10];
  const int staged = mt::kTriFloats * block;  // floats per slot

  const int pbig = __float_as_int(mt::kBig) & ~kLocMask;
  int best = pbig;
  for (int r0 = 0; r0 < real_runs; r0 += slots) {
    const int r1 = min(real_runs, r0 + slots);
    // The barrier at the loop's end keeps the previous round's readers
    // ahead of these writes.
    for (int s = 0; s < r1 - r0; ++s)
      mt::stage_block(sw + s * staged, w + (size_t)run_blk[r0 + s] * 16 * 4 * block, block);
    __syncthreads();
    if (run >= r0 && run < r1) {
      const float4* slot4 = sw4 + (size_t)(run - r0) * (staged / 4);
      for (int j = 0; j < block; ++j) {
        float wj[mt::kTriFloats];
        mt::load_tri(slot4, j, wj);
        float a, tn;
        if (mt::accept(rf, wj, a, tn)) {
          const float t = __fdiv_rn(tn, a);
          if (t < t0) best = min(best, (__float_as_int(t) & ~kLocMask) | j);
        }
      }
    }
    __syncthreads();
  }
  out[row] = best;
}

}  // namespace

// Weight slots one round stages for blocks of `block` triangles: as many
// as the shared memory of one thread block (`max_smem` bytes) holds beside
// the kernel's own tables, at most 8.
extern "C" int pair_bdiag_slots(int block, int max_smem) {
  const int per = mt::staged_bytes(block);
  const int fit = per > 0 ? (max_smem - kStaticBytes) / per : 0;
  return fit < kMaxSlots ? fit : kMaxSlots;
}

extern "C" int pair_bdiag(const int* blk_s, const float* feat, const float* w, int* out,
                          int p, int ptile, int block, int kreal, int slots,
                          cudaStream_t stream) {
  const int smem = slots * mt::staged_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)pair_bdiag_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pair_bdiag_kernel<<<p / ptile, ptile, smem, stream>>>(blk_s, feat, w, out, block, kreal,
                                                        slots);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
