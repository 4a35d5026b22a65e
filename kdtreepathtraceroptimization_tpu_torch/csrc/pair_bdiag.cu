// Pair test on supertiles: the function of pair_runs.cu (per block-sorted
// (ray, block) pair, the nearest hit over its block's triangles packed as
// one int32 (t | loc)), with several runs' weight blocks staged at once so
// that the pairs of all of them test in the same pass.
//
// Replaces the TPU kernel `_pair_bdiag_kernel` (launcher `_pair_bdiag_pallas`)
// in kdtreepathtraceroptimization_tpu/ops/pairs.py. Plain version:
// `_pair_runs_ref` in kdtreepathtraceroptimization_tpu_torch/ops/pairs.py
// (the same function as kernel 6's, whose results these equal bit for bit:
// the same hits, division and packing per (pair, triangle); kernel 6 runs
// the dense test, this one the sparse test, which gives the same floats).
//
// The TPU kernel packs up to 8 runs into one 128-deep matmul so that short
// runs still fill its matrix unit. The GPU's counterpart is idle threads:
// in pair_runs.cu only the current run's threads test while the rest of the
// thread block waits at the barrier. Here a round stages up to `slots` runs'
// blocks, one shared-memory slot each, and every thread whose pair lies in
// one of them tests its own slot's triangles at the same time.
//
// Precondition: w is a cluster table (ops/cluster.py build_cluster_mesh)
// with the zero pattern the sparse test rests on (mt_block.cuh;
// chip_smoke.py asserts it on the table it launches this kernel on), and
// real[k] its leading slots that can hit (the rest are degenerate padding).
//
// Design: one thread per pair. A supertile of ptile pairs is taken by
// parts of kThreads pairs, one thread block each (a supertile of 1024 pairs
// is four; a pair's result does not depend on its neighbours, so the parts
// are independent). A block-wide scan of run starts (a ballot per warp,
// then the warp totals) gives each pair its run's index within the part,
// and each run's block id goes into a shared table. Rounds take the runs
// slots at a time, in order, until the first sentinel run (ids >= kreal
// sort last):
//   - the 16 sparse weight runs of each of the round's blocks, real[k]
//     slots each, arrive by cp.async in its raw slot (round_walk.cuh
//     stage), and are transposed into its table slot (a triangle's 16
//     weights contiguous: four float4 broadcasts);
//   - the copies of the next round's blocks are issued before this round
//     is tested, so they arrive meanwhile;
//   - each thread whose run is in the round runs mt::sparse_accept, 19
//     FMAs, over the real slots of its own slot's block.
// A slot is read only by the pairs of the run staged into it in the same
// round, so no thread ever reads a slot that was not written in its round
// (the TPU kernel multiplies every slot and relies on unstaged ones holding
// zeros, which nothing guarantees).
// Shared memory: `slots` staged blocks, as many as leave room for
// kMinBlocks thread blocks an SM, at most 8 (two of 256 triangles); so
// one part's tests hide another's staging and barriers. On the main path a
// part of 256 pairs holds 1.68 runs on average and 3 at most. Launch shape
// (the fastest of those chip_smoke.py --shapes times on the pair_bdiag
// path's call): 256 pairs a thread block, three an SM, 0.069 ms against
// 0.072 for two (three slots) and 0.072 for 512-pair blocks (H100 80GB
// HBM3, 700 W).
//
// Bound on this card: operations, as kernel 6's: each (real pair, real
// triangle) test is 19 FMAs and 8 more f32 operations, against 64 bytes
// read and 4 written a pair and the 16 weights of each real triangle of a
// block some pair names.

#include "round_walk.cuh"

namespace {

constexpr int kLocMask = (1 << 10) - 1;
constexpr int kThreads = 256;   // pairs (threads) a thread block
constexpr int kMinBlocks = 3;   // thread blocks an SM must hold
constexpr int kMaxSlots = 8;    // the TPU kernel's runs per round
// The kernel's static shared memory (run_blk and warp_sum), and the
// shared memory the runtime reserves for each thread block (bytes).
constexpr int kStaticBytes = (kThreads + kThreads / 32) * (int)sizeof(int);
constexpr int kReservedBytes = 1024;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    pair_bdiag_kernel(const int* __restrict__ blk_s, const float* __restrict__ feat,
                      const float* __restrict__ w, const int* __restrict__ real,
                      int* __restrict__ out, int ptile, int parts, int block, int kreal,
                      int slots) {
  extern __shared__ float4 smem4[];
  __shared__ int run_blk[kThreads];  // block id of each run of the part
  __shared__ int warp_sum[kThreads / 32];
  const int stride = rw::raw_stride(block);
  const int rawf = rw::raw_floats(block);
  const int tbf = rw::tb_floats(block);
  float* raw = reinterpret_cast<float*>(smem4);  // slots raw runs, then slots tables
  float* tb = raw + slots * rawf;

  const int me = threadIdx.x;
  const int lane = me & 31;
  const int warp = me >> 5;
  const int q0 = (blockIdx.x % parts) * kThreads;  // this part's first pair in the tile
  const bool mine_ok = q0 + me < ptile;
  const size_t row = (size_t)(blockIdx.x / parts) * ptile + q0 + me;
  const int mine = mine_ok ? blk_s[row] : kreal;
  const bool starts = mine_ok && (me == 0 || blk_s[row - 1] != mine);

  // Inclusive scan of the run starts: my run's index is the count of
  // starts up to me, less one.
  const unsigned ballot = __ballot_sync(0xffffffffu, starts);
  int run = __popc(ballot & (0xffffffffu >> (31 - lane)));
  if (lane == 31) warp_sum[warp] = run;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kThreads / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < kThreads / 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (lane < kThreads / 32) warp_sum[lane] = v;  // inclusive totals
  }
  __syncthreads();
  run += (warp > 0 ? warp_sum[warp - 1] : 0) - 1;
  if (starts) run_blk[run] = mine;
  // Sentinel ids sort after every real one, so the real runs are a prefix:
  // their count is the count of real run starts. (Also the barrier after
  // run_blk is written.)
  const int real_runs = __syncthreads_count(starts && mine < kreal);

  float rf[mt::kFeat] = {};
  float t0 = 0.f;
  if (mine_ok) {
    const float4* f4 = reinterpret_cast<const float4*>(feat + row * 16);
    const float4 p0 = f4[0], p1 = f4[1], p2 = f4[2];
    const float f[12] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, p2.y, p2.z, p2.w};
#pragma unroll
    for (int k = 0; k < mt::kFeat; ++k) rf[k] = f[k];
    t0 = f[10];
  }
  const int nr_mine = mine < kreal ? __ldg(real + mine) : 0;

  // the first round's blocks
  for (int s = 0; s < min(real_runs, slots); ++s)
    rw::stage<kThreads>(raw + s * rawf, w, run_blk[s], __ldg(real + run_blk[s]), block, stride);
  mt::cp_async_commit();
  mt::cp_async_wait_all();
  __syncthreads();

  const int pbig = __float_as_int(mt::kBig) & ~kLocMask;
  int best = pbig;
  for (int r0 = 0; r0 < real_runs; r0 += slots) {
    const int r1 = min(real_runs, r0 + slots);
    for (int s = 0; s < r1 - r0; ++s)
      rw::transpose<kThreads>(tb + s * tbf, raw + s * rawf, __ldg(real + run_blk[r0 + s]),
                              stride);
    __syncthreads();  // the tables hold this round's blocks; raw is free
    for (int s = 0; s < min(real_runs, r1 + slots) - r1; ++s)
      rw::stage<kThreads>(raw + s * rawf, w, run_blk[r1 + s], __ldg(real + run_blk[r1 + s]),
                          block, stride);
    mt::cp_async_commit();  // the next round's blocks arrive while this one is tested
    if (mine_ok && run >= r0 && run < r1) {
      const float4* slot4 = reinterpret_cast<const float4*>(tb + (run - r0) * tbf);
      for (int j = 0; j < nr_mine; ++j) {
        float wj[mt::kSparse];
        mt::load_sparse(slot4, j, wj);
        float a, tn;
        if (mt::sparse_accept(rf, wj, a, tn)) {
          const float t = __fdiv_rn(tn, a);
          if (t < t0) best = min(best, (__float_as_int(t) & ~kLocMask) | j);
        }
      }
    }
    mt::cp_async_wait_all();
    __syncthreads();  // every thread is done with the tables; raw holds the next round
  }
  if (mine_ok) out[row] = best;
}

}  // namespace

// Weight slots one round stages for blocks of `block` triangles: as many as
// leave room for kMinBlocks thread blocks of the kernel in an SM's shared
// memory (`max_smem`: the most one thread block may take, the SM's less
// the runtime's reserve), at most 8; else as many as fit in one thread
// block alone.
extern "C" int pair_bdiag_slots(int block, int max_smem) {
  const int per = rw::staged_bytes(block);
  if (per <= 0) return 0;
  const int shared = (max_smem + kReservedBytes) / kMinBlocks - kReservedBytes - kStaticBytes;
  int fit = shared / per;
  if (fit < 1) fit = (max_smem - kStaticBytes) / per;
  return fit < kMaxSlots ? fit : kMaxSlots;
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
