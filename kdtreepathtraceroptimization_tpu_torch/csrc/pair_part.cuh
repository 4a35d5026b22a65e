// The pair test's part loop, which the pair test on tiles (kernel 6,
// pair_runs.cu) and on supertiles (kernel 7, pair_bdiag.cu) both run.
//
// The function: per block-sorted (ray, block) pair, the nearest hit over
// its block's triangles packed as one int32 (t | loc). Pair p has block id
// blk_s[p] (ascending, so sentinel ids >= kreal come last) and the ray's
// _feat16t record feat[p] ([o, d, o x d, 1] and its bound t0 in column
// 10). For a real block b the result is the minimum over the block's real
// slots j of _pack_tl(t_j, j) = (bits(t_j) & ~1023) | j, with t_j the hit's
// t when the ray hits triangle j below t0 and BIG otherwise; so _PBIG when
// nothing is hit, and the pair's key orders as its nearest t, ties (within
// the 2^-13 truncation) going to the smaller j, as the TPU kernels pack
// before their min. Pairs of a sentinel block keep _PBIG. Plain version:
// `_pair_runs_ref` in kdtreepathtraceroptimization_tpu_torch/ops/pairs.py.
// A pair's result does not depend on its neighbours, so how the pairs are
// cut into tiles does not change it: kernels 6 and 7 give the same keys bit
// for bit on the same pairs.
//
// Precondition: w is a cluster table (ops/cluster.py build_cluster_mesh)
// with the zero pattern the sparse test rests on (mt_block.cuh;
// chip_smoke.py asserts it on the tables it launches these kernels on), and
// real[k] its leading slots that can hit (the rest are degenerate padding).
//
// Design: one thread per pair. A tile of ptile pairs is taken by parts of
// kThreads pairs, one thread block each (a part's last threads idle when
// ptile is not a multiple of kThreads). A block-wide scan of run starts (a
// ballot per warp, then the warp totals) gives each pair its run's index
// within the part, and each run's block id goes into a shared table.
// Rounds take the runs `slots` at a time, in order, until the first
// sentinel run (ids >= kreal sort last):
//   - the 16 sparse weight runs of each of the round's blocks, real[k]
//     slots each, arrive by cp.async in its raw slot (round_walk.cuh
//     stage), and are transposed into its table slot (a triangle's 16
//     weights contiguous: four float4 broadcasts);
//   - the copies of the next round's blocks are issued before this round
//     is tested, so they arrive meanwhile;
//   - each thread whose run is in the round runs mt::sparse_accept, 19
//     FMAs, over the real slots of its own slot's block.
// A slot is read only by the pairs of the run staged into it in the same
// round, so no thread ever reads a slot that was not written in its round.
// A part of sentinel pairs stages nothing and writes _PBIG. With
// kDirectRounds (kernel 6 only), such a part writes _PBIG before its scan,
// and a part of many short runs reads each pair's weights straight from
// global memory instead of staging them: the pair path's pass 2 spreads a
// few thousand real pairs over most of the blocks, so its busy parts hold
// tens of runs each, which would take as many rounds one after another, and
// nine in ten of its parts are sentinel pairs.
// Shared memory: `slots` staged blocks (slots()), as many as leave room for
// kMinBlocks thread blocks an SM, at most 8; so one part's tests hide
// another's staging and barriers.

#pragma once

#include "round_walk.cuh"

namespace pp {

constexpr int kLocMask = (1 << 10) - 1;
constexpr int kMaxSlots = 8;  // the TPU kernel's runs per round
// Shared memory the runtime reserves for each thread block (bytes).
constexpr int kReservedBytes = 1024;

// The kernel's static shared memory: run_blk and warp_sum (bytes).
template <int kThreads>
constexpr int static_bytes() {
  return (kThreads + kThreads / 32) * (int)sizeof(int);
}

// Weight slots one round stages for blocks of `block` triangles: as many as
// leave room for kMinBlocks thread blocks of kThreads pairs in an SM's
// shared memory (`max_smem`: the most one thread block may take, the SM's
// less the runtime's reserve), at most kMaxSlots; else as many as fit in
// one thread block alone.
template <int kThreads, int kMinBlocks>
inline int slots(int block, int max_smem) {
  const int per = rw::staged_bytes(block);
  if (per <= 0) return 0;
  const int shared =
      (max_smem + kReservedBytes) / kMinBlocks - kReservedBytes - static_bytes<kThreads>();
  int fit = shared / per;
  if (fit < 1) fit = (max_smem - static_bytes<kThreads>()) / per;
  return fit < kMaxSlots ? fit : kMaxSlots;
}

// Part blockIdx.x % parts of tile blockIdx.x / parts: blk_s [p], feat [p,
// 16], w [kp, 16, 4 block], real [kp]; out [p]. smem4 holds `slots` staged
// blocks (slots * rw::staged_bytes(block) bytes); run_blk [kThreads] and
// warp_sum [kThreads / 32] are the kernel's static shared arrays. With
// kDirectRounds > 0, a part whose real runs would take more than that many
// rounds stages nothing: each thread reads its own block's sparse weights
// from global memory (through the cache, shared by the pairs of a run) and
// tests them, the same floats in the same order; sentinel pairs do not read
// their features; and a part of sentinel pairs only writes _PBIG.
template <int kThreads, int kDirectRounds = 0>
__device__ __forceinline__ void part(const int* __restrict__ blk_s,
                                     const float* __restrict__ feat,
                                     const float* __restrict__ w,
                                     const int* __restrict__ real, int* __restrict__ out,
                                     int ptile, int parts, int block, int kreal, int slots,
                                     float4* smem4, int* run_blk, int* warp_sum) {
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
  if constexpr (kDirectRounds > 0) {
    // ids ascend: a part whose first pair is a sentinel's holds no other
    if (blk_s[row - me] >= kreal) {
      if (mine_ok) out[row] = __float_as_int(mt::kBig) & ~kLocMask;
      return;
    }
  }
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
  if (mine_ok && (kDirectRounds == 0 || mine < kreal)) {
    const float4* f4 = reinterpret_cast<const float4*>(feat + row * 16);
    const float4 p0 = f4[0], p1 = f4[1], p2 = f4[2];
    const float f[12] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, p2.y, p2.z, p2.w};
#pragma unroll
    for (int k = 0; k < mt::kFeat; ++k) rf[k] = f[k];
    t0 = f[10];
  }
  const int nr_mine = mine < kreal ? __ldg(real + mine) : 0;

  if constexpr (kDirectRounds > 0) {
    if (real_runs > kDirectRounds * slots) {  // many short runs: no staging
      int best = __float_as_int(mt::kBig) & ~kLocMask;
      const float* wk = w + (size_t)(nr_mine ? mine : 0) * 16 * 4 * block;
      for (int j = 0; j < nr_mine; ++j) {
        float wj[mt::kSparse];
#pragma unroll
        for (int i = 0; i < mt::kSparse; ++i) wj[i] = __ldg(wk + mt::sparse_run(i, block) + j);
        float a, tn;
        if (mt::sparse_accept(rf, wj, a, tn)) {
          const float t = __fdiv_rn(tn, a);
          if (t < t0) best = min(best, (__float_as_int(t) & ~kLocMask) | j);
        }
      }
      if (mine_ok) out[row] = best;
      return;
    }
  }

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

}  // namespace pp
