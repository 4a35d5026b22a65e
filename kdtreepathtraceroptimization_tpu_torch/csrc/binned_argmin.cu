// Argmin cull: per ray, the feasible cluster block of least bounding-sphere
// entry bound (the first on ties), or kp when none is feasible.
//
// Replaces the TPU kernel `_argmin_kernel` (launcher `_argmin_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/binned.py. Plain version:
// `_argmin_ref` in kdtreepathtraceroptimization_tpu_torch/ops/binned.py;
// its skip in plain form: `_argmin_grouped`.
//
// The entry bound is the sphere cull's (cluster_entry.cuh), rounded the
// same way, so the bins equal the plain version's bit for bit. A strict <
// over the blocks in index order keeps the first minimum, as jnp.argmin and
// torch.argmin do; infeasible blocks (BIG) never replace the start value.
//
// Bound on this card: operations. Each (live ray, real block) test is about
// 24 f32 operations against 32 bytes read and 4 written per ray, none an
// FMA (unfused, for bit equality). So the kernel runs fewer tests than
// every live ray x every real block:
//   - Live rays only. A thread block takes kThreads consecutive rays; a
//     dead ray's bin is kp, written without a test, and the live rays are
//     compacted in order (a block-wide prefix count of warp ballots), one a
//     lane, so no lane of a working warp is dead.
//   - Groups first. The blocks form aligned groups of kGroup (the cluster
//     tree's subtrees). The bounding sphere of each group is built once a
//     call, in f64 (cluster_entry.cuh group_sphere, one thread a group, by
//     a first kernel into scratch that also lays the block table out as
//     three float4 a block), and its widened entry (group_bound) is BIG
//     where the ray can meet no member and otherwise no later than any
//     member's entry (cluster_entry.cuh argues both).
//   - Best so far. A ray takes the groups in index order and tests a
//     group's members only if the group's entry lies below its best entry
//     so far: a member of a skipped group is not below that best, so under
//     the strict < it could not have replaced it, and the first minimum
//     stays. A warp runs a group's member tests only where some lane needs
//     them (__any_sync); a lane that does not need them keeps its best.
//   - The block table and the group spheres are staged in shared memory in
//     chunks of kChunk blocks (whole groups; one chunk on the main paths);
//     each lane reads the same block at once (a broadcast).
//
// Launch shape, from `chip_smoke.py --shapes binned_argmin` (H100 80GB
// HBM3, 700 W; the binned path's bounce-1 call: 640,000 rays, 521,172
// live, 512 blocks): 128 threads and groups of 8 took 0.200-0.208 ms; 256
// threads 0.210-0.214, 512 0.222-0.228, 1,024 (one thread block an SM)
// 0.248-0.258; groups of 4 0.224, of 16 0.247. Two forms tried there lost
// and left the source: reading the tables through L1 rather than shared
// memory (0.215 ms at 128 threads), and a first pass of group tests alone
// that compacted the rays some group passes for (25% of the live rays)
// before the member tests (0.259 at 128 threads, 0.356 at 1,024): the
// group tests, not the member tests, take most of the time.

#include "cluster_entry.cuh"

namespace {

constexpr int kThreads = 128;  // rays (threads) a thread block
constexpr int kGroup = 8;      // blocks a group (ops/cluster.py CULL_GROUP)
constexpr int kChunk = 512;    // blocks staged at once (whole groups)
constexpr int kWarps = kThreads / 32;
constexpr int kChunkGroups = kChunk / kGroup;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kWarps <= 32, "whole warps, one scan warp");
static_assert(kChunk % kGroup == 0, "a chunk holds whole groups");

// The tables, once a call: group q's sphere at gs[2q], gs[2q + 1]; block
// k's three float4 {c (d.c), c'_x}, {c'_yz (o.c), radius, cc}, {r2} at
// bs[3k .. 3k + 2].
__global__ void argmin_tables_kernel(const float* __restrict__ cull_w,
                                     const float* __restrict__ blk, float4* __restrict__ gs,
                                     float4* __restrict__ bs, int kp) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t * kGroup < kp)
    entry::group_sphere(cull_w, blk, kp, t * kGroup, min(kp, (t + 1) * kGroup), gs + 2 * t);
  if (t < kp) {
    float b[entry::kBlockFloats];
    entry::load_block(cull_w, blk, kp, t, b);
    bs[3 * t] = make_float4(b[0], b[1], b[2], b[3]);
    bs[3 * t + 1] = make_float4(b[4], b[5], b[6], b[7]);
    bs[3 * t + 2] = make_float4(b[8], 0.f, 0.f, 0.f);
  }
}

// Shared memory of one thread block: a chunk's blocks and groups, the
// compacted rays and the scan's warp totals.
struct Smem {
  float4 blocks[kChunk * 3];
  float4 groups[kChunkGroups * 2];
  int rays[kThreads];
  int scan[32];
};

// The rays ``ray`` of the lanes whose ``flag`` holds, in lane order, into
// sm.rays; returns how many (the same in every thread).
__device__ __forceinline__ int compact(Smem& sm, bool flag, int ray) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned ballot = __ballot_sync(kFull, flag);
  if (lane == 0) sm.scan[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? sm.scan[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += v;
    }
    if (lane < kWarps) sm.scan[lane] = w;  // inclusive, over warps
  }
  __syncthreads();
  const int total = sm.scan[kWarps - 1];
  if (flag) sm.rays[(warp ? sm.scan[warp - 1] : 0) + __popc(ballot & ((1u << lane) - 1u))] = ray;
  __syncthreads();
  return total;
}

// Chunk k0's blocks and groups into shared memory (all threads).
__device__ __forceinline__ void stage(Smem& sm, const float4* __restrict__ gs,
                                      const float4* __restrict__ bs, int k0, int nk) {
  __syncthreads();  // every warp is done with the previous chunk
  for (int v = threadIdx.x; v < 3 * nk; v += kThreads) sm.blocks[v] = bs[3 * k0 + v];
  for (int v = threadIdx.x; v < 2 * ((nk + kGroup - 1) / kGroup); v += kThreads)
    sm.groups[v] = gs[2 * (k0 / kGroup) + v];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
binned_argmin_kernel(const float* __restrict__ x, const float4* __restrict__ gs,
                     const float4* __restrict__ bs, int* __restrict__ bins, int n, int kp) {
  __shared__ Smem sm;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n && x[(size_t)i * 8 + 7] > 0.f;
  if (i < n && !live) bins[i] = kp;  // a dead ray has no feasible block

  // 1. the live rays, compacted in order, one a lane
  const int count = compact(sm, live, i);
  if (count == 0) return;  // the whole thread block: no live ray
  const int j = warp * 32 + lane;
  const bool mine = j < count;
  const int ray = mine ? sm.rays[j] : 0;
  entry::Ray r = {};
  entry::GroupMargins m = {};
  if (mine) {
    r = entry::load_ray(x + (size_t)ray * 8);
    m = entry::group_margins(r);
  }
  const bool one_chunk = kp <= kChunk;
  if (one_chunk) stage(sm, gs, bs, 0, kp);

  // 2. each ray's best: groups in index order, a group's members only
  // where its entry lies below the best so far
  float best = entry::kBig;
  int bin = kp;
  for (int k0 = 0; k0 < kp; k0 += kChunk) {
    const int nk = min(kChunk, kp - k0);
    if (!one_chunk) stage(sm, gs, bs, k0, nk);
    if (warp * 32 >= count) continue;  // no ray in this warp
    for (int q = 0; q < (nk + kGroup - 1) / kGroup; ++q) {
      const bool need = mine && entry::group_bound(r, m, sm.groups[2 * q],
                                                   sm.groups[2 * q + 1]) < best;
      if (!__any_sync(kFull, need)) continue;
      for (int k = q * kGroup; k < min(nk, (q + 1) * kGroup); ++k) {
        const float4* v = sm.blocks + 3 * k;
        const float4 v2 = v[2];
        if (!(v2.x >= 0.f)) continue;  // sentinel block: BIG
        const float4 v0 = v[0], v1 = v[1];
        const float b[entry::kBlockFloats] = {v0.x, v0.y, v0.z, v0.w, v1.x,
                                              v1.y, v1.z, v1.w, v2.x};
        const float e = entry::bound(r, b);
        if (need && e < best) {
          best = e;
          bin = k0 + k;
        }
      }
    }
  }
  if (mine) bins[ray] = bin;
}

}  // namespace

// Floats of scratch the wrapper allocates for a table of kp blocks: two
// float4 a group and three a block.
extern "C" int binned_argmin_scratch_floats(int kp) {
  return ((kp + kGroup - 1) / kGroup) * 8 + kp * 12;
}

// x [n, 8] ray records, cull_w [8, 2kp], blk [8, kp]; scratch
// binned_argmin_scratch_floats(kp) floats (16-byte aligned); bins [n].
extern "C" int binned_argmin(const float* x, const float* cull_w, const float* blk,
                             float* scratch, int* bins, int n, int kp, cudaStream_t stream) {
  float4* gs = reinterpret_cast<float4*>(scratch);
  float4* bs = gs + 2 * ((kp + kGroup - 1) / kGroup);
  if (kp > 0) {
    argmin_tables_kernel<<<(kp + 127) / 128, 128, 0, stream>>>(cull_w, blk, gs, bs, kp);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  binned_argmin_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(x, gs, bs, bins,
                                                                               n, kp);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
