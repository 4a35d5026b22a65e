// The tile-min loop of the two cull kernels, slab_cull.cu (kernel 1, AABB
// entries) and cluster_cull.cu (kernel 9, bounding-sphere entries):
//
//   out[g, k] = min over the rays i of ray tile g of entry(i, k),
//
// BIG where no ray of the tile can enter block k. An entry policy P gives
// the ray record, the staged block and group, the group test and the
// member test (the entry, or BIG).
//
// Design (the notes of slab_cull.cu and cluster_cull.cu have the times):
//   - Slices. Thread block (g, s) takes ray tile g against slice s of the
//     block axis, `slice` blocks (a multiple of the group); the slices of
//     one tile are neighbours in the grid, so they read its rays from L2.
//     The launcher makes a slice as long as shared memory allows, so a
//     table of the main paths' 512 blocks takes one slice a tile and only
//     a larger table is split. Each thread block writes its own part of
//     the output row: no atomics in device memory, no memset, no second
//     pass.
//   - Live rays only. The thread block stages its tile's live rays (act >
//     0) to the front of shared memory, in order, by a block-wide prefix
//     count; dead rays add nothing to a tile's min. A tile with no live ray
//     writes its part of the row as BIG and stages nothing else.
//   - One lane per ray, groups first. A warp takes 32 staged rays (a
//     "ray-warp") and the slice's aligned groups of kGroup blocks in turn;
//     it runs a group's member tests only if the group test passes for one
//     of its rays (__any_sync), each lane reading the same staged member
//     (a broadcast). The policy's group test passes wherever one of the
//     group's members may have an entry below BIG (its header has the
//     argument), so the skip changes no output.
//   - Few ray-warps. When a tile has fewer ray-warps than the thread block
//     has warps, the slice's groups are dealt out over the idle warps too.
//   - The min without float atomics. Entries are >= 0 or BIG, so their bits
//     order as unsigned integers once the sign bit is cleared (fmaxf(x, 0)
//     may give -0.0, whose bits would order above BIG's). Per member tested:
//     one __reduce_min_sync over the warp's lanes, then one lane's
//     shared-memory atomicMin into the thread block's row; at the end one
//     coalesced store of the row.
//
// The member tests are the plain versions' float32 operations, unfused, so
// the output equals the plain version bit for bit (+0.0 where it may have
// -0.0, which compares equal).

#pragma once

#include <cuda_runtime.h>

namespace tcull {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;

// Shared memory of one thread block: the slice's groups and blocks, the
// tile's staged rays, the row and the scan's warp totals.
template <class P>
__host__ __device__ inline int smem_bytes(int tile, int slice, int group) {
  const int groups = (slice + group - 1) / group;
  return (groups * P::kGroupVecs + slice * P::kBlockVecs) * 16 +
         (P::kRayFloats * tile + slice + 32) * 4;
}

template <class P, int kThreads, int kGroup>
__device__ __forceinline__ void tile_min(const float* __restrict__ x,
                                         const float* __restrict__ table,
                                         const float* __restrict__ blk,
                                         float* __restrict__ out, int kp, int tile,
                                         int slices, int slice) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0 && kWarps <= 32, "whole warps, one scan warp");
  static_assert(kGroup > 0, "blocks a group");
  extern __shared__ float4 smem[];
  const int g = blockIdx.x / slices;
  const int k0 = (blockIdx.x % slices) * slice;
  const int kc = min(slice, kp - k0);
  const int ngs = (kc + kGroup - 1) / kGroup;
  float4* sg = smem;                                          // groups
  float4* sb = sg + ((slice + kGroup - 1) / kGroup) * P::kGroupVecs;  // blocks
  float* sr = reinterpret_cast<float*>(sb + slice * P::kBlockVecs);  // rays, SoA
  unsigned* row = reinterpret_cast<unsigned*>(sr + P::kRayFloats * tile);
  int* scan = reinterpret_cast<int*>(row + slice);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* orow = out + (size_t)g * kp + k0;

  // 1. the tile's live rays, compacted in order: thread t takes a run of
  // adjacent rays, counts its live ones, and a block-wide prefix count
  // gives each its slot
  const float* xt = x + (size_t)g * tile * P::kStride;
  const int per = (tile + kThreads - 1) / kThreads;
  const int i0 = min(tile, (int)threadIdx.x * per), i1 = min(tile, i0 + per);
  int mine = 0;
  for (int i = i0; i < i1; ++i) mine += P::live(xt, i);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? scan[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += v;
    }
    if (lane < kWarps) scan[lane] = w;  // inclusive, over warps
  }
  __syncthreads();
  const int live = scan[kWarps - 1];
  if (live == 0) {  // no live ray: the row stays BIG
    for (int j = threadIdx.x; j < kc; j += kThreads) orow[j] = kBig;
    return;
  }
  int slot = (warp ? scan[warp - 1] : 0) + incl - mine;
  for (int i = i0; i < i1; ++i)
    if (P::live(xt, i)) P::stage_ray(xt, i, sr, tile, slot++);

  // 2. the slice's blocks, the row, then the groups
  const unsigned big = __float_as_uint(kBig);
  for (int j = threadIdx.x; j < kc; j += kThreads) {
    P::stage_block(table, blk, kp, k0 + j, sb + j * P::kBlockVecs);
    row[j] = big;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < ngs; q += kThreads)  // a group from its staged members
    P::stage_group(table, blk, kp, k0 + q * kGroup, k0 + min(kc, (q + 1) * kGroup),
                   sb + q * kGroup * P::kBlockVecs, sg + q * P::kGroupVecs);
  __syncthreads();

  // 3. each warp: ray-warps against groups, then their met members
  const int nrw = (live + 31) / 32;
  const int parts = max(1, min(ngs, kWarps / nrw));  // warps a ray-warp
  for (int item = warp; item < nrw * parts; item += kWarps) {
    const int j = (item % nrw) * 32 + lane;
    const bool valid = j < live;
    const typename P::Ray r = P::load_ray(sr, tile, valid ? j : 0);
    for (int q = item / nrw; q < ngs; q += parts) {
      const bool meet = valid && P::meets(r, sg + q * P::kGroupVecs);
      if (!__any_sync(kFull, meet)) continue;
      for (int k = q * kGroup; k < min(kc, (q + 1) * kGroup); ++k) {
        const float4* b = sb + k * P::kBlockVecs;
        if (!P::real(b)) continue;  // sentinel block: stays BIG
        const float e = valid ? P::member(r, b) : kBig;
        const unsigned m = __reduce_min_sync(kFull, __float_as_uint(e) & 0x7fffffffu);
        if (lane == 0 && m < big) atomicMin(row + k, m);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kc; j += kThreads) orow[j] = __uint_as_float(row[j]);
}

// The slice length in blocks for a table of kp blocks in groups of
// `group`: the most whole groups whose thread block fits in `max_smem`
// bytes of shared memory, at most the whole table; 0 if even one group
// does not fit.
template <class P>
inline int slice_blocks(int kp, int tile, int group, int max_smem) {
  const int ng = (kp + group - 1) / group;
  int fit = 0;  // groups a slice may hold
  while (fit < ng && smem_bytes<P>(tile, (fit + 1) * group, group) <= max_smem) ++fit;
  return fit * group;
}

}  // namespace tcull
