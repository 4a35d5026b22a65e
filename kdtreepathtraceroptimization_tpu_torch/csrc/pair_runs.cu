// Pair test: per tile of block-sorted (ray, block) pairs, each run of
// pairs with the same block against that block's triangles; per pair the
// nearest hit packed as one int32 (t | loc).
//
// Replaces the TPU kernel `_pair_runs_kernel` (launcher `_pair_runs_pallas`)
// in kdtreepathtraceroptimization_tpu/ops/pairs.py. Plain version:
// `_pair_runs_ref` in kdtreepathtraceroptimization_tpu_torch/ops/pairs.py.
//
// Pair p has block id blk_s[p] (ascending, so sentinel ids >= kreal come
// last) and the ray's _feat16t record feat[p] ([o, d, o x d, 1] and its
// bound t0 in column 10). For a real block b the result is the minimum
// over the block's triangles j of _pack_tl(t_j, j) = (bits(t_j) & ~1023)
// | j, with t_j the hit's t when the ray hits triangle j below t0 and BIG
// otherwise; so _PBIG when nothing is hit, and the pair's packed key
// orders as its nearest t, ties (within the 2^-13 truncation) going to the
// smaller j, as the TPU kernel packs before its min. Pairs from the first
// sentinel run on keep _PBIG.
//
// Bound on this card: operations. Each (pair, triangle) test is 40 FMAs
// and ~10 more f32 operations, against 64 bytes read and 4 written per
// pair and weights (40 KB per block at B = 256) that stay in L2.
// Design: one thread block per tile of ptile pairs, one thread per pair.
// The block walks the tile's runs in order: __syncthreads_count gives the
// run's end (the pairs of block b from r0 on; a run that goes on into the
// next tile is cut at the tile's end and finished there), the block's
// weights are staged in shared memory (mt::stage_block), and the run's
// threads test every triangle, all reading the same one at once (a
// broadcast). Runs per tile are few when pairs per block exceed the tile.
// The loop ends at the first sentinel run or the tile's end. Staging is
// not overlapped with compute (cp.async / TMA double buffering is left for
// later).

#include "mt_block.cuh"

namespace {

constexpr int kLocMask = (1 << 10) - 1;

__global__ void pair_runs_kernel(const int* __restrict__ blk_s,
                                 const float* __restrict__ feat,
                                 const float* __restrict__ w, int* __restrict__ out,
                                 int block, int kreal) {
  extern __shared__ float4 sw4[];
  float* sw = reinterpret_cast<float*>(sw4);
  const int ptile = blockDim.x;
  const int me = threadIdx.x;
  const size_t row = (size_t)blockIdx.x * ptile + me;
  const int* tile_blk = blk_s + (size_t)blockIdx.x * ptile;
  const int mine = blk_s[row];

  float rf[mt::kFeat];
#pragma unroll
  for (int f = 0; f < mt::kFeat; ++f) rf[f] = feat[row * 16 + f];
  const float t0 = feat[row * 16 + 10];

  const int pbig = __float_as_int(mt::kBig) & ~kLocMask;
  int best = pbig;
  for (int r0 = 0; r0 < ptile;) {
    const int b = tile_blk[r0];  // the same for every thread
    if (b >= kreal) break;      // the first sentinel run: the rest are too
    // Also the barrier before sw is written again.
    const int r1 = r0 + __syncthreads_count(me >= r0 && mine == b);
    mt::stage_block(sw, w + (size_t)b * 16 * 4 * block, block);
    __syncthreads();
    if (me >= r0 && me < r1) {
      for (int j = 0; j < block; ++j) {
        float wj[mt::kTriFloats];
        mt::load_tri(sw4, j, wj);
        float a, tn;
        if (mt::accept(rf, wj, a, tn)) {
          const float t = __fdiv_rn(tn, a);
          if (t < t0) best = min(best, (__float_as_int(t) & ~kLocMask) | j);
        }
      }
    }
    r0 = r1;
  }
  out[row] = best;
}

}  // namespace

extern "C" int pair_runs(const int* blk_s, const float* feat, const float* w,
                         int* out, int p, int ptile, int block, int kreal,
                         cudaStream_t stream) {
  const int smem = mt::staged_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)pair_runs_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pair_runs_kernel<<<p / ptile, ptile, smem, stream>>>(blk_s, feat, w, out, block, kreal);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
