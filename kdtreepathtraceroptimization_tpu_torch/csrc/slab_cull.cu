// Slab cull: per ray tile, the tile-min conservative AABB entry bound into
// every cluster block.
//
// Replaces the TPU kernel `_slab_cull_kernel` (launcher `_slab_cull_pallas`)
// in kdtreepathtraceroptimization_tpu/ops/walk.py. Plain version:
// `_slab_cull_ref` in kdtreepathtraceroptimization_tpu_torch/ops/walk.py;
// its skip in plain form: `_slab_cull_grouped`.
//
// out[g, k] = min over the rays i of tile g of entry(i, k), where entry is
// the ray parameter at which ray i can first be inside block k's AABB,
// widened by a slack, or BIG when the block is infeasible for the ray
// (missed, behind, beyond t0, dead ray, sentinel block).
//
// Bound on this card: operations. Each (live ray, real block) test is ~34
// f32 operations against 64 bytes read per ray, far above the H100's ~20
// f32 operations a byte; none is an FMA (the products stay unfused so that
// the output equals the plain version bit for bit), so a kernel that runs
// every test cannot go much below twice the bound. So it runs fewer: the
// tile-min loop of tile_cull.cuh, with the tests of kernel 5
// (pair_extract.cu), which computes the same slab entry per (ray, block):
// the tile's live rays only, one lane a ray, and the union boxes of aligned
// groups of kGroup blocks (slab_group.cuh, whose notes show the group test
// conservative) before the member tests. A table too large for one thread
// block's shared memory is cut into slices of the block axis.
//
// Launch shape, from `chip_smoke.py --shapes slab_cull` (H100 80GB HBM3,
// 700 W; the walk path's bounce-1 call, 521,172 live rays, 512 blocks):
// 1,024 threads and groups of 16 took 0.178 ms; groups of 8 0.194, of 32
// 0.192; 512 threads 0.234 and 256 threads with groups of 8 0.231 (these
// two with the block axis cut into slices for two waves of thread blocks,
// a launcher rule since dropped); every member of every group tested (no
// group test) 0.69-0.73. At 1,024 threads a thread block holds a whole
// tile, one ray-warp a warp, and the tile's ray-warps run side by side;
// with fewer threads a warp runs several in turn.

#include "slab_group.cuh"
#include "mt_block.cuh"
#include "tile_cull.cuh"

namespace {

constexpr int kThreads = 1024;  // threads a thread block
constexpr int kGroup = 16;      // blocks a group (ops/walk.py SLAB_GROUP)

// The AABB entry policy of tcull::tile_min. Rays are _ray16 records [16]:
// staged t0, 1/d, o/d (7 floats); a block {lo_xyz, hi_x}, {hi_y, hi_z, r2,
// 0}; a group its union box {lo_xyz, hi_x}, {hi_y, hi_z, 1 or -1, 0}.
struct Slab {
  static constexpr int kStride = 16, kRayFloats = 7, kBlockVecs = 2, kGroupVecs = 2;
  struct Ray {
    float xr[16];  // the _ray16 record: only t0 (6), 1/d (8-10) and o/d (11-13) are read
  };
  static __device__ __forceinline__ bool live(const float* xt, int i) {
    return xt[(size_t)i * 16 + 7] > 0.f;
  }
  static __device__ __forceinline__ void stage_ray(const float* xt, int i, float* sr, int tile,
                                                   int slot) {
    const float* row = xt + (size_t)i * 16;
    sr[slot] = row[6];
#pragma unroll
    for (int f = 1; f < 7; ++f) sr[f * tile + slot] = row[7 + f];
  }
  static __device__ __forceinline__ Ray load_ray(const float* sr, int tile, int slot) {
    Ray r;
    r.xr[6] = sr[slot];
#pragma unroll
    for (int f = 1; f < 7; ++f) r.xr[7 + f] = sr[f * tile + slot];
    return r;
  }
  static __device__ __forceinline__ void stage_block(const float* slab, const float* blk,
                                                     int kp, int k, float4* out) {
    out[0] = make_float4(slab[0 * kp + k], slab[1 * kp + k], slab[2 * kp + k], slab[3 * kp + k]);
    out[1] = make_float4(slab[4 * kp + k], slab[5 * kp + k], blk[5 * kp + k], 0.f);
  }
  static __device__ __forceinline__ void stage_group(const float*, const float*, int, int kb,
                                                     int ke, const float4* sb, float4* out) {
    sgroup::union_box(sb, 0, ke - kb, out);
  }
  static __device__ __forceinline__ bool real(const float4* b) { return b[1].z >= 0.f; }
  static __device__ __forceinline__ bool meets(const Ray& r, const float4* g) {
    return sgroup::meets_group(r.xr, g[0], g[1]);
  }
  // The slab entry (ops/walk.py _slab_entry_math), or BIG.
  static __device__ __forceinline__ float member(const Ray& r, const float4* b) {
    const float lo[3] = {b[0].x, b[0].y, b[0].z};
    const float hi[3] = {b[0].w, b[1].x, b[1].y};
    float tmin, tmax;
    sgroup::slab_t(r.xr, lo, hi, tmin, tmax);
    const float slack = __fadd_rn(__fmul_rn(1e-6f, fabsf(tmin)), 1e-5f);
    tmin = __fsub_rn(tmin, slack);
    tmax = __fadd_rn(tmax, slack);
    const float e = fmaxf(tmin, 0.f);
    return (tmax >= e) && (tmax > 0.f) && (e < r.xr[6]) ? e : tcull::kBig;
  }
};

__global__ void __launch_bounds__(kThreads)
slab_cull_kernel(const float* __restrict__ x, const float* __restrict__ slab,
                 const float* __restrict__ blk, float* __restrict__ out, int kp, int tile,
                 int slices, int slice) {
  tcull::tile_min<Slab, kThreads, kGroup>(x, slab, blk, out, kp, tile, slices, slice);
}

}  // namespace

// Shared memory a thread block needs at this ray tile with one group of
// blocks: the wrapper refuses a tile above the card's limit.
extern "C" int slab_cull_smem_bytes(int tile) {
  return tcull::smem_bytes<Slab>(tile, kGroup, kGroup);
}

// x [n, 16] _ray16 records, slab and blk [8, kp]; out [n / tile, kp].
extern "C" int slab_cull(const float* x, const float* slab, const float* blk, float* out,
                         int n, int kp, int tile, int max_smem, cudaStream_t stream) {
  const int slice = tcull::slice_blocks<Slab>(kp, tile, kGroup, max_smem);
  if (slice == 0) return (int)cudaErrorInvalidValue;
  const int slices = (kp + slice - 1) / slice;
  const int smem = tcull::smem_bytes<Slab>(tile, slice, kGroup);
  cudaError_t err = mt::allow_smem((const void*)slab_cull_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n / tile) * slices;
  slab_cull_kernel<<<grid, kThreads, smem, stream>>>(x, slab, blk, out, kp, tile, slices, slice);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
