// Sphere cull: per ray tile, the tile-min conservative bounding-sphere
// entry bound into every cluster block.
//
// Replaces the TPU kernel `_cull_kernel` (launcher `_cull_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/cluster.py. Plain version:
// `_cull_ref` in kdtreepathtraceroptimization_tpu_torch/ops/cluster.py;
// its skip in plain form: `_cull_grouped`.
//
// out[g, k] = min over the rays i of tile g of the entry bound of ray i
// into block k (cluster_entry.cuh), BIG when no ray of the tile can enter
// it. The TPU computed the d.c and o.c products as one [8, 2kp] matmul
// with five exactly-zero terms; here they are the three non-zero terms,
// rounded and summed as the plain version does, so the result is equal bit
// for bit.
//
// Bound on this card: operations. Each (live ray, real block) test is about
// 24 f32 operations against 32 bytes read per ray and 36 per block, far
// above the H100's ~20 a byte; none is an FMA (unfused, for bit equality),
// so a kernel that runs every test cannot go much below twice the bound.
// So it runs fewer: the tile-min loop of tile_cull.cuh, with the tile's live
// rays only, one lane a ray, and the bounding sphere of each aligned group
// of kGroup blocks (cluster_entry.cuh group_sphere / group_bound, whose
// notes show the widened group test conservative) before the member tests.
// A table too large for one thread block's shared memory is cut into
// slices of the block axis.
//
// Launch shape, from `chip_smoke.py --shapes cluster_cull` (H100 80GB
// HBM3, 700 W; the cluster and binned paths' bounce-1 calls, 521,172 live
// rays, 512 blocks): 1,024 threads and groups of 8 took 0.180 and 0.189
// ms; groups of 16 0.208 and 0.262 (a sphere around 16 blocks is loose),
// of 4 0.212 and 0.197; 512 threads 0.231 and 0.185, 256 threads 0.229 and
// 0.218 (these two with the block axis cut into slices for two waves of
// thread blocks, a launcher rule since dropped); every member of every
// group tested 0.58-0.60.

#include "cluster_entry.cuh"
#include "mt_block.cuh"
#include "tile_cull.cuh"

namespace {

constexpr int kThreads = 1024;  // threads a thread block
constexpr int kGroup = 8;       // blocks a group (ops/cluster.py CULL_GROUP)

// The bounding-sphere entry policy of tcull::tile_min. Rays are [8]
// records (o, d, t0, act): staged o, d, t0, o.d, |o|^2 (9 floats); a block
// {c (d.c), c'_x}, {c'_yz (o.c), radius, cc}, {r2, 0, 0, 0}; a group its
// sphere {C, R}, {CC, CR, 1 or -1, 0}.
struct Sphere {
  static constexpr int kStride = 8, kRayFloats = 9, kBlockVecs = 3, kGroupVecs = 2;
  struct Ray {
    entry::Ray r;
    entry::GroupMargins m;
  };
  static __device__ __forceinline__ bool live(const float* xt, int i) {
    return xt[(size_t)i * 8 + 7] > 0.f;
  }
  static __device__ __forceinline__ void stage_ray(const float* xt, int i, float* sr, int tile,
                                                   int slot) {
    const entry::Ray r = entry::load_ray(xt + (size_t)i * 8);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      sr[a * tile + slot] = r.o[a];
      sr[(3 + a) * tile + slot] = r.d[a];
    }
    sr[6 * tile + slot] = r.t0;
    sr[7 * tile + slot] = r.od;
    sr[8 * tile + slot] = r.oo;
  }
  static __device__ __forceinline__ Ray load_ray(const float* sr, int tile, int slot) {
    Ray q;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      q.r.o[a] = sr[a * tile + slot];
      q.r.d[a] = sr[(3 + a) * tile + slot];
    }
    q.r.t0 = sr[6 * tile + slot];
    q.r.od = sr[7 * tile + slot];
    q.r.oo = sr[8 * tile + slot];
    q.r.live = true;  // only live rays are staged
    q.m = entry::group_margins(q.r);
    return q;
  }
  static __device__ __forceinline__ void stage_block(const float* cull_w, const float* blk,
                                                     int kp, int k, float4* out) {
    float b[entry::kBlockFloats];
    entry::load_block(cull_w, blk, kp, k, b);
    out[0] = make_float4(b[0], b[1], b[2], b[3]);
    out[1] = make_float4(b[4], b[5], b[6], b[7]);
    out[2] = make_float4(b[8], 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void stage_group(const float* cull_w, const float* blk,
                                                     int kp, int kb, int ke, const float4*,
                                                     float4* out) {
    entry::group_sphere(cull_w, blk, kp, kb, ke, out);
  }
  static __device__ __forceinline__ bool real(const float4* b) { return b[2].x >= 0.f; }
  static __device__ __forceinline__ bool meets(const Ray& q, const float4* g) {
    return entry::group_bound(q.r, q.m, g[0], g[1]) < entry::kBig;
  }
  static __device__ __forceinline__ float member(const Ray& q, const float4* v) {
    const float b[entry::kBlockFloats] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x,
                                          v[1].y, v[1].z, v[1].w, v[2].x};
    return entry::bound(q.r, b);
  }
};

__global__ void __launch_bounds__(kThreads)
cluster_cull_kernel(const float* __restrict__ x, const float* __restrict__ cull_w,
                    const float* __restrict__ blk, float* __restrict__ out, int kp, int tile,
                    int slices, int slice) {
  tcull::tile_min<Sphere, kThreads, kGroup>(x, cull_w, blk, out, kp, tile, slices, slice);
}

}  // namespace

// Shared memory a thread block needs at this ray tile with one group of
// blocks: the wrapper refuses a tile above the card's limit.
extern "C" int cluster_cull_smem_bytes(int tile) {
  return tcull::smem_bytes<Sphere>(tile, kGroup, kGroup);
}

// x [n, 8] ray records, cull_w [8, 2kp], blk [8, kp]; out [n / tile, kp].
extern "C" int cluster_cull(const float* x, const float* cull_w, const float* blk, float* out,
                            int n, int kp, int tile, int max_smem, cudaStream_t stream) {
  const int slice = tcull::slice_blocks<Sphere>(kp, tile, kGroup, max_smem);
  if (slice == 0) return (int)cudaErrorInvalidValue;
  const int slices = (kp + slice - 1) / slice;
  const int smem = tcull::smem_bytes<Sphere>(tile, slice, kGroup);
  cudaError_t err = mt::allow_smem((const void*)cluster_cull_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n / tile) * slices;
  cluster_cull_kernel<<<grid, kThreads, smem, stream>>>(x, cull_w, blk, out, kp, tile,
                                                         slices, slice);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
