// Brute force: every ray tile against every triangle block, with each
// ray's running nearest hit.
//
// Replaces the TPU kernel `_bf_kernel` (launcher `_bf_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/mxu_bf.py. Plain version:
// `intersect_brute_mxu_ref` in kdtreepathtraceroptimization_tpu_torch/ops/
// mxu_bf.py (the wrapper `intersect_brute_mxu` builds this kernel's inputs).
//
// r [n, 16] holds the rays' features [o, d, o x d, 1, 0...], t0 [n] each
// ray's bound, and ws [nb, B, 16] each triangle's 16 distinct Moller-
// Trumbore weights in mt_block.cuh's sparse order (ops/mxu_bf.py
// sparse_weights of the [10, 4B] blocks tri_weights builds). For every
// block in order the kernel keeps the first triangle of the smallest hit t
// below the running best within the block (jnp.argmin's choice) and takes
// it when strictly nearer, as the TPU kernel's grid walk over blocks does.
// Only the ntri real triangles are tested (the rest of the last block is
// padding).
//
// Precondition: the weights come from tri_weights, whose zero pattern and
// sign relation mt_block.cuh describes (mxu_bf.check_sparse_pattern;
// chip_smoke.py asserts it on the table it launches this kernel on).
//
// Bound on this card: operations. Each (live ray, triangle) test is 19
// FMAs and 8 more f32 operations; a ray's 76 bytes are read once and the
// triangles' weights (64 bytes each) come from L2 for every ray tile.
// Design:
//   - The sparse test (mt::sparse_accept): 19 FMAs on 16 weights, where
//     the TPU's matrix unit multiplies all 40.
//   - One thread block per tile of rays, kRpt rays a thread; every thread
//     tests the same triangle at once (a broadcast of four float4) and
//     reuses each loaded weight for its kRpt rays. Two rays a thread and
//     512 threads (tiles of 1,024 rays) are the fastest of the shapes
//     chip_smoke.py times.
//   - The table is per triangle already, so a block is one contiguous run,
//     double-buffered: the copy of block jb + 1 (16-byte cp.async) is issued
//     before block jb is tested; one barrier a block.
//   - A ray with d = 0 has a = 0 and never hits. The wrapper sorts such rays
//     to the back; a thread block none of whose rays has a direction writes
//     (t0, -1) and exits, decided by __syncthreads_or on the device.

#include "mt_block.cuh"

namespace {

constexpr int kRpt = 2;          // rays a thread
constexpr int kThreads = 512;    // most threads a thread block: tiles of up to kRpt kThreads rays
constexpr int kMinBlocks = 1;    // thread blocks an SM must hold (__launch_bounds__)

// Issue the copy of `ntri` triangles' weights (16 floats each) from ws to s.
__device__ __forceinline__ void stage(float4* s, const float* __restrict__ ws, int ntri) {
  const float4* src = reinterpret_cast<const float4*>(ws);
  for (int v = threadIdx.x; v < ntri * (mt::kSparse / 4); v += blockDim.x)
    mt::cp_async16(s + v, src + v);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
mxu_bf_kernel(const float* __restrict__ r, const float* __restrict__ ws,
              const float* __restrict__ t0, float* __restrict__ bt_out,
              int* __restrict__ btri_out, int ntri, int nb, int tile, int block) {
  extern __shared__ float4 sw4[];
  const int nt = blockDim.x;

  float rf[kRpt][mt::kFeat];
  float bt[kRpt];
  int bi[kRpt];
  bool moves = false;
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const size_t ray = (size_t)blockIdx.x * tile + threadIdx.x + i * nt;
    const float4* r4 = reinterpret_cast<const float4*>(r + ray * 16);
    const float4 p0 = r4[0], p1 = r4[1], p2 = r4[2];
    const float f[12] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, p2.y, p2.z, p2.w};
#pragma unroll
    for (int k = 0; k < mt::kFeat; ++k) rf[i][k] = f[k];
    bt[i] = t0[ray];
    bi[i] = -1;
    moves |= rf[i][3] != 0.f || rf[i][4] != 0.f || rf[i][5] != 0.f;
  }

  if (__syncthreads_or(moves)) {
    const int per = block * (mt::kSparse / 4);  // float4 a staged block
    stage(sw4, ws, min(block, ntri));
    mt::cp_async_commit();
    for (int jb = 0; jb < nb; ++jb) {
      mt::cp_async_wait_all();
      __syncthreads();  // block jb has arrived; every thread is done with block jb - 1
      if (jb + 1 < nb) {
        stage(sw4 + ((jb + 1) & 1) * per, ws + (size_t)(jb + 1) * block * mt::kSparse,
              min(block, ntri - (jb + 1) * block));
      }
      mt::cp_async_commit();
      const float4* cur = sw4 + (jb & 1) * per;
      const int nj = min(block, ntri - jb * block);
      const int id0 = jb * block;
      for (int j = 0; j < nj; ++j) {
        float wj[mt::kSparse];
        mt::load_sparse(cur, j, wj);
#pragma unroll
        for (int i = 0; i < kRpt; ++i) {
          float a, tn;
          if (mt::sparse_accept(rf[i], wj, a, tn)) {
            const float t = __fdiv_rn(tn, a);
            if (t < bt[i]) {
              bt[i] = t;
              bi[i] = id0 + j;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const size_t ray = (size_t)blockIdx.x * tile + threadIdx.x + i * nt;
    bt_out[ray] = bt[i];
    btri_out[ray] = bi[i];
  }
}

int smem_bytes(int block) { return 2 * block * mt::kSparse * (int)sizeof(float); }

}  // namespace

// r [n, 16], ws [nb, block, 16] (ntri real triangles, the rest padding),
// t0 [n]; outputs bt, btri [n]. n is a multiple of tile, tile of kRpt,
// and tile / kRpt <= kThreads.
extern "C" int mxu_bf(const float* r, const float* ws, const float* t0, float* bt,
                      int* btri, int n, int ntri, int nb, int tile, int block,
                      cudaStream_t stream) {
  if (tile <= 0 || tile % kRpt || tile / kRpt > kThreads || n % tile || block <= 0 ||
      ntri > nb * block)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)mxu_bf_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mxu_bf_kernel<<<n / tile, tile / kRpt, smem, stream>>>(r, ws, t0, bt, btri, ntri, nb,
                                                         tile, block);
  return (int)cudaGetLastError();
}

// The launcher needs tile % mxu_bf_rays_per_thread() == 0 and
// tile <= mxu_bf_max_tile().
extern "C" int mxu_bf_rays_per_thread() { return kRpt; }
extern "C" int mxu_bf_max_tile() { return kRpt * kThreads; }
extern "C" int mxu_bf_smem_bytes(int block) { return smem_bytes(block); }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
