// Brute force: every ray tile against every triangle block, with each
// ray's running nearest hit.
//
// Replaces the TPU kernel `_bf_kernel` (launcher `_bf_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/mxu_bf.py. Plain version:
// `intersect_brute_mxu_ref` in kdtreepathtraceroptimization_tpu_torch/ops/
// mxu_bf.py (the wrapper `intersect_brute_mxu` builds this kernel's inputs).
//
// r [n, 16] holds the rays' features [o, d, o x d, 1, 0...], w [nb, 16, 4B]
// the triangle blocks' weights (the cluster table's layout, mt_block.cuh)
// and t0 [n] each ray's bound. For every block in order the kernel keeps
// the first triangle of the smallest hit t below the running best within
// the block (jnp.argmin's choice) and takes it when strictly nearer, as the
// TPU kernel's grid walk over blocks does. Padding triangles are degenerate
// (a = 0) and padding rays have d = 0 (a = 0): neither ever hits.
//
// Bound on this card: operations. Each (ray, triangle) test is 40 FMAs and
// ~10 more f32 operations; a ray's 76 bytes are read once and the
// triangles' weights (160 bytes each) come from L2 for every ray tile.
// Design: one thread block per tile of rays, RPT rays per thread. Each
// triangle block is staged in shared memory (mt::stage_block) and every
// thread tests the same triangle at once (a broadcast), reusing each loaded
// weight for its RPT rays. Staging is not overlapped with compute
// (cp.async / TMA double buffering is left for later).

#include "mt_block.cuh"

namespace {

constexpr int kRpt = 4;  // rays per thread

__global__ void mxu_bf_kernel(const float* __restrict__ r, const float* __restrict__ w,
                              const float* __restrict__ t0, float* __restrict__ bt_out,
                              int* __restrict__ btri_out, int nb, int tile, int block) {
  extern __shared__ float4 sw4[];
  float* sw = reinterpret_cast<float*>(sw4);
  const int nt = blockDim.x;

  float rf[kRpt][mt::kFeat];
  float bt[kRpt];
  int bi[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const size_t ray = (size_t)blockIdx.x * tile + threadIdx.x + i * nt;
#pragma unroll
    for (int f = 0; f < mt::kFeat; ++f) rf[i][f] = r[ray * 16 + f];
    bt[i] = t0[ray];
    bi[i] = -1;
  }

  for (int jb = 0; jb < nb; ++jb) {
    __syncthreads();  // every thread is done reading the previous block
    mt::stage_block(sw, w + (size_t)jb * 16 * 4 * block, block);
    __syncthreads();
    float cur[kRpt];
    int loc[kRpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      cur[i] = bt[i];
      loc[i] = -1;
    }
    for (int j = 0; j < block; ++j) {
      float wj[mt::kTriFloats];
      mt::load_tri(sw4, j, wj);
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        float a, tn;
        if (mt::accept(rf[i], wj, a, tn)) {
          const float t = __fdiv_rn(tn, a);
          if (t < cur[i]) {
            cur[i] = t;
            loc[i] = j;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      if (loc[i] >= 0) {
        bt[i] = cur[i];
        bi[i] = jb * block + loc[i];
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

}  // namespace

extern "C" int mxu_bf(const float* r, const float* w, const float* t0, float* bt,
                      int* btri, int n, int nb, int tile, int block,
                      cudaStream_t stream) {
  const int smem = mt::staged_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)mxu_bf_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mxu_bf_kernel<<<n / tile, tile / kRpt, smem, stream>>>(r, w, t0, bt, btri, nb, tile,
                                                         block);
  return (int)cudaGetLastError();
}

// The launcher needs tile % RPT == 0 and tile / RPT <= 1024.
extern "C" int mxu_bf_rays_per_thread() { return kRpt; }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
