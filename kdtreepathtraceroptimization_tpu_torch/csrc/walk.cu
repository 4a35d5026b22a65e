// Walk: per ray tile, intersect the tile's entry-ordered feasible blocks
// one after another, keeping each ray's nearest hit, and stop as soon as no
// live ray can still improve.
//
// Replaces the TPU kernel `_walk_kernel` (launcher `_walk_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/walk.py. Plain version: `_walk_ref`
// (the round loop `_cluster_ref`) in kdtreepathtraceroptimization_tpu_torch.
//
// Round rr of tile g tests block k = sel[g, rr] against every ray of the
// tile: the Moller-Trumbore quantities (a, t_num, u_num, v_num) of each
// triangle are dot products of the ray's features r = [o, d, o x d, 1]
// with the block's weight columns w[k] ([16, 4B], rows 10-15 zero), then
// the epilogue of ops/mxu_bf.py accepts a > eps, u, v >= 0, u + v <= a,
// t >= 0, t < best. Ties go to the smaller triangle within a block and to
// the earlier round across blocks (strict <), as in the TPU kernel. After
// each round the tile stops when no live ray's best t exceeds the next
// block's entry bound lb[g, rr + 1] (blocks come in entry order), or when
// the feasible list (nsel[g] blocks) is exhausted.
//
// Bound on this card: operations. Each (ray, triangle) test is 40 FMAs and
// ~10 more f32 operations, against weights that stay in L2 (25 MB at
// 81,920 triangles) and 76 bytes per ray read once.
// Design: one thread block per tile, RPT rays per thread. Each round stages
// the block's 10 non-zero weight rows in shared memory, transposed so that
// one triangle's 40 weights are ten float4 loads; every thread reads the
// same triangle at the same time (a broadcast) and reuses each loaded
// weight for its RPT rays. The early exit is one __syncthreads_or per
// round. Weights are loaded plainly between rounds; overlapping that copy
// with compute (cp.async / TMA double buffering) is left for later.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr float kCullEps = 1.19e-7f;  // ops/mxu_bf.py _CULL_EPS
constexpr int kRpt = 4;               // rays per thread
constexpr int kFeat = 10;             // non-zero feature rows of r and w

__device__ __forceinline__ float dot10(const float* r, const float* w) {
  float acc = r[0] * w[0];
#pragma unroll
  for (int f = 1; f < kFeat; ++f) acc = fmaf(r[f], w[f], acc);
  return acc;
}

__global__ void walk_kernel(const int* __restrict__ sel,
                            const float* __restrict__ lb,
                            const int* __restrict__ nsel,
                            const float* __restrict__ r,
                            const float* __restrict__ t0,
                            const float* __restrict__ act,
                            const float* __restrict__ w,
                            float* __restrict__ bt_out,
                            int* __restrict__ btri_out, int kp, int tile,
                            int block) {
  // sw: per triangle j, 40 floats [a f0..f9 | t f0..f9 | u .. | v ..].
  extern __shared__ float4 sw4[];
  float* sw = reinterpret_cast<float*>(sw4);

  const int g = blockIdx.x;
  const int nt = blockDim.x;
  const int* sel_g = sel + (size_t)g * kp;
  const float* lb_g = lb + (size_t)g * kp;
  const int ns = nsel[g];

  float rf[kRpt][kFeat];
  float bt[kRpt];
  int bi[kRpt];
  bool on[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const size_t ray = (size_t)g * tile + threadIdx.x + i * nt;
#pragma unroll
    for (int f = 0; f < kFeat; ++f) rf[i][f] = r[ray * 16 + f];
    bt[i] = t0[ray];
    bi[i] = -1;
    on[i] = act[ray] > 0.f;
  }

  bool want = false;
  if (ns > 0) {
    const float lb0 = lb_g[0];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) want |= on[i] && bt[i] > lb0;
  }
  int live = __syncthreads_or(want);

  const int cols = 4 * block;
  for (int rr = 0; live; ++rr) {
    const int k = sel_g[rr];
    // The barrier ending the previous round guarantees every thread is
    // done reading sw.
    const float* wk = w + (size_t)k * 16 * cols;
    for (int e = threadIdx.x; e < kFeat * cols; e += nt) {
      const int f = e / cols;
      const int c = e - f * cols;
      const int q = c / block;
      const int j = c - q * block;
      sw[j * 40 + q * kFeat + f] = wk[e];
    }
    __syncthreads();

    float cur[kRpt];
    int loc[kRpt];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      cur[i] = bt[i];
      loc[i] = -1;
    }
    for (int j = 0; j < block; ++j) {
      float wj[40];
#pragma unroll
      for (int v = 0; v < 10; ++v) {
        const float4 p = sw4[j * 10 + v];
        wj[4 * v + 0] = p.x;
        wj[4 * v + 1] = p.y;
        wj[4 * v + 2] = p.z;
        wj[4 * v + 3] = p.w;
      }
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        if (!on[i]) continue;  // dead rays have d = 0 and never hit
        const float a = dot10(rf[i], wj + 0 * kFeat);
        const float tn = dot10(rf[i], wj + 1 * kFeat);
        const float un = dot10(rf[i], wj + 2 * kFeat);
        const float vn = dot10(rf[i], wj + 3 * kFeat);
        const bool ok = (a > kCullEps) && (un >= 0.f) && (vn >= 0.f) &&
                        (__fadd_rn(un, vn) <= a) && (tn >= 0.f);
        if (ok) {
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
        bi[i] = k * block + loc[i];
      }
    }

    const int nxt = rr + 1;
    want = false;
    if (nxt < ns) {
      const float nlb = lb_g[nxt];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) want |= on[i] && bt[i] > nlb;
    }
    live = __syncthreads_or(want);
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const size_t ray = (size_t)g * tile + threadIdx.x + i * nt;
    bt_out[ray] = bt[i];
    btri_out[ray] = bi[i];
  }
}

}  // namespace

extern "C" int walk(const int* sel, const float* lb, const int* nsel,
                    const float* r, const float* t0, const float* act,
                    const float* w, float* bt, int* btri, int n, int kp,
                    int tile, int block, cudaStream_t stream) {
  const int smem = 40 * block * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  walk_kernel<<<n / tile, tile / kRpt, smem, stream>>>(
      sel, lb, nsel, r, t0, act, w, bt, btri, kp, tile, block);
  return (int)cudaGetLastError();
}

// The launcher needs tile % RPT == 0 and tile / RPT <= 1024.
extern "C" int walk_rays_per_thread() { return kRpt; }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
