// Pair extraction: per ray, the F nearest-entry feasible cluster blocks,
// the feasible count, lb_over and the ray's Moller-Trumbore feature record.
//
// Replaces the TPU kernel `_extract_kernel_t` (launcher `_extract_pallas`)
// in kdtreepathtraceroptimization_tpu/ops/pairs.py. Plain version:
// `_extract_ref` in kdtreepathtraceroptimization_tpu_torch/ops/pairs.py.
//
// For ray i and block k the entry is the slab cull's (slab_cull.cu):
// the conservative ray parameter at which the ray can first be inside the
// block's AABB, or BIG when infeasible. Each feasible (entry, k) is one
// int32 key, the entry's bits with k in the low 13 bits: keys are unique
// and order as the entries (ties to the smaller id). The F smallest keys
// give ids[i, 0..F) (kp once exhausted); the (F+1)-th key, its id bits
// cleared, is lb_over[i] (BIG when there is none); cnt[i] counts the
// feasible blocks. feat[i] is _feat16t: [o, d, o x d, 1, 0...] * act with
// t0 in column 10.
//
// Bound on this card: operations. Each (ray, block) pair costs ~34 f32
// operations against 64 bytes read and ~84 written per ray, i.e. ~100
// operations per byte at kp = 512, far above the H100's ~20 f32 operations
// per byte.
// Design: one thread per ray. The thread block stages the slab table and
// blk row 5 (32 bytes per block) in shared memory, 1024 blocks at a time
// (32 KB, so any kp up to the 8192 cap fits), and every thread reads the
// same block at once (a broadcast). The TPU kernel ran F + 1 rounds of
// min-and-remove over [kp, rays]; since the keys are unique, keeping the
// F + 1 smallest in registers by insertion gives the same ids and lb_over
// in one pass over the blocks, and only feasible blocks (a few per ray)
// are inserted. Dead rays skip the pass.
//
// Products and sums use __fmul_rn / __fsub_rn / __fadd_rn so that nvcc
// does not contract them into FMAs: the result equals the plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kIdxBits = 13;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kMaxSlots = 16;           // the largest F the kernel takes
constexpr int kKeep = kMaxSlots + 1;    // F ids and the lb_over key
constexpr int kChunk = 1024;            // blocks staged at once
constexpr int kThreads = 128;
constexpr int kDeadKey = 0x7FFFFFFF;

__global__ void __launch_bounds__(kThreads)
pair_extract_kernel(const float* __restrict__ x, const float* __restrict__ slab,
                    const float* __restrict__ blk, int* __restrict__ ids,
                    float* __restrict__ lbov, int* __restrict__ cnt,
                    float* __restrict__ feat, int n, int kp, int F) {
  // Per block: {lo_x, lo_y, lo_z, hi_x} and {hi_y, hi_z, r2, 0}.
  __shared__ float4 sb[2 * kChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < n;

  float xr[16];
  if (in) {
    const float4* row = reinterpret_cast<const float4*>(x + (size_t)i * 16);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float4 p = row[v];
      xr[4 * v + 0] = p.x;
      xr[4 * v + 1] = p.y;
      xr[4 * v + 2] = p.z;
      xr[4 * v + 3] = p.w;
    }
  } else {
#pragma unroll
    for (int f = 0; f < 16; ++f) xr[f] = 0.f;
  }
  const float t0 = xr[6];
  const bool act = in && xr[7] > 0.f;

  int top[kKeep];  // ascending; the kKeep smallest keys seen so far
#pragma unroll
  for (int j = 0; j < kKeep; ++j) top[j] = kDeadKey;
  int count = 0;

  for (int k0 = 0; k0 < kp; k0 += kChunk) {
    const int kc = min(kChunk, kp - k0);
    __syncthreads();  // the previous chunk's readers are done
    for (int k = threadIdx.x; k < kc; k += blockDim.x) {
      const int g = k0 + k;
      sb[2 * k] = make_float4(slab[0 * kp + g], slab[1 * kp + g], slab[2 * kp + g],
                              slab[3 * kp + g]);
      sb[2 * k + 1] = make_float4(slab[4 * kp + g], slab[5 * kp + g], blk[5 * kp + g], 0.f);
    }
    __syncthreads();
    if (!act) continue;  // a dead ray has no feasible block
    for (int k = 0; k < kc; ++k) {
      const float4 p = sb[2 * k];
      const float4 q = sb[2 * k + 1];
      if (!(q.z >= 0.f)) continue;  // sentinel block (r2 < 0)
      const float lo[3] = {p.x, p.y, p.z};
      const float hi[3] = {p.w, q.x, q.y};
      float tmin = -kBig, tmax = kBig;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float invd = xr[8 + a];
        const float oinv = xr[11 + a];
        const float tlo = __fsub_rn(__fmul_rn(lo[a], invd), oinv);
        const float thi = __fsub_rn(__fmul_rn(hi[a], invd), oinv);
        tmin = fmaxf(tmin, fminf(tlo, thi));
        tmax = fminf(tmax, fmaxf(tlo, thi));
      }
      const float slack = __fadd_rn(__fmul_rn(1e-6f, fabsf(tmin)), 1e-5f);
      tmin = __fsub_rn(tmin, slack);
      tmax = __fadd_rn(tmax, slack);
      const float entry = fmaxf(tmin, 0.f);
      if ((tmax >= entry) && (tmax > 0.f) && (entry < t0) && (entry < kBig)) {
        ++count;
        int key = (__float_as_int(entry) & ~kIdxMask) | (k0 + k);
#pragma unroll
        for (int j = 0; j < kKeep; ++j) {  // insert: keys are unique
          const int lo_key = min(top[j], key);
          key = max(top[j], key);
          top[j] = lo_key;
        }
      }
    }
  }
  if (!in) return;

  // Keys at or above BIG's (truncated) bits are not feasible entries.
  const int big_key = __float_as_int(kBig) & ~kIdxMask;
  int over = top[0];
#pragma unroll
  for (int j = 0; j < kMaxSlots; ++j) {
    if (j < F) ids[(size_t)i * F + j] = top[j] < big_key ? (top[j] & kIdxMask) : kp;
    if (j + 1 == F) over = top[j + 1];
  }
  lbov[i] = over < big_key ? __int_as_float(over & ~kIdxMask) : kBig;
  cnt[i] = count;

  const float af = xr[7];
  const float o[3] = {xr[0], xr[1], xr[2]};
  const float d[3] = {xr[3], xr[4], xr[5]};
  float fr[16];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    fr[a] = __fmul_rn(o[a], af);
    fr[3 + a] = __fmul_rn(d[a], af);
  }
  fr[6] = __fmul_rn(__fsub_rn(__fmul_rn(o[1], d[2]), __fmul_rn(o[2], d[1])), af);
  fr[7] = __fmul_rn(__fsub_rn(__fmul_rn(o[2], d[0]), __fmul_rn(o[0], d[2])), af);
  fr[8] = __fmul_rn(__fsub_rn(__fmul_rn(o[0], d[1]), __fmul_rn(o[1], d[0])), af);
  fr[9] = __fmul_rn(af, af);
  fr[10] = t0;
#pragma unroll
  for (int f = 11; f < 16; ++f) fr[f] = __fmul_rn(0.f, af);
  float4* out = reinterpret_cast<float4*>(feat + (size_t)i * 16);
#pragma unroll
  for (int v = 0; v < 4; ++v)
    out[v] = make_float4(fr[4 * v], fr[4 * v + 1], fr[4 * v + 2], fr[4 * v + 3]);
}

}  // namespace

extern "C" int pair_extract(const float* x, const float* slab, const float* blk,
                            int* ids, float* lbov, int* cnt, float* feat, int n,
                            int kp, int F, cudaStream_t stream) {
  pair_extract_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      x, slab, blk, ids, lbov, cnt, feat, n, kp, F);
  return (int)cudaGetLastError();
}

// The launcher needs 1 <= F <= this.
extern "C" int pair_extract_max_slots() { return kMaxSlots; }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
