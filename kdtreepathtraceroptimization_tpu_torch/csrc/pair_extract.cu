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
// Bound on this card: operations. Each (live ray, real block) test is ~33
// f32 operations against 64 bytes read and ~84 written a ray, ~100
// operations a byte at kp = 512, far above the H100's ~20. None of them is
// an FMA (the products stay unfused, below), so each takes a whole f32
// issue slot, and a kernel that tests every (ray, block) cannot go much
// below twice the bound. So the design does fewer tests:
//   - Groups. The cluster table is a tree laid out flat (ops/cluster.py
//     _kd_leaf_order emits median-split leaves depth first), so an aligned
//     run of kGroup blocks is a subtree with a tight union box. While it
//     stages the slab table, the thread block builds each group's union
//     box over its real members (blk row 5 >= 0; a group with none is
//     empty; the last group of a table may be ragged). A warp tests each
//     group's box for each of its rays first, and runs the exact tests of
//     the group's members only if some lane meets the box (__any_sync);
//     every lane then reads the same member (a broadcast). The member test
//     is unchanged, so cnt and the kept keys are the same (keys are
//     unique: insertion order does not matter).
//   - Dead thread blocks. A thread block none of whose rays is live stages
//     nothing and tests nothing; it still writes ids = kp, lb_over = BIG,
//     cnt = 0 and feat, through the same products (which keep the sign of
//     a zero). Pass 2's compacted tail costs only its stores.
//   - kRpt rays a thread would share each shared-memory load of a block
//     or group; at two, the registers cost more than the loads saved.
//   - The split form. Pass 2's few live rays (a few thousand of its 65,536
//     lanes, compacted to the front) fill a few dozen thread blocks, each
//     of whose threads tests every block one after another: the call takes
//     the time of that chain, not of its work. With `split` each ray takes
//     kSplitLanes lanes; lane s tests groups s, s + kSplitLanes, ... and
//     keeps its own keys and count, and at the end the lanes' sorted keys
//     merge by shuffles (keys are unique, so one lane gives up each key in
//     turn) and their counts add: the same ids, lb_over and cnt. Pass 1's
//     call (521,172 live rays of 640,000) keeps the one-lane form: there
//     the split form took 0.447 ms at 4 lanes a ray, 0.335 at 2 and 0.753
//     at 8, against 0.302 (chip_smoke.py --shapes pair_extract; H100 80GB
//     HBM3, 700 W). Its warp holds 32 / kSplitLanes rays, and a step's
//     member tests run on every lane when one lane's group is met.
//
// Why the group test is conservative in f32 (every block the exact test
// passes lies in a group the group test passes; `_group_entry` in
// ops/pairs.py is its plain form, and tests/test_torch_pairs.py and
// chip_smoke.py hold the premise on the pair path's own calls). The group
// box [GL, GH] holds every real member's lo and hi on each axis. Per axis,
// t(x) = (x * invd) - oinv, each step rounded, is monotone in x, so the
// group's two values bracket every member's: tmin_g <= tmin_k and tmax_g >=
// tmax_k. The member test widens both by its slack s_k = 1e-6 |tmin_k| +
// 1e-5, which is not monotone in the box: a group's tmin_g may be smaller
// in magnitude than a member's. So the group test widens by S = slack(B)
// with B = max(|tmin_g|, |tmax_g| * 1.00001 + 1e-4), which bounds |tmin_k|
// for every member k the exact test passes: if tmin_k <= 0, |tmin_k| <=
// |tmin_g|; if tmin_k > 0, passing needs tmin_k - s_k <= tmax_k + s_k (to
// within rounding), so tmin_k <= |tmax_g| (1 + 2.2e-6) + 2.1e-5 < B. The
// slack's rounding is monotone, so S >= s_k, and then (tmin_g - S) <=
// (tmin_k - s_k) and (tmax_g + S) >= (tmax_k + s_k) after rounding: the
// group's entry is at most the member's, its exit at least the member's,
// and each of the member's three conditions (exit >= entry, exit > 0, entry
// < t0) holds for the group.
//
// Products and sums use __fmul_rn / __fsub_rn / __fadd_rn so that nvcc
// does not contract them into FMAs: the result equals the plain PyTorch
// version bit for bit. The TPU kernel ran F + 1 rounds of min-and-remove
// over [kp, rays]; since the keys are unique, keeping the F + 1 smallest in
// registers by insertion gives the same ids and lb_over in one pass.
//
// Launch shape (the fastest of those chip_smoke.py --shapes times on the
// pair path's pass-1 and pass-2 calls; H100 80GB HBM3, 700 W): 128
// threads, one ray a thread, groups of 8 blocks, 4 lanes a ray in the
// split form: 0.30 and 0.038 ms, against 0.34 and 0.036 for groups of 4,
// 0.36 for groups of 16, 0.48 at two rays a thread and 0.049 and 0.051
// for 2 and 8 split lanes; every ray testing every block (a flat form
// this source no longer holds) took 0.60.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kIdxBits = 13;
constexpr int kIdxMask = (1 << kIdxBits) - 1;
constexpr int kMaxSlots = 16;           // the largest F the kernel takes
constexpr int kKeep = kMaxSlots + 1;    // F ids and the lb_over key
constexpr int kChunk = 1024;            // blocks staged at once
constexpr int kThreads = 128;           // threads a thread block
constexpr int kRpt = 1;                 // rays a thread
constexpr int kGroup = 8;               // blocks a group
constexpr int kSplitLanes = 4;          // lanes a ray in the split form
constexpr int kDeadKey = 0x7FFFFFFF;
constexpr int kGroups = kChunk / kGroup;  // groups a chunk
static_assert(kChunk % kGroup == 0, "a group must not straddle two chunks");

struct Ray {
  float xr[16];   // the ray's _ray16 record
  bool act;
  int top[kKeep]; // ascending; the kKeep smallest keys seen so far
  int count;
};

// Slab parameters of box [lo, hi] along the ray: tmin, tmax.
__device__ __forceinline__ void slab_t(const float* xr, const float* lo, const float* hi,
                                       float& tmin, float& tmax) {
  tmin = -kBig;
  tmax = kBig;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float invd = xr[8 + a];
    const float oinv = xr[11 + a];
    const float tlo = __fsub_rn(__fmul_rn(lo[a], invd), oinv);
    const float thi = __fsub_rn(__fmul_rn(hi[a], invd), oinv);
    tmin = fmaxf(tmin, fminf(tlo, thi));
    tmax = fminf(tmax, fmaxf(tlo, thi));
  }
}

// The exact test of block k (staged as {lo_xyz, hi_x}, {hi_y, hi_z, r2, 0}):
// a feasible block's key goes into the ray's kept keys.
__device__ __forceinline__ void test_block(Ray& ray, float4 p, float4 q, int k) {
  const float lo[3] = {p.x, p.y, p.z};
  const float hi[3] = {p.w, q.x, q.y};
  float tmin, tmax;
  slab_t(ray.xr, lo, hi, tmin, tmax);
  const float slack = __fadd_rn(__fmul_rn(1e-6f, fabsf(tmin)), 1e-5f);
  tmin = __fsub_rn(tmin, slack);
  tmax = __fadd_rn(tmax, slack);
  const float entry = fmaxf(tmin, 0.f);
  if ((tmax >= entry) && (tmax > 0.f) && (entry < ray.xr[6]) && (entry < kBig)) {
    ++ray.count;
    int key = (__float_as_int(entry) & ~kIdxMask) | k;
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {  // insert: keys are unique
      const int lo_key = min(ray.top[j], key);
      key = max(ray.top[j], key);
      ray.top[j] = lo_key;
    }
  }
}

// The group test (the notes above; ops/pairs.py _group_entry is its plain
// form): whether the ray may meet a member of the group whose union box is
// staged as {lo_xyz, hi_x}, {hi_y, hi_z, nonempty (1) or empty (-1), 0}.
__device__ __forceinline__ bool meets_group(const float* xr, float4 p, float4 q) {
  if (!(q.z > 0.f)) return false;  // no real member
  const float lo[3] = {p.x, p.y, p.z};
  const float hi[3] = {p.w, q.x, q.y};
  float tmin, tmax;
  slab_t(xr, lo, hi, tmin, tmax);
  const float bnd = fmaxf(fabsf(tmin), __fadd_rn(__fmul_rn(fabsf(tmax), 1.00001f), 1e-4f));
  const float s = __fadd_rn(__fmul_rn(1e-6f, bnd), 1e-5f);
  const float t_in = fmaxf(__fsub_rn(tmin, s), 0.f);
  const float t_out = __fadd_rn(tmax, s);
  return (t_out >= t_in) && (t_out > 0.f) && (t_in < xr[6]);
}

// kR rays a thread (adjacent), or, with kL > 1, one ray a kL lanes (the
// split form: lane `sub` of a ray takes groups sub, sub + kL, ...), whose
// kept keys merge at the end.
template <int kR, int kL>
__global__ void __launch_bounds__(kThreads)
pair_extract_kernel(const float* __restrict__ x, const float* __restrict__ slab,
                    const float* __restrict__ blk, int* __restrict__ ids,
                    float* __restrict__ lbov, int* __restrict__ cnt,
                    float* __restrict__ feat, int n, int kp, int F) {
  static_assert(kL == 1 || (kR == 1 && 32 % kL == 0), "a split ray is one ray of kL lanes");
  // Per block: {lo_x, lo_y, lo_z, hi_x} and {hi_y, hi_z, r2, 0}; per group
  // the same with {.., .., nonempty, 0}.
  __shared__ float4 sb[2 * kChunk];
  __shared__ float4 sg[2 * kGroups];
  const int sub = threadIdx.x % kL;
  const int i0 = kL > 1 ? blockIdx.x * (kThreads / kL) + threadIdx.x / kL
                        : (blockIdx.x * kThreads + threadIdx.x) * kR;

  Ray ray[kR];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + r;
    if (i < n) {
      const float4* row = reinterpret_cast<const float4*>(x + (size_t)i * 16);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 p = row[v];
        ray[r].xr[4 * v + 0] = p.x;
        ray[r].xr[4 * v + 1] = p.y;
        ray[r].xr[4 * v + 2] = p.z;
        ray[r].xr[4 * v + 3] = p.w;
      }
    } else {
#pragma unroll
      for (int f = 0; f < 16; ++f) ray[r].xr[f] = 0.f;
    }
    ray[r].act = i < n && ray[r].xr[7] > 0.f;
    any |= ray[r].act;
#pragma unroll
    for (int j = 0; j < kKeep; ++j) ray[r].top[j] = kDeadKey;
    ray[r].count = 0;
  }

  if (__syncthreads_or(any)) {  // else a dead thread block: nothing to test
    const bool warp_live = __any_sync(0xffffffffu, any);
    for (int k0 = 0; k0 < kp; k0 += kChunk) {
      const int kc = min(kChunk, kp - k0);
      __syncthreads();  // the previous chunk's readers are done
      for (int k = threadIdx.x; k < kc; k += kThreads) {
        const int g = k0 + k;
        sb[2 * k] = make_float4(slab[0 * kp + g], slab[1 * kp + g], slab[2 * kp + g],
                                slab[3 * kp + g]);
        sb[2 * k + 1] = make_float4(slab[4 * kp + g], slab[5 * kp + g], blk[5 * kp + g], 0.f);
      }
      __syncthreads();
      const int ng = (kc + kGroup - 1) / kGroup;
      for (int g = threadIdx.x; g < ng; g += kThreads) {  // the union boxes
        float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
        bool real = false;
        for (int k = g * kGroup; k < min(kc, (g + 1) * kGroup); ++k) {
          const float4 p = sb[2 * k], q = sb[2 * k + 1];
          if (!(q.z >= 0.f)) continue;  // sentinel block (r2 < 0)
          real = true;
          const float blo[3] = {p.x, p.y, p.z}, bhi[3] = {p.w, q.x, q.y};
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            lo[a] = fminf(lo[a], fminf(blo[a], bhi[a]));
            hi[a] = fmaxf(hi[a], fmaxf(blo[a], bhi[a]));
          }
        }
        sg[2 * g] = make_float4(lo[0], lo[1], lo[2], hi[0]);
        sg[2 * g + 1] = make_float4(hi[1], hi[2], real ? 1.f : -1.f, 0.f);
      }
      __syncthreads();
      if (!warp_live) continue;  // no live ray in this warp
      for (int g0 = 0; g0 < ng; g0 += kL) {  // warp-uniform
        const int g = g0 + sub;  // this lane's group
        bool meet = false;
        if (g < ng) {
          const float4 gp = sg[2 * g], gq = sg[2 * g + 1];
#pragma unroll
          for (int r = 0; r < kR; ++r) meet |= ray[r].act && meets_group(ray[r].xr, gp, gq);
        }
        if (!__any_sync(0xffffffffu, meet)) continue;
        for (int k = g * kGroup; k < min(kc, (g + 1) * kGroup); ++k) {
          const float4 p = sb[2 * k], q = sb[2 * k + 1];
          if (!(q.z >= 0.f)) continue;  // sentinel block (r2 < 0)
#pragma unroll
          for (int r = 0; r < kR; ++r)
            if (ray[r].act) test_block(ray[r], p, q, k0 + k);
        }
      }
    }
  }

  if constexpr (kL > 1) {  // merge the kL lanes' kept keys (unique: one lane pops each)
    for (int o = 1; o < kL; o <<= 1) ray[0].count += __shfl_xor_sync(0xffffffffu, ray[0].count, o);
    int merged[kKeep];
#pragma unroll
    for (int j = 0; j < kKeep; ++j) {
      int m = ray[0].top[0];
#pragma unroll
      for (int o = 1; o < kL; o <<= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, o));
      const bool pop = ray[0].top[0] == m;  // all heads dead: popping changes nothing
#pragma unroll
      for (int q = 0; q + 1 < kKeep; ++q) ray[0].top[q] = pop ? ray[0].top[q + 1] : ray[0].top[q];
      ray[0].top[kKeep - 1] = pop ? kDeadKey : ray[0].top[kKeep - 1];
      merged[j] = m;
    }
#pragma unroll
    for (int j = 0; j < kKeep; ++j) ray[0].top[j] = merged[j];
  }

  // Keys at or above BIG's (truncated) bits are not feasible entries.
  const int big_key = __float_as_int(kBig) & ~kIdxMask;
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + r;
    if (i >= n || sub) continue;
    const int* top = ray[r].top;
    const float* xr = ray[r].xr;
    int over = top[0];
#pragma unroll
    for (int j = 0; j < kMaxSlots; ++j) {
      if (j < F) ids[(size_t)i * F + j] = top[j] < big_key ? (top[j] & kIdxMask) : kp;
      if (j + 1 == F) over = top[j + 1];
    }
    lbov[i] = over < big_key ? __int_as_float(over & ~kIdxMask) : kBig;
    cnt[i] = ray[r].count;

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
    fr[10] = xr[6];
#pragma unroll
    for (int f = 11; f < 16; ++f) fr[f] = __fmul_rn(0.f, af);
    float4* out = reinterpret_cast<float4*>(feat + (size_t)i * 16);
#pragma unroll
    for (int v = 0; v < 4; ++v)
      out[v] = make_float4(fr[4 * v], fr[4 * v + 1], fr[4 * v + 2], fr[4 * v + 3]);
  }
}

}  // namespace

// x [n, 16], slab and blk [8, kp]; outputs ids [n, F], lbov and cnt [n],
// feat [n, 16]. split: the split form, for calls whose live rays are few
// (the pair path's pass 2); the results are the same.
extern "C" int pair_extract(const float* x, const float* slab, const float* blk,
                            int* ids, float* lbov, int* cnt, float* feat, int n,
                            int kp, int F, int split, cudaStream_t stream) {
  if (split) {
    constexpr int per = kThreads / kSplitLanes;  // rays a thread block
    pair_extract_kernel<1, kSplitLanes><<<(n + per - 1) / per, kThreads, 0, stream>>>(
        x, slab, blk, ids, lbov, cnt, feat, n, kp, F);
  } else {
    constexpr int per = kThreads * kRpt;
    pair_extract_kernel<kRpt, 1><<<(n + per - 1) / per, kThreads, 0, stream>>>(
        x, slab, blk, ids, lbov, cnt, feat, n, kp, F);
  }
  return (int)cudaGetLastError();
}

// The launcher needs 1 <= F <= this.
extern "C" int pair_extract_max_slots() { return kMaxSlots; }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
