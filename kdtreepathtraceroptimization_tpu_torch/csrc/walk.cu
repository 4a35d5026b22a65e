// Walk: per ray tile, intersect the tile's entry-ordered feasible blocks
// one after another, keeping each ray's nearest hit, and stop as soon as no
// live ray can still improve.
//
// Replaces the TPU kernel `_walk_kernel` (launcher `_walk_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/walk.py. Plain version: `_walk_ref`
// (the round loop `_cluster_ref`) in kdtreepathtraceroptimization_tpu_torch.
//
// Round rr of tile g tests block k = sel[g, rr]: the Moller-Trumbore
// quantities (a, t_num, u_num, v_num) of each triangle are dot products of
// the ray's features r = [o, d, o x d, 1] with the block's weight columns
// w[k] ([16, 4B]), and the epilogue of ops/mxu_bf.py accepts a > eps,
// u, v >= 0, u + v <= a, t >= 0, t < best. Ties go to the smaller slot
// within a block and to the earlier round across blocks (strict <), as in
// the TPU kernel. A ray takes part in round rr only while it is live, its
// best t exceeds lb[g, rr], the tile-min conservative entry into the
// block, and it meets the block's box, widened by a margin (box_margin),
// before its best t. A hit in the block lies in its box, so it has t at or
// past both entries, and the accept test is strict. The margin is in
// position space, far above the rounding of the test (an axis along which
// the ray does not move at all is a containment test, not a slab): the
// slab cull's own per-ray entry is not conservative alone, since a ray
// with d_x = 0 whose o_x lies on a box face gets an exit (hi - o) x 1e7 = 0
// from its clamped 1/d. The tile stops when no live ray's best t exceeds the
// next block's entry bound lb[g, rr + 1] (blocks come in entry order), or
// when the feasible list (nsel[g] blocks) is exhausted. The skips are
// exact; walk.py _box_entry is the plain form of the box test, and
// tests/test_torch_walk.py holds both premises on the walk's inputs.
//
// Precondition: w comes from build_cluster_mesh (ops/cluster.py) or
// ops/mxu_bf.py tri_weights, whose zero pattern mt_block.cuh describes
// (mxu_bf.check_sparse_pattern; chip_smoke.py asserts it on the table it
// launches this kernel on). Only real[k] leading slots of block k are
// tested: the rest are the build's degenerate padding (a = 0, never hit).
//
// Bound on this card: operations, by a little over bytes. Each needed (live
// ray, real triangle) test is 19 FMAs and 8 more f32 operations, but at ray
// granularity few tests are needed: most rays of a tile meet few of the
// boxes on the tile's list, and the bytes are a ray's features and bounds
// and the 16 weights of each real triangle those tests read, once.
// What the kernel spends its time on is the list itself: per round a staged
// block, two barriers and a box test per ray, and the tests of the ray
// groups that take part, in the few warps that have any.
// Design:
//   - The sparse test (mt::sparse_accept): 19 FMAs on a triangle's 16
//     distinct weights, where the TPU's matrix unit multiplies all 40.
//   - Real slots only, and a ray group (a warp's 32 rays of one of its
//     kRpt registers; the rays come sorted by direction and origin, so a
//     group's rays mostly enter the same boxes) in which no ray takes part
//     skips its tests; a warp none of whose groups does skips the triangle
//     loop.
//   - Staging overlaps the tests: the 16 runs of block k's real slots
//     (sparse weight i: row f of w's column group q) are copied by
//     cp.async into `raw`, transposed into `tb` (a triangle's 16 weights
//     contiguous: four float4 broadcasts), and the copy of the next block
//     in the list is issued before this one is tested. The wait for it
//     comes before the round's closing barrier, which is also the exit
//     test (__syncthreads_or), so a round costs two barriers.
//   - One thread block walks a part of kRpt x kThreads rays of a tile;
//     a tile of more rays is several parts, each walking the tile's list
//     with its own exit. Small parts (one ray a thread, 128 threads, six
//     thread blocks an SM: the fastest of the shapes chip_smoke.py times)
//     keep more independent lists in flight on an SM, so that the few warps
//     with tests to run in a round are not alone. Parts are launched
//     longest feasible list first (`order`, from nsel on the device), so
//     the short lists fill the tail of the last wave.

#include "mt_block.cuh"

namespace {

constexpr int kRpt = 1;         // rays a thread
constexpr int kThreads = 128;   // threads a thread block
constexpr int kMinBlocks = 6;   // thread blocks an SM must hold (__launch_bounds__)
constexpr int kPart = kRpt * kThreads;

// A raw run of `block` slots, padded: 16-byte aligned rows (cp.async) whose
// starts fall in different banks.
__host__ __device__ __forceinline__ int raw_stride(int block) { return ((block + 3) & ~3) + 4; }

// Issue the copy of block k's first nr slots of each of the 16 sparse
// weight runs into raw row i (rounded up to whole float4 when the runs are
// 16-byte aligned, i.e. block % 4 == 0; else one float a copy).
__device__ __forceinline__ void stage(float* raw, const float* __restrict__ w, int k, int nr,
                                      int block, int stride) {
  const float* wk = w + (size_t)k * 16 * 4 * block;
  if ((block & 3) == 0) {
    const int n4 = (nr + 3) >> 2;
    for (int v = threadIdx.x; v < mt::kSparse * n4; v += kThreads) {
      const int i = v / n4;
      const int x = v - i * n4;
      mt::cp_async16(raw + i * stride + 4 * x, wk + mt::sparse_run(i, block) + 4 * x);
    }
  } else {
    for (int v = threadIdx.x; v < mt::kSparse * nr; v += kThreads) {
      const int i = v / nr;
      const int x = v - i * nr;
      mt::cp_async4(raw + i * stride + x, wk + mt::sparse_run(i, block) + x);
    }
  }
}

// Whether a ray (origin o, direction d, inv[a] = 1 / d[a] or 0 where d[a]
// = 0) meets the box [lo - m, hi + m] at some t in [0, t], with the
// margin m of box_margin: walk.py _box_entry(o, d, box) <= t is its plain form.
__device__ __forceinline__ bool meets_box(const float* o, const float* d, const float* inv,
                                          const float* lo, const float* hi, float m, float t) {
  float t_in = 0.f, t_out = t;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float l = __fsub_rn(lo[a], m);
    const float h = __fadd_rn(hi[a], m);
    if (d[a] == 0.f) {
      if (!(o[a] >= l && o[a] <= h)) return false;
    } else {
      const float t1 = __fmul_rn(__fsub_rn(l, o[a]), inv[a]);
      const float t2 = __fmul_rn(__fsub_rn(h, o[a]), inv[a]);
      t_in = fmaxf(t_in, fminf(t1, t2));
      t_out = fminf(t_out, fmaxf(t1, t2));
    }
  }
  return t_in <= t_out;
}

// The margin the box test widens a box [lo, hi] by: 1e-3 of its largest
// extent plus 1e-4 (walk.py BOX_MARGIN_REL, BOX_MARGIN_ABS).
__device__ __forceinline__ float box_margin(const float* lo, const float* hi) {
  const float ext = fmaxf(fmaxf(__fsub_rn(hi[0], lo[0]), __fsub_rn(hi[1], lo[1])),
                          __fsub_rn(hi[2], lo[2]));
  return __fadd_rn(__fmul_rn(1e-3f, ext), 1e-4f);
}

// tb[16 j + i] = raw[i][j] for the block's nr real slots.
__device__ __forceinline__ void transpose(float* tb, const float* raw, int nr, int stride) {
  for (int e = threadIdx.x; e < mt::kSparse * nr; e += kThreads) {
    const int i = e & (mt::kSparse - 1);
    const int j = e >> 4;
    tb[e] = raw[i * stride + j];
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
walk_kernel(const int* __restrict__ sel, const float* __restrict__ lb,
            const int* __restrict__ nsel, const int* __restrict__ order,
            const float* __restrict__ r, const float* __restrict__ t0,
            const float* __restrict__ act, const float* __restrict__ w,
            const int* __restrict__ real, const float* __restrict__ slab,
            float* __restrict__ bt_out,
            int* __restrict__ btri_out, int* __restrict__ rounds_out, int kp, int tile,
            int block, int parts) {
  extern __shared__ float4 smem4[];
  const int stride = raw_stride(block);
  float* raw = reinterpret_cast<float*>(smem4);
  float* tb = raw + mt::kSparse * stride;  // 64 stride bytes in: 16-byte aligned
  const float4* tb4 = reinterpret_cast<const float4*>(tb);

  const int g = order[blockIdx.x / parts];
  const int base = (blockIdx.x % parts) * kPart;  // this part's first ray in the tile
  const int* sel_g = sel + (size_t)g * kp;
  const float* lb_g = lb + (size_t)g * kp;
  const int ns = nsel[g];

  float rf[kRpt][mt::kFeat];
  float inv[kRpt][3];  // 1 / d, 0 where d = 0 (the box test)
  float bt[kRpt];
  int bi[kRpt];
  bool on[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int q = base + threadIdx.x + i * kThreads;
    const size_t ray = (size_t)g * tile + (q < tile ? q : 0);
    const float4* r4 = reinterpret_cast<const float4*>(r + ray * 16);
    const float4 p0 = r4[0], p1 = r4[1], p2 = r4[2];
    const float f[12] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w, p2.x, p2.y, p2.z, p2.w};
#pragma unroll
    for (int k = 0; k < mt::kFeat; ++k) rf[i][k] = f[k];
#pragma unroll
    for (int a = 0; a < 3; ++a) inv[i][a] = rf[i][3 + a] == 0.f ? 0.f : __frcp_rn(rf[i][3 + a]);
    bt[i] = t0[ray];
    bi[i] = -1;
    on[i] = q < tile && act[ray] > 0.f;
  }
  int group_tests = 0;  // (ray group, real slot) tests this warp ran, counted by lane 0

  if (ns > 0) stage(raw, w, sel_g[0], real[sel_g[0]], block, stride);
  mt::cp_async_commit();
  bool want = false;
  if (ns > 0) {
    const float lb0 = lb_g[0];
#pragma unroll
    for (int i = 0; i < kRpt; ++i) want |= on[i] && bt[i] > lb0;
  }
  mt::cp_async_wait_all();
  int live = __syncthreads_or(want);  // and raw holds block sel[g, 0]

  int rounds = 0;
  for (int rr = 0; live; ++rr) {
    const int k = sel_g[rr];
    const int nr = real[k];
    transpose(tb, raw, nr, stride);
    __syncthreads();  // tb holds block k; raw is free
    const int nxt = rr + 1;
    if (nxt < ns) stage(raw, w, sel_g[nxt], real[sel_g[nxt]], block, stride);
    mt::cp_async_commit();  // the next block arrives while this one is tested

    const float lbr = lb_g[rr];
    float lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = __ldg(slab + a * kp + k);
      hi[a] = __ldg(slab + (3 + a) * kp + k);
    }
    const float m = box_margin(lo, hi);
    bool take[kRpt];
    unsigned groups = 0;  // bit i: some ray of this warp's group i takes part (warp-uniform)
#pragma unroll
    for (int i = 0; i < kRpt; ++i) {
      take[i] = on[i] && bt[i] > lbr && meets_box(rf[i], rf[i] + 3, inv[i], lo, hi, m, bt[i]);
      if (__any_sync(0xffffffffu, take[i])) groups |= 1u << i;
    }
    group_tests += __popc(groups) * nr;
    if (groups) {
      const int id0 = k * block;
      for (int j = 0; j < nr; ++j) {
        float wj[mt::kSparse];
        mt::load_sparse(tb4, j, wj);
#pragma unroll
        for (int i = 0; i < kRpt; ++i) {
          if (!(groups >> i & 1u)) continue;
          float a, tn;
          if (mt::sparse_accept(rf[i], wj, a, tn) && take[i]) {
            const float t = __fdiv_rn(tn, a);
            if (t < bt[i]) {
              bt[i] = t;
              bi[i] = id0 + j;
            }
          }
        }
      }
    }
    ++rounds;

    want = false;
    if (nxt < ns) {
      const float nlb = lb_g[nxt];
#pragma unroll
      for (int i = 0; i < kRpt; ++i) want |= on[i] && bt[i] > nlb;
    }
    mt::cp_async_wait_all();
    live = __syncthreads_or(want);  // every thread is done with tb; raw holds the next block
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int q = base + threadIdx.x + i * kThreads;
    if (q >= tile) continue;
    const size_t ray = (size_t)g * tile + q;
    bt_out[ray] = bt[i];
    btri_out[ray] = bi[i];
  }
  if (rounds_out && threadIdx.x == 0) atomicAdd(rounds_out + 2 * g, rounds);
  if (rounds_out && (threadIdx.x & 31) == 0) atomicAdd(rounds_out + 2 * g + 1, group_tests);
}

int smem_bytes(int block) {
  return (mt::kSparse * raw_stride(block) + mt::kSparse * block) * (int)sizeof(float);
}

}  // namespace

// sel, lb [n / tile, kp], nsel [n / tile] and order [n / tile] (the tiles,
// longest list first); r [n, 16], t0, act [n]; w [kp, 16, 4 block], real
// [kp] and slab [8, kp] (rows lo_xyz hi_xyz); outputs bt, btri [n] and,
// unless null, rounds [n / tile, 2] (zeroed by the caller; each tile's
// thread blocks add the rounds they ran and the (32-ray group, real slot)
// tests their warps ran).
extern "C" int walk(const int* sel, const float* lb, const int* nsel, const int* order,
                    const float* r, const float* t0, const float* act, const float* w,
                    const int* real, const float* slab, float* bt, int* btri, int* rounds,
                    int n, int kp, int tile, int block, cudaStream_t stream) {
  if (tile <= 0 || block <= 0 || n % tile) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(block);
  cudaError_t err = mt::allow_smem((const void*)walk_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int parts = (tile + kPart - 1) / kPart;
  walk_kernel<<<(n / tile) * parts, kThreads, smem, stream>>>(
      sel, lb, nsel, order, r, t0, act, w, real, slab, bt, btri, rounds, kp, tile, block, parts);
  return (int)cudaGetLastError();
}

// Shared memory a thread block takes for blocks of `block` triangles (bytes).
extern "C" int walk_smem_bytes(int block) { return smem_bytes(block); }

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
