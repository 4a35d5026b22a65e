// The round loop of the walk (kernel 2, walk.cu) and of the cluster rounds
// (kernel 10, cluster_rounds.cu), and the staging of a block's sparse
// weights, which the pair tests' part loop (pair_part.cuh: kernels 6 and
// 7) shares.
//
// The rounds are the walk with a budget: both walk, per ray tile, a list of
// entry-ordered blocks (sel, with entry bounds lb ascending) keeping each
// ray's nearest hit. The walk's list is every feasible block (K columns),
// the rounds' the first R (R columns, padded with lb = BIG). Each .cu keeps
// its own entry point, launch shape and library; both run walk_part.
//
// Round rr of tile g tests block k = sel[g, rr]: the Moller-Trumbore
// quantities (a, t_num, u_num, v_num) of each triangle are dot products of
// the ray's features r = [o, d, o x d, 1] with the block's weight columns
// w[k] ([16, 4B]), and the epilogue of ops/mxu_bf.py accepts a > eps,
// u, v >= 0, u + v <= a, t >= 0, t < best. Ties go to the smaller slot
// within a block and to the earlier round across blocks (strict <), as in
// the TPU kernels. A ray takes part in round rr only while it is live, its
// best t exceeds lb[g, rr], the tile-min conservative entry into the block
// (the slab cull's for the walk, the sphere cull's for the rounds), and it
// meets the block's box, widened by a margin (box_margin), before its best
// t. A hit in the block lies in its box, so it has t at or past both
// entries, and the accept test is strict. The margin is in position space,
// far above the rounding of the test (an axis along which the ray does not
// move at all is a containment test, not a slab): the slab cull's own
// per-ray entry is not conservative alone, since a ray with d_x = 0 whose
// o_x lies on a box face gets an exit (hi - o) x 1e7 = 0 from its clamped
// 1/d. A part of a tile stops when no live ray of it has a best t above the
// next block's entry bound lb[g, rr + 1] (lb ascends and a best t only
// falls, so no later round could run), or when the list (ns blocks: the
// lb < BIG entries) is exhausted. The skips are exact; walk.py _box_entry
// is the plain form of the box test, and tests/test_torch_walk.py and
// tests/test_torch_cluster.py hold both premises on the inputs of each.
//
// Precondition: w comes from build_cluster_mesh (ops/cluster.py) or
// ops/mxu_bf.py tri_weights, whose zero pattern mt_block.cuh describes
// (mxu_bf.check_sparse_pattern; chip_smoke.py asserts it on the tables it
// launches these kernels on). Only real[k] leading slots of block k are
// tested: the rest are the build's degenerate padding (a = 0, never hit).
//
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
//   - One thread block walks a part of kRpt x kThreads rays of a tile; a
//     tile of more rays is several parts, each walking the tile's list
//     with its own exit. The entry points launch parts longest list first
//     (`order`), so the short lists fill the tail of the last wave.

#pragma once

#include "mt_block.cuh"

namespace rw {

// A raw run of `block` slots, padded: 16-byte aligned rows (cp.async) whose
// starts fall in different banks.
__host__ __device__ __forceinline__ int raw_stride(int block) { return ((block + 3) & ~3) + 4; }

// Floats of one staged block: its raw runs, then its transposed table.
__host__ __device__ __forceinline__ int raw_floats(int block) {
  return mt::kSparse * raw_stride(block);
}
__host__ __device__ __forceinline__ int tb_floats(int block) { return mt::kSparse * block; }

// Shared memory one staged block takes, raw and transposed (bytes).
inline int staged_bytes(int block) {
  return (raw_floats(block) + tb_floats(block)) * (int)sizeof(float);
}

// Issue the copy of block k's first nr slots of each of the 16 sparse
// weight runs into raw row i (rounded up to whole float4 when the runs are
// 16-byte aligned, i.e. block % 4 == 0; else one float a copy). Every
// thread of the kThreads takes part.
template <int kThreads>
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

// tb[16 j + i] = raw[i][j] for the block's nr real slots.
template <int kThreads>
__device__ __forceinline__ void transpose(float* tb, const float* raw, int nr, int stride) {
  for (int e = threadIdx.x; e < mt::kSparse * nr; e += kThreads) {
    const int i = e & (mt::kSparse - 1);
    const int j = e >> 4;
    tb[e] = raw[i * stride + j];
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

// Staged triangle j (id id0 + j) against the rays of the groups that take
// part: an accepted hit nearer than a ray's best t replaces it.
template <int kRpt>
__device__ __forceinline__ void test_tri(const float4* tb4, int j, int id0, unsigned groups,
                                         const bool (&take)[kRpt],
                                         const float (&rf)[kRpt][mt::kFeat], float (&bt)[kRpt],
                                         int (&bi)[kRpt]) {
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

// One part of tile g: the kRpt x kThreads rays from `base` on walk the
// tile's list (sel_g, lb_g: its ns leading entries) over the table w
// (real [K], slab [8, kslab]: rows lo_xyz hi_xyz of block k at column k),
// and write each ray's (bt, btri); unless null, rounds_out[2 g] and
// [2 g + 1] gain the rounds the part ran and the (32-ray group, real slot)
// tests its warps ran. `smem` holds staged_bytes(block). The triangle loop
// is unrolled kUnroll times (0: as the compiler chooses).
template <int kRpt, int kThreads, int kUnroll>
__device__ __forceinline__ void walk_part(
    const int* __restrict__ sel_g, const float* __restrict__ lb_g, int ns, int g, int base,
    const float* __restrict__ r, const float* __restrict__ t0, const float* __restrict__ act,
    const float* __restrict__ w, const int* __restrict__ real, const float* __restrict__ slab,
    int kslab, int tile, int block, float* __restrict__ bt_out, int* __restrict__ btri_out,
    int* __restrict__ rounds_out, float* smem) {
  const int stride = raw_stride(block);
  float* raw = smem;
  float* tb = raw + raw_floats(block);  // 64 stride bytes in: 16-byte aligned
  const float4* tb4 = reinterpret_cast<const float4*>(tb);

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

  if (ns > 0) stage<kThreads>(raw, w, sel_g[0], real[sel_g[0]], block, stride);
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
    transpose<kThreads>(tb, raw, nr, stride);
    __syncthreads();  // tb holds block k; raw is free
    const int nxt = rr + 1;
    if (nxt < ns) stage<kThreads>(raw, w, sel_g[nxt], real[sel_g[nxt]], block, stride);
    mt::cp_async_commit();  // the next block arrives while this one is tested

    const float lbr = lb_g[rr];
    float lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = __ldg(slab + a * kslab + k);
      hi[a] = __ldg(slab + (3 + a) * kslab + k);
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
      if constexpr (kUnroll > 0) {
#pragma unroll (kUnroll)
        for (int j = 0; j < nr; ++j) test_tri<kRpt>(tb4, j, id0, groups, take, rf, bt, bi);
      } else {  // the compiler's own unrolling
        for (int j = 0; j < nr; ++j) test_tri<kRpt>(tb4, j, id0, groups, take, rf, bt, bi);
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

}  // namespace rw
