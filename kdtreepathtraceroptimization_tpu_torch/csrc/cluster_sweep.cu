// The exactness repair sweep: each listed ray against every real triangle
// of the cluster table, bounded by its own best t.
//
// Replaces the TPU kernel `_sweep_kernel` (launcher `_sweep_pallas`) in
// kdtreepathtraceroptimization_tpu/ops/cluster.py. Plain version:
// `_sweep_ref` in kdtreepathtraceroptimization_tpu_torch/ops/cluster.py.
//
// The function: for each listed row (rows [m]), the ray's features
// r[row] and its bound t0 = bt[row]; the nearest Moller-Trumbore hit with
// t < t0 over blocks 0 .. kreal-1 (strict < across blocks, the first slot
// within a block: the smallest global id k * B + slot among the nearest),
// written to bt_out[row], btri_out[row] only where one was found. The
// outputs start as copies of bt and btri, so the merge of the repair into
// the rounds' result happens here. Rows must be distinct.
//
// Bound on this card: operations. Each (listed live ray, real triangle)
// test is 40 FMAs and about 8 more f32 operations; the weights (40 floats
// a triangle) stay in L2 and each ray's 40 bytes of features are read once.
// Design:
//   - Only the listed rays: the caller lists the flagged ones. A ray that
//     is not flagged cannot change, so the TPU kernel's sweep of every
//     tile is mostly wasted work.
//   - Only real slots: a leaf padded to the block size ends in degenerate
//     copies (a = 0, never accepted); real[k] counts block k's real
//     triangles, which come first, and only those are staged and tested.
//   - Staging overlaps the tests: each chunk of at most kChunk triangles
//     (rows 0-9 of w's columns j, B + j, 2B + j, 3B + j: 40 contiguous runs)
//     is copied into a raw buffer with 16-byte cp.async.cg, transposed in
//     shared memory so that triangle j's 40 weights are contiguous (the
//     layout mt::load_tri reads as ten float4 broadcasts), and the copy of
//     the next chunk is issued before the current one is tested.
//   - Enough thread blocks: kRpt = 4 rays a thread, kThreads = 256 threads
//     (the fastest of the shapes tried on the H100; PERF.md). When the
//     listed rays make fewer thread blocks than two waves of the card,
//     the block axis is split into `slices` (grid.y): each thread block
//     tests its rays against a contiguous slice of the real blocks and
//     merges its nearest hit with a 64-bit atomicMin on (t bits << 32 |
//     global id) in key[m] (seeded all ones = no hit). Every accepted t is
//     >= 0, so the bit order is the value order (a -0 enters as +0), and
//     the minimum key is the sequential rule's winner. A last pass writes
//     the keys that hold a hit into bt_out and btri_out.

#include <stdint.h>

#include <algorithm>

#include "mt_block.cuh"

namespace {

constexpr int kChunk = 256;           // triangles of one staged chunk
constexpr int kRawStride = kChunk + 4;  // a raw row, padded: the transpose meets no bank conflict
constexpr int kRawFloats = mt::kTriFloats * kRawStride;
constexpr int kRpt = 4;               // rays a thread
constexpr int kThreads = 256;
constexpr int kSmemBytes = (kRawFloats + kChunk * mt::kTriFloats) * (int)sizeof(float);
constexpr uint64_t kNoHit = ~0ull;

// The chunk of block k that starts at slot j0: ntri triangles.
struct Chunk {
  int k, j0, ntri;
};

// The first chunk at or after (k, j0) within blocks < k1 (ntri = 0 past the end).
__device__ __forceinline__ Chunk chunk_at(const int* __restrict__ real, int k, int j0, int k1) {
  while (k < k1) {
    const int nr = __ldg(real + k);
    if (j0 < nr) return Chunk{k, j0, min(kChunk, nr - j0)};
    ++k;
    j0 = 0;
  }
  return Chunk{k1, 0, 0};
}

// Issue the copy of the chunk's weights: raw row q * 10 + f holds row f of
// w's columns q B + j0 .. (quantity q: a, t_num, u_num, v_num), rounded up
// to whole float4 (the slots past a block's real ones are its padding).
__device__ __forceinline__ void stage(float* raw, const float* __restrict__ w, Chunk c,
                                      int block) {
  const int n4 = (c.ntri + 3) >> 2;
  const float* wk = w + (size_t)c.k * 16 * 4 * block + c.j0;
  for (int v = threadIdx.x; v < mt::kTriFloats * n4; v += kThreads) {
    const int i = v / n4;
    const int x = v - i * n4;
    const int q = i / mt::kFeat;
    const int f = i - q * mt::kFeat;
    mt::cp_async16(raw + i * kRawStride + 4 * x,
                   wk + (size_t)f * 4 * block + q * block + 4 * x);
  }
}

// tb[40 j + i] = raw[i][j] for the chunk's ntri triangles. A warp takes 8
// rows i by 4 triangles j, so its reads (bank 4 i + j) and writes (bank
// 8 j + i) each meet 32 distinct banks.
__device__ __forceinline__ void transpose(float* tb, const float* raw, int ntri) {
  const int groups = (mt::kTriFloats / 8) * ((ntri + 3) >> 2);
  for (int e = threadIdx.x; e < 32 * groups; e += kThreads) {
    const int lane = e & 31;
    const int g = e >> 5;
    const int i = (g % (mt::kTriFloats / 8)) * 8 + (lane & 7);
    const int j = (g / (mt::kTriFloats / 8)) * 4 + (lane >> 3);
    if (j < ntri) tb[j * mt::kTriFloats + i] = raw[i * kRawStride + j];
  }
}

__global__ void __launch_bounds__(kThreads)
cluster_sweep_kernel(const int* __restrict__ rows, int m, const float* __restrict__ r,
                     const float* __restrict__ bt_in, const float* __restrict__ w,
                     const int* __restrict__ real, float* __restrict__ bt_out,
                     int* __restrict__ btri_out, unsigned long long* __restrict__ key,
                     int kreal, int block, int slices) {
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);
  const float4* tb4 = smem4 + kRawFloats / 4;
  float* tb = raw + kRawFloats;
  const int s = blockIdx.y;
  const int k0 = (int)((long long)kreal * s / slices);
  const int k1 = (int)((long long)kreal * (s + 1) / slices);

  Chunk cur = chunk_at(real, k0, 0, k1);
  if (cur.ntri) stage(raw, w, cur, block);
  mt::cp_async_commit();

  float rf[kRpt][mt::kFeat];
  float bt[kRpt];
  int bi[kRpt];
  int row[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int idx = blockIdx.x * kRpt * kThreads + i * kThreads + threadIdx.x;
    row[i] = idx < m ? rows[idx] : -1;
    const size_t rw = row[i] < 0 ? 0 : (size_t)row[i];
#pragma unroll
    for (int f = 0; f < mt::kFeat; ++f) rf[i][f] = r[rw * 16 + f];
    bt[i] = row[i] < 0 ? 0.f : bt_in[rw];  // t0 = 0: an unlisted lane never hits
    bi[i] = -1;
  }

  while (cur.ntri) {
    mt::cp_async_wait_all();
    __syncthreads();  // raw holds this chunk; every thread is done with tb
    transpose(tb, raw, cur.ntri);
    __syncthreads();  // tb holds this chunk; raw is free
    const Chunk next = chunk_at(real, cur.k, cur.j0 + kChunk, k1);
    if (next.ntri) stage(raw, w, next, block);  // arrives while this chunk is tested
    mt::cp_async_commit();
    const int id0 = cur.k * block + cur.j0;
    for (int j = 0; j < cur.ntri; ++j) {
      float wj[mt::kTriFloats];
      mt::load_tri(tb4, j, wj);
#pragma unroll
      for (int i = 0; i < kRpt; ++i) {
        float a, tn;
        if (mt::accept(rf[i], wj, a, tn)) {
          const float t = __fdiv_rn(tn, a);
          if (t < bt[i]) {
            bt[i] = t;
            bi[i] = id0 + j;
          }
        }
      }
    }
    cur = next;
  }

#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    if (bi[i] < 0) continue;
    if (slices == 1) {
      bt_out[row[i]] = bt[i];
      btri_out[row[i]] = bi[i];
    } else {
      const int idx = blockIdx.x * kRpt * kThreads + i * kThreads + threadIdx.x;
      const uint64_t bits = __float_as_uint(bt[i]) & 0x7fffffffu;
      atomicMin(key + idx, (unsigned long long)((bits << 32) | (uint32_t)bi[i]));
    }
  }
}

__global__ void sweep_decode_kernel(const int* __restrict__ rows, int m,
                                    const unsigned long long* __restrict__ key,
                                    float* __restrict__ bt_out, int* __restrict__ btri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const unsigned long long k = key[i];
  if (k == kNoHit) return;
  bt_out[rows[i]] = __uint_as_float((uint32_t)(k >> 32));
  btri_out[rows[i]] = (int)(uint32_t)k;
}

}  // namespace

// The number of block-axis slices the launch takes for m listed rays:
// 1 when their ceil(m / (kRpt kThreads)) thread blocks fill two waves of
// the card, else enough slices to fill them (at most kreal). -1 if the
// card's limits cannot be read.
extern "C" int cluster_sweep_slices(int m, int kreal) {
  const void* fn = (const void*)cluster_sweep_kernel;
  if (mt::allow_smem(fn, kSmemBytes) != cudaSuccess) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, kSmemBytes) !=
          cudaSuccess)
    return -1;
  const long long tiles = ((long long)m + kRpt * kThreads - 1) / (kRpt * kThreads);
  const long long want = 2LL * sms * (per_sm > 0 ? per_sm : 1);
  if (tiles == 0 || tiles >= want) return 1;
  return (int)std::max(1LL, std::min<long long>(kreal, (want + tiles - 1) / tiles));
}

extern "C" int cluster_sweep(const int* rows, int m, const float* r, const float* bt_in,
                             const float* w, const int* real, float* bt_out, int* btri_out,
                             unsigned long long* key, int kreal, int block, int slices,
                             cudaStream_t stream) {
  if (block % 4 || slices < 1 || (slices > 1 && !key)) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)cluster_sweep_kernel;
  cudaError_t err = mt::allow_smem(fn, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  if (slices > 1) {
    err = cudaMemsetAsync(key, 0xFF, (size_t)m * sizeof(unsigned long long), stream);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((m + kRpt * kThreads - 1) / (kRpt * kThreads), slices);
  cluster_sweep_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      rows, m, r, bt_in, w, real, bt_out, btri_out, key, kreal, block, slices);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  sweep_decode_kernel<<<(m + 255) / 256, 256, 0, stream>>>(rows, m, key, bt_out, btri_out);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
