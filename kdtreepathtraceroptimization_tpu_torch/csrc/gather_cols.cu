// Gather-to-columns: out[c, i] = packed[tri[i], c], i.e. packed[tri].T.
//
// Replaces the TPU kernel `_rows_to_cols_pallas` in
// kdtreepathtraceroptimization_tpu/ops/mesh.py, fused with the row gather
// in front of it (`packed[tri]` in `tri_hit_to_hit`). Plain version:
// `_gather_cols_ref` in kdtreepathtraceroptimization_tpu_torch/ops/mesh.py.
//
// packed is the per-triangle record [T, C] (C = 19: v0 v1 v2 n0 n1 n2
// material); the result is C channel arrays [C, n], one per field, which
// the hit expansion reads as contiguous [n] vectors.
//
// Bound on this card: bytes. It reads each id and each row the ids name
// once, writes each output float once, and computes nothing. Design: one
// thread per ray reads its row (the C floats of one row are contiguous, so
// the row arrives in one or two cache lines) and writes each channel; for a
// fixed channel, neighbouring threads write neighbouring addresses, so the
// stores coalesce. The TPU
// version needed a separate transpose because its gather produced rows.

#include <cuda_runtime.h>

namespace {

__global__ void gather_cols_kernel(const float* __restrict__ packed,
                                   const int* __restrict__ tri,
                                   float* __restrict__ out, int n, int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* row = packed + (size_t)tri[i] * c;
  for (int j = 0; j < c; ++j) out[(size_t)j * n + i] = row[j];
}

}  // namespace

extern "C" int gather_cols(const float* packed, const int* tri, float* out,
                           int n, int c, cudaStream_t stream) {
  const int threads = 256;
  gather_cols_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      packed, tri, out, n, c);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
