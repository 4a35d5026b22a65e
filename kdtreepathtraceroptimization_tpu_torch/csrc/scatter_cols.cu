// Scatter-add from columns: grad[tri[i], c] += ct[c, i], the adjoint of
// gather-to-columns (csrc/gather_cols.cu).
//
// Replaces the TPU kernel `_cols_to_rows_pallas` in
// kdtreepathtraceroptimization_tpu/ops/mesh.py (the VJP of the forward
// transpose), fused with the adjoint of the row gather `packed[tri]` that
// follows it (a scatter-add into the [T, C] table). Plain version:
// `_scatter_cols_ref` in kdtreepathtraceroptimization_tpu_torch/ops/mesh.py.
//
// ct is the cotangent of the C channel arrays [C, n] (C = 19); the result
// is the cotangent of the per-triangle record [T, C], zeroed by the
// wrapper before the launch.
//
// Bound on this card: bytes. It reads the n*C cotangents and n ids once
// and writes the T*C table once; it computes one add per entry. Design:
// one thread per ray; for a fixed channel, neighbouring threads read
// neighbouring cotangents, so the loads coalesce. Many rays hit one
// triangle, so the adds are float atomics into global memory, in an order
// that changes from run to run: the sum is not bit-reproducible, and it
// differs from the plain version's by rounding only. A zero cotangent is
// skipped (adding +0.0 changes no sum): ray lanes that miss the mesh read
// row 0 and carry zero cotangents, and on a render's first bounce they are
// about nine lanes in ten, which would otherwise all add into the 19
// addresses of row 0. The TPU spread misses over other rows instead.

#include <cuda_runtime.h>

namespace {

__global__ void scatter_cols_kernel(const float* __restrict__ ct,
                                    const int* __restrict__ tri,
                                    float* __restrict__ out, int n, int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float* row = out + (size_t)tri[i] * c;
  for (int j = 0; j < c; ++j) {
    const float g = ct[(size_t)j * n + i];
    if (g != 0.0f) atomicAdd(row + j, g);
  }
}

}  // namespace

extern "C" int scatter_cols(const float* ct, const int* tri, float* out,
                            int n, int c, cudaStream_t stream) {
  const int threads = 256;
  scatter_cols_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      ct, tri, out, n, c);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
