// Per-chunk MDS decode: out[c] = W[c] @ Y[c], (C, k, m) × (C, m, r) → (C, k, r).
//
// Replaces src/repro/kernels/mds_decode.py::mds_decode_pallas.
//
// Bound on Hopper: device-memory bytes, and at the main path's size
// (C = 20, k = m = 10, r = 3000: about 4.8 MB) the launch itself.  The
// contraction is tiny (m ≤ 32) and r is large, so there is nothing for the
// tensor cores to do.
// Design: one block per (chunk, 256-column tile of r).  The block stages
// W[c] (k·m ≤ 32·32 floats) in shared memory; each thread loads its column of
// Y[c] (m coalesced loads across the block) into registers and writes its k
// outputs.  Y and the output are each touched once.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKM = 32;

__global__ void __launch_bounds__(kThreads)
mds_decode_kernel(const float* __restrict__ w, const float* __restrict__ y,
                  float* __restrict__ out, int k, int m, int64_t r) {
  __shared__ float ws[kMaxKM * kMaxKM];
  const int64_t c = blockIdx.y;
  for (int t = threadIdx.x; t < k * m; t += blockDim.x) ws[t] = w[c * k * m + t];
  __syncthreads();

  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= r) return;
  float yv[kMaxKM];
#pragma unroll
  for (int i = 0; i < kMaxKM; ++i)
    if (i < m) yv[i] = __ldg(y + (c * m + i) * r + col);
  for (int j = 0; j < k; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxKM; ++i)
      if (i < m) acc = fmaf(ws[j * m + i], yv[i], acc);
    out[(c * k + j) * r + col] = acc;
  }
}

}  // namespace

// w: (C, k, m); y: (C, m, r); out: (C, k, r); all float32, contiguous.
S2C2_API int s2c2_mds_decode(const void* w, const void* y, void* out, int64_t chunks,
                             int64_t k, int64_t m, int64_t r, void* stream) {
  if (k < 1 || k > kMaxKM || m < 1 || m > kMaxKM || chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((r + kThreads - 1) / kThreads),
                  static_cast<unsigned>(chunks));
  mds_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(y), static_cast<float*>(out),
      static_cast<int>(k), static_cast<int>(m), r);
  return static_cast<int>(cudaGetLastError());
}
