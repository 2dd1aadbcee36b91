// Per-chunk MDS decode, from the raw partials to y in its final order:
//   out[c·stride_c + i·stride_i + col] = Σ_j W[c, i, j] · parts[table[c, j], col].
//
// Replaces src/repro/kernels/mds_decode.py::mds_decode_pallas, whose function
// (out[c] = W[c] @ Y[c]) is the case of the identity table and contiguous
// output strides (a null table stands for the identity).
//
// Bound on Hopper: device-memory bytes, and at the main path's size
// (C = 20, k = m = 10, r = 3000: about 4.8 MB, 1.4 µs at the HBM rate) the
// launch itself.  The contraction is tiny (m ≤ 32) and r is large, so there
// is nothing for the tensor cores to do.  No design brings an op this small
// near its bound as a launch of its own, so this one does the work of three:
// it reads each chunk's m partial rows where coded_matvec left them (through
// the position table, instead of an index-gather copy) and writes the k
// decoded rows through two output strides straight into y's final layout
// (instead of a transpose copy).
// Design: one block per (chunk, 512-column tile of r).  The block stages W[c]
// and the m source-row pointers in shared memory; each thread owns 4
// consecutive columns, loads them from the m partial rows with 16-byte loads
// into registers (all loads issued before any arithmetic), and writes its k
// outputs with 16-byte stores.  Unaligned rows or strides take scalar loads,
// and a ragged r % 4 edge is masked.  A table entry outside the partials
// yields NaN and no read.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxKM = 32;

template <int MB, bool VEC>
__global__ void __launch_bounds__(kThreads)
mds_decode_kernel(const float* __restrict__ w, const float* __restrict__ parts,
                  const int32_t* __restrict__ table, float* __restrict__ out, int k, int m,
                  int64_t r, int64_t n_parts, int64_t ld, int64_t stride_c, int64_t stride_i) {
  __shared__ float ws[kMaxKM * kMaxKM];
  __shared__ const float* src[kMaxKM];
  const int64_t c = blockIdx.y;
  for (int t = threadIdx.x; t < k * m; t += blockDim.x) ws[t] = w[c * k * m + t];
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const int64_t p = table ? static_cast<int64_t>(table[c * m + t]) : c * m + t;
    src[t] = (p >= 0 && p < n_parts) ? parts + p * ld : nullptr;
  }
  __syncthreads();

  const int64_t col = 4 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (col >= r) return;
  const bool vec = VEC && col + 4 <= r;
  float yv[MB][4];
#pragma unroll
  for (int j = 0; j < MB; ++j) {
    if (j < m) {
      const float* s = src[j];
      if (s == nullptr) {
#pragma unroll
        for (int e = 0; e < 4; ++e) yv[j][e] = CUDART_NAN_F;
      } else if (vec) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(s + col));
        yv[j][0] = v.x; yv[j][1] = v.y; yv[j][2] = v.z; yv[j][3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) yv[j][e] = col + e < r ? __ldg(s + col + e) : 0.f;
      }
    }
  }
  float* o = out + c * stride_c + col;
  for (int i = 0; i < k; ++i) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < MB; ++j) {
      if (j < m) {
        const float wv = ws[i * m + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = fmaf(wv, yv[j][e], acc[e]);
      }
    }
    float* oi = o + i * stride_i;
    if (vec) {
      *reinterpret_cast<float4*>(oi) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < r) oi[e] = acc[e];
    }
  }
}

template <int MB>
void launch(bool vec, dim3 grid, cudaStream_t stream, const float* w, const float* parts,
            const int32_t* table, float* out, int k, int m, int64_t r, int64_t n_parts,
            int64_t ld, int64_t stride_c, int64_t stride_i) {
  if (vec)
    mds_decode_kernel<MB, true><<<grid, kThreads, 0, stream>>>(
        w, parts, table, out, k, m, r, n_parts, ld, stride_c, stride_i);
  else
    mds_decode_kernel<MB, false><<<grid, kThreads, 0, stream>>>(
        w, parts, table, out, k, m, r, n_parts, ld, stride_c, stride_i);
}

}  // namespace

// w: (C, k, m) contiguous; parts: n_parts rows of r, row stride ld; table:
// (C, m) int32 row numbers of parts, or null for row c·m + j; out: column
// stride 1, strides stride_c and stride_i.  All float32 but the table.
S2C2_API int s2c2_mds_decode(const void* w, const void* parts, const void* table, void* out,
                             int64_t chunks, int64_t k, int64_t m, int64_t r, int64_t n_parts,
                             int64_t ld, int64_t stride_c, int64_t stride_i, void* stream) {
  if (k < 1 || k > kMaxKM || m < 1 || m > kMaxKM || chunks < 1 || chunks > 65535 || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (reinterpret_cast<uintptr_t>(parts) | reinterpret_cast<uintptr_t>(out)) % 16
                       == 0 && (ld | stride_c | stride_i) % 4 == 0;
  const dim3 grid(static_cast<unsigned>((r + 4 * kThreads - 1) / (4 * kThreads)),
                  static_cast<unsigned>(chunks));
  auto s = static_cast<cudaStream_t>(stream);
  const auto* w_ = static_cast<const float*>(w);
  const auto* p_ = static_cast<const float*>(parts);
  const auto* t_ = static_cast<const int32_t*>(table);
  auto* o_ = static_cast<float*>(out);
  const int k_ = static_cast<int>(k), m_ = static_cast<int>(m);
  if (m <= 8)
    launch<8>(vec, grid, s, w_, p_, t_, o_, k_, m_, r, n_parts, ld, stride_c, stride_i);
  else if (m <= 16)
    launch<16>(vec, grid, s, w_, p_, t_, o_, k_, m_, r, n_parts, ld, stride_c, stride_i);
  else
    launch<32>(vec, grid, s, w_, p_, t_, o_, k_, m_, r, n_parts, ld, stride_c, stride_i);
  return static_cast<int>(cudaGetLastError());
}
