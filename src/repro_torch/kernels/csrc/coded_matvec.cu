// Slack-squeeze coded product: out[i] = A[ids[i]·br : (ids[i]+1)·br] @ x.
//
// Replaces src/repro/kernels/coded_matvec.py::coded_matvec_pallas.  Only the
// row-blocks named in `ids` are read, so a worker's cost scales with the
// chunks it was assigned, as in the paper.
//
// Bound on Hopper: device-memory bytes.  At nvec = 1 every element of A that
// is read is used for one multiply-add, far below the card's ~20 flops per
// byte, so the kernel can at best stream the assigned rows at the HBM rate.
// Design: one warp per row; each lane issues 16-byte read-only loads along
// the row (a 512-byte coalesced request per warp instruction), accumulates
// in float32, and the warp reduces with shuffles.  Each block covers
// kRowsPerBlock rows of one assigned row-block and reads that block's id
// itself (the TPU kernel's scalar prefetch).  The contraction dim is walked
// by a loop inside the warp, which stands in for the TPU's sequential
// d-tile grid axis and its VMEM accumulator.  A ragged d, or a row start
// that is not 16-byte aligned, takes the scalar path.  Offsets are 64-bit:
// the coded tensor's element count exceeds 2^31.
#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
coded_matvec_kernel(const T* __restrict__ a, const T* __restrict__ x,
                    const int32_t* __restrict__ ids, T* __restrict__ out,
                    int64_t n_blocks, int64_t tiles_per_block, int64_t br,
                    int64_t d, int nvec) {
  const int64_t i = blockIdx.x / tiles_per_block;  // which assigned block
  const int64_t row0 = (blockIdx.x % tiles_per_block) * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t id = ids[i];
  const bool valid = id >= 0 && id < n_blocks;

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int64_t r = row0 + rr * kWarps + warp;
    if (r >= br) break;
    float acc[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) acc[q] = 0.f;
    if (valid) {
      const T* arow = a + (id * br + r) * d;
      if constexpr (VEC) {
        using P = s2c2::Packet16<T>;
        const int64_t n_packets = d / P::N;
#pragma unroll 4
        for (int64_t p = lane; p < n_packets; p += 32) {
          float av[P::N];
          P::load(arow + p * P::N, av);
          if constexpr (NV == 1) {
            float xv[P::N];
            P::load(x + p * P::N, xv);
#pragma unroll
            for (int e = 0; e < P::N; ++e) acc[0] = fmaf(av[e], xv[e], acc[0]);
          } else {
#pragma unroll
            for (int e = 0; e < P::N; ++e) {
              const T* xk = x + (p * P::N + e) * nvec;
#pragma unroll
              for (int q = 0; q < NV; ++q)
                if (q < nvec) acc[q] = fmaf(av[e], s2c2::to_float(xk[q]), acc[q]);
            }
          }
        }
      } else {
        for (int64_t k = lane; k < d; k += 32) {
          const float av = s2c2::to_float(arow[k]);
          const T* xk = x + k * nvec;
#pragma unroll
          for (int q = 0; q < NV; ++q)
            if (q < nvec) acc[q] = fmaf(av, s2c2::to_float(xk[q]), acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NV; ++q) acc[q] = s2c2::warp_sum(acc[q]);
    if (lane == 0) {
      T* o = out + (i * br + r) * nvec;
#pragma unroll
      for (int q = 0; q < NV; ++q)
        // an id outside A yields NaN rows instead of an out-of-bounds read
        if (q < nvec) o[q] = s2c2::from_float<T>(valid ? acc[q] : CUDART_NAN_F);
    }
  }
}

template <typename T, int NV>
cudaError_t launch_nv(const void* a, const void* x, const int32_t* ids, void* out,
                      int64_t n_blocks, int64_t nb, int64_t br, int64_t d, int nvec,
                      bool vec, cudaStream_t stream) {
  const int64_t tiles = (br + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(static_cast<unsigned>(nb * tiles));
  const dim3 block(kWarps * 32);
  const T* a_ = static_cast<const T*>(a);
  const T* x_ = static_cast<const T*>(x);
  T* o_ = static_cast<T*>(out);
  if (vec)
    coded_matvec_kernel<T, NV, true><<<grid, block, 0, stream>>>(
        a_, x_, ids, o_, n_blocks, tiles, br, d, nvec);
  else
    coded_matvec_kernel<T, NV, false><<<grid, block, 0, stream>>>(
        a_, x_, ids, o_, n_blocks, tiles, br, d, nvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const int32_t* ids, void* out,
                   int64_t n_blocks, int64_t nb, int64_t br, int64_t d, int nvec,
                   bool vec, cudaStream_t stream) {
  if (nvec == 1)
    return launch_nv<T, 1>(a, x, ids, out, n_blocks, nb, br, d, nvec, vec, stream);
  if (nvec <= 4)
    return launch_nv<T, 4>(a, x, ids, out, n_blocks, nb, br, d, nvec, vec, stream);
  return launch_nv<T, 16>(a, x, ids, out, n_blocks, nb, br, d, nvec, vec, stream);
}

}  // namespace

// a: (n_blocks·br, d); x: (d, nvec); ids: (nb,) int32; out: (nb, br, nvec).
// `vec` asks for 16-byte loads: the caller checks d and the alignment.
S2C2_API int s2c2_coded_matvec(const void* a, const void* x, const void* ids, void* out,
                               int64_t n_blocks, int64_t nb, int64_t br, int64_t d,
                               int nvec, int dtype, int vec, void* stream) {
  const auto* ids_ = static_cast<const int32_t*>(ids);
  auto s = static_cast<cudaStream_t>(stream);
  if (nvec < 1 || nvec > 16) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == s2c2::kFloat32)
    return launch<float>(a, x, ids_, out, n_blocks, nb, br, d, nvec, vec != 0, s);
  if (dtype == s2c2::kBFloat16)
    return launch<__nv_bfloat16>(a, x, ids_, out, n_blocks, nb, br, d, nvec, vec != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
