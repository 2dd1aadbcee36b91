// MDS encode: C[w] = Σ_i G[w, i] · A[i] for w < n, over planes of rows·d.
//
// Replaces src/repro/kernels/mds_encode.py::mds_encode_pallas.
//
// Bound on Hopper: device-memory bytes.  The k data planes are read once and
// the n coded planes written once; the 2·n·k flops per element are ~0.6
// flops per byte at (12, 10), far below the card's balance point.
// Design: the generator (n·k ≤ 64·32 floats) sits in shared memory.  Each
// thread takes four consecutive elements of the plane, loads them from all
// k data blocks into registers (k 16-byte loads in flight for float32), and
// writes its four elements of every coded plane, accumulating in float32.
// So every input byte is read once and every output byte written once, with
// no reuse through caches.  A grid-stride loop walks the plane with 64-bit
// offsets; a plane whose size or alignment is ragged takes the scalar path.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 64;
constexpr int kMaxK = 32;

template <typename T, int KMAX, bool VEC>
__global__ void __launch_bounds__(kThreads)
mds_encode_kernel(const float* __restrict__ g, const T* __restrict__ blocks,
                  T* __restrict__ out, int n, int k, int64_t plane) {
  __shared__ float gs[kMaxN * kMaxK];
  for (int t = threadIdx.x; t < n * k; t += blockDim.x) gs[t] = g[t];
  __syncthreads();

  constexpr int E = VEC ? 4 : 1;
  const int64_t n_items = plane / E;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < n_items; p += stride) {
    float v[KMAX][E];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i < k) {
        const T* src = blocks + i * plane + p * E;
        if constexpr (VEC) {
          s2c2::Quad<T>::load(src, v[i]);
        } else {
          v[i][0] = s2c2::to_float(*src);
        }
      }
    }
    for (int w = 0; w < n; ++w) {
      float acc[E];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {
        if (i < k) {
          const float gw = gs[w * k + i];
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] = fmaf(gw, v[i][e], acc[e]);
        }
      }
      T* dst = out + w * plane + p * E;
      if constexpr (VEC) {
        s2c2::Quad<T>::store(dst, acc);
      } else {
        *dst = s2c2::from_float<T>(acc[0]);
      }
    }
  }
}

template <typename T, int KMAX>
cudaError_t launch_k(const float* g, const void* blocks, void* out, int n, int k,
                     int64_t plane, bool vec, int n_sms, cudaStream_t stream) {
  const int64_t items = vec ? plane / 4 : plane;
  int64_t grid = (items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(n_sms) * 8;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  const T* b_ = static_cast<const T*>(blocks);
  T* o_ = static_cast<T*>(out);
  if (vec)
    mds_encode_kernel<T, KMAX, true><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        g, b_, o_, n, k, plane);
  else
    mds_encode_kernel<T, KMAX, false><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
        g, b_, o_, n, k, plane);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const float* g, const void* blocks, void* out, int n, int k,
                   int64_t plane, bool vec, int n_sms, cudaStream_t stream) {
  if (k <= 4) return launch_k<T, 4>(g, blocks, out, n, k, plane, vec, n_sms, stream);
  if (k <= 8) return launch_k<T, 8>(g, blocks, out, n, k, plane, vec, n_sms, stream);
  if (k <= 16) return launch_k<T, 16>(g, blocks, out, n, k, plane, vec, n_sms, stream);
  return launch_k<T, 32>(g, blocks, out, n, k, plane, vec, n_sms, stream);
}

}  // namespace

// g: (n, k) float32; blocks: (k, plane); out: (n, plane), plane = rows·d.
// `vec` asks for four-element loads: the caller checks plane and alignment.
S2C2_API int s2c2_mds_encode(const void* g, const void* blocks, void* out, int64_t n,
                             int64_t k, int64_t plane, int dtype, int vec, int n_sms,
                             void* stream) {
  if (n < 1 || n > kMaxN || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const auto* g_ = static_cast<const float*>(g);
  auto s = static_cast<cudaStream_t>(stream);
  const int n_ = static_cast<int>(n), k_ = static_cast<int>(k);
  if (dtype == s2c2::kFloat32)
    return launch<float>(g_, blocks, out, n_, k_, plane, vec != 0, n_sms, s);
  if (dtype == s2c2::kBFloat16)
    return launch<__nv_bfloat16>(g_, blocks, out, n_, k_, plane, vec != 0, n_sms, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
