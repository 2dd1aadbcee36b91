// Slack-squeeze coded product: out[i] = A[ids[i]·br : (ids[i]+1)·br] @ x.
//
// Replaces src/repro/kernels/coded_matvec.py::coded_matvec_pallas.  Only the
// row-blocks named in `ids` are read, so a worker's cost scales with the
// chunks it was assigned, as in the paper.
//
// Bound on Hopper: device-memory bytes.  At nvec = 1 every element of A that
// is read is used for one multiply-add, far below the card's ~20 flops per
// byte, so the kernel can at best stream the assigned rows at the HBM rate.
// Offsets are 64-bit: the coded tensor's element count exceeds 2^31.  Two
// designs, chosen by shape (kernels/coded_matvec.py):
//
// * The stream (s2c2_coded_matvec_tma), for nvec = 1 with 16-byte rows of at
//   most kMaxRowBytes and a 16-byte-aligned A.  What holds a load-per-warp
//   GEMV below the HBM rate is the bytes in flight: they sag at every row
//   boundary, while the warp reduces, and a grid of short-lived blocks adds a
//   tail.  So the grid is persistent (one block per SM, walking work items
//   (assigned block, tile of R rows) in a strided order), and one producer
//   thread keeps a ring of S shared-memory stages full with one bulk copy
//   (TMA, cp.async.bulk) per tile, each signalled on its stage's "full"
//   mbarrier.  The rows of one assigned block are contiguous, so a tile is
//   one contiguous span.  Eight consumer warps take one row at a time from
//   the ring, against x held once per block in shared memory as float32,
//   reduce with shuffles and hand the tile back on the stage's "empty"
//   mbarrier: the copies in flight never wait for a reduction.  R·S·row
//   bytes fill most of the 227 KB a block may use: a tile is at most
//   kTileBytes = 64 KB, and the ring holds as many as fit (at d = 2,048
//   float32, R = 8 rows and S = 3 stages, 192 KB in flight per SM).  On the
//   H100 a ring of much less than that waits on the latency of its copies,
//   and of the tile sizes from 8 to 64 KB, 64 KB was the fastest.
// * The general path (s2c2_coded_matvec) for every other shape: one warp per
//   row, each lane issuing 16-byte read-only loads along the row (a 512-byte
//   coalesced request per warp instruction), accumulating in float32, and
//   the warp reducing with shuffles.  Each block covers kRowsPerBlock rows
//   of one assigned row-block and reads that block's id itself (the TPU
//   kernel's scalar prefetch).  The contraction dim is walked by a loop
//   inside the warp, which stands in for the TPU's sequential d-tile grid
//   axis and its VMEM accumulator.  A ragged d, or a row start that is not
//   16-byte aligned, takes the scalar loads.
//
// In both, an id outside A yields NaN rows and no read.
#include "common.cuh"

#include <atomic>

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


// -- the stream: persistent, TMA-fed ------------------------------------------

namespace stream {

constexpr int kConsumerWarps = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxTileRows = 64;
constexpr int64_t kTileBytes = 64 * 1024;    // the most one bulk copy moves
constexpr int64_t kMaxRowBytes = 32 * 1024;  // MAX_STREAM_ROW_BYTES in coded_matvec.py
constexpr int64_t kSmemBytes = 232448;       // the most one block may use on Hopper
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int64_t align16(int64_t v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of `bar` with this parity has completed.  A wait
// lasts microseconds; one that outlasts 2^28 tries is a broken protocol, and
// the kernel traps (an error the caller sees) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

// One bulk copy global -> shared; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// This lane's share of one row (in shared memory) times x (float32, shared).
template <typename T> struct RowDot;

template <> struct RowDot<float> {
  __device__ __forceinline__ static float lane_sum(const unsigned char* row, const float* xs,
                                                   int64_t d, int lane) {
    const float4* a = reinterpret_cast<const float4*>(row);
    const float4* x = reinterpret_cast<const float4*>(xs);
    const int n = static_cast<int>(d / 4);
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
    for (int p = lane; p < n; p += 32) {
      const float4 u = a[p], v = x[p];
      acc0 = fmaf(u.x, v.x, acc0);
      acc1 = fmaf(u.y, v.y, acc1);
      acc0 = fmaf(u.z, v.z, acc0);
      acc1 = fmaf(u.w, v.w, acc1);
    }
    return acc0 + acc1;
  }
};

template <> struct RowDot<__nv_bfloat16> {
  __device__ __forceinline__ static float lane_sum(const unsigned char* row, const float* xs,
                                                   int64_t d, int lane) {
    const uint4* a = reinterpret_cast<const uint4*>(row);
    const float4* x = reinterpret_cast<const float4*>(xs);
    const int n = static_cast<int>(d / 8);
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
    for (int p = lane; p < n; p += 32) {
      const uint4 u = a[p];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      const float4 v0 = x[2 * p], v1 = x[2 * p + 1];
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
      acc0 = fmaf(f0.x, v0.x, acc0);
      acc1 = fmaf(f0.y, v0.y, acc1);
      acc0 = fmaf(f1.x, v0.z, acc0);
      acc1 = fmaf(f1.y, v0.w, acc1);
      acc0 = fmaf(f2.x, v1.x, acc0);
      acc1 = fmaf(f2.y, v1.y, acc1);
      acc0 = fmaf(f3.x, v1.z, acc0);
      acc1 = fmaf(f3.y, v1.w, acc1);
    }
    return acc0 + acc1;
  }
};

// Block b walks tiles s = 0, 1, ... of work items b + s·grid; item j is
// assigned block j / tiles_per_block, rows (j % tiles_per_block)·R onwards.
// Tile s lives in stage s % S, and its barriers' phase is s / S.  Every
// consumer warp waits on every tile's "full" barrier in order and arrives on
// its "empty" barrier once (the count is the number of consumer warps), so a
// parity wait never meets a phase two behind, whatever order the copies land
// in.  Within a tile a warp takes the rows of the block's row stream that
// fall to it round-robin (row q = s·R + row goes to warp q mod W), so with
// R < W the warps alternate tiles and still all work.
template <typename T>
__global__ void __launch_bounds__((kConsumerWarps + 1) * 32, 1)
coded_matvec_stream_kernel(const T* __restrict__ a, const T* __restrict__ x,
                           const int32_t* __restrict__ ids, T* __restrict__ out,
                           int64_t n_blocks, int64_t nb, int64_t br, int64_t d,
                           int tile_rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t row_bytes = d * static_cast<int64_t>(sizeof(T));
  const int64_t tile_bytes = tile_rows * row_bytes;
  unsigned char* tiles = smem;
  float* xs = reinterpret_cast<float*>(smem + stages * tile_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * tile_bytes + align16(d * 4));
  uint64_t* empty = full + stages;

  for (int64_t k = threadIdx.x; k < d; k += blockDim.x) xs[k] = s2c2::to_float(x[k]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t tiles_per_block = (br + tile_rows - 1) / tile_rows;
  const int64_t items = nb * tiles_per_block;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int64_t s = 0;

  if (warp == kConsumerWarps) {                  // the producer warp
    if (lane != 0) return;
    for (int64_t item = blockIdx.x; item < items; item += gridDim.x, ++s) {
      const int stage = static_cast<int>(s % stages);
      if (s >= stages) mbar_wait(&empty[stage], static_cast<uint32_t>((s / stages - 1) & 1));
      const int64_t i = item / tiles_per_block;
      const int64_t row0 = (item % tiles_per_block) * tile_rows;
      const int64_t id = ids[i];
      if (id >= 0 && id < n_blocks) {
        const int64_t rows = br - row0 < tile_rows ? br - row0 : tile_rows;
        const uint32_t bytes = static_cast<uint32_t>(rows * row_bytes);
        mbar_arrive_expect_tx(&full[stage], bytes);
        bulk_load(tiles + stage * tile_bytes, a + (id * br + row0) * d, bytes, &full[stage]);
      } else {
        mbar_arrive(&full[stage]);               // nothing to copy: the rows become NaN
      }
    }
    return;
  }

  for (int64_t item = blockIdx.x; item < items; item += gridDim.x, ++s) {  // consumers
    const int stage = static_cast<int>(s % stages);
    const int64_t i = item / tiles_per_block;
    const int64_t row0 = (item % tiles_per_block) * tile_rows;
    const int64_t id = ids[i];
    const bool valid = id >= 0 && id < n_blocks;
    const unsigned char* tile = tiles + stage * tile_bytes;
    mbar_wait(&full[stage], static_cast<uint32_t>((s / stages) & 1));
    const int first = static_cast<int>(
        (warp + kConsumerWarps - (s * tile_rows) % kConsumerWarps) % kConsumerWarps);
    for (int row = first; row < tile_rows && row0 + row < br; row += kConsumerWarps) {
      float acc = CUDART_NAN_F;
      if (valid) acc = s2c2::warp_sum(RowDot<T>::lane_sum(tile + row * row_bytes, xs, d, lane));
      if (lane == 0) out[i * br + row0 + row] = s2c2::from_float<T>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const int32_t* ids, void* out,
                   int64_t n_blocks, int64_t nb, int64_t br, int64_t d, cudaStream_t stream) {
  const int64_t row_bytes = d * static_cast<int64_t>(sizeof(T));
  if (d < 1 || br < 1 || nb < 1 || row_bytes % 16 || row_bytes > kMaxRowBytes ||
      reinterpret_cast<uintptr_t>(a) % 16)
    return cudaErrorInvalidValue;
  // A tile is as many whole rows as fit in kTileBytes, at most kMaxTileRows;
  // the ring, as many tiles as fit beside x, at most kMaxStages.  Rows of at
  // most kMaxRowBytes make tiles of 2 rows or more, and 3 stages or more.
  int64_t tile_rows = kTileBytes / row_bytes;
  if (tile_rows > kMaxTileRows) tile_rows = kMaxTileRows;
  const int64_t fixed = align16(d * 4) + 2 * kMaxStages * 8;
  int64_t stages = (kSmemBytes - fixed) / (tile_rows * row_bytes);
  if (stages > kMaxStages) stages = kMaxStages;
  const size_t smem = static_cast<size_t>(stages * tile_rows * row_bytes + align16(d * 4) +
                                          2 * stages * 8);
  // The SM count and the dynamic shared memory limit are looked up and set
  // once per device: on every launch they cost more host time than the
  // launch itself.
  static std::atomic<int> sms_of[kMaxDevices];   // 0 until the device is set up
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int sms = sms_of[dev].load(std::memory_order_acquire);
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(coded_matvec_stream_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    sms_of[dev].store(sms, std::memory_order_release);
  }
  const int64_t items = nb * ((br + tile_rows - 1) / tile_rows);
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  coded_matvec_stream_kernel<T><<<grid, (kConsumerWarps + 1) * 32, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), ids, static_cast<T*>(out),
      n_blocks, nb, br, d, static_cast<int>(tile_rows), static_cast<int>(stages));
  return cudaGetLastError();
}

}  // namespace stream

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

// The stream design: nvec = 1, rows of a multiple of 16 bytes and at most
// 32 KB, a 16-byte-aligned A (the caller checks; anything else is refused).
// a: (n_blocks·br, d); x: (d,); ids: (nb,) int32; out: (nb, br); nb >= 1.
S2C2_API int s2c2_coded_matvec_stream(const void* a, const void* x, const void* ids,
                                      void* out, int64_t n_blocks, int64_t nb, int64_t br,
                                      int64_t d, int dtype, void* stream) {
  const auto* ids_ = static_cast<const int32_t*>(ids);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == s2c2::kFloat32)
    return stream::launch<float>(a, x, ids_, out, n_blocks, nb, br, d, s);
  if (dtype == s2c2::kBFloat16)
    return stream::launch<__nv_bfloat16>(a, x, ids_, out, n_blocks, nb, br, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
