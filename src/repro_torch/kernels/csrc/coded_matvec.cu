// Slack-squeeze coded product: out[i] = A[ids[i]·br : (ids[i]+1)·br] @ x.
//
// Replaces src/repro/kernels/coded_matvec.py::coded_matvec_pallas.  Only the
// row-blocks named in `ids` are read, so a worker's cost scales with the
// chunks it was assigned, as in the paper.
//
// Bound on Hopper: device-memory bytes.  Every element of A that is read is
// used for nvec <= 16 multiply-adds: at most 8 flops a byte of float32, under
// the card's 20 (67 TFLOP/s of float32 FMA over 3.35 TB/s), so the kernel can
// at best stream the assigned rows at the HBM rate.  Offsets are 64-bit: the
// coded tensor's element count exceeds 2^31.  Four designs, chosen by shape
// (kernels/coded_matvec.py, design_of):
//
// * The stream (s2c2_coded_matvec_stream), for nvec = 1 with 16-byte rows of
//   at most kMaxRowBytes and a 16-byte-aligned A.  What holds a load-per-warp
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
// * The split-row stream (s2c2_coded_matvec_split), for nvec = 1 with
//   16-byte rows over kMaxRowBytes and a 16-byte-aligned A: PageRank's and
//   the graph filter's rows of 128 and 64 KB, where one row and x as float32
//   together fill the block's shared memory and leave no room for a ring.
//   The general design streamed them at 82-94 % of the bound: a grid of
//   64-row blocks whose ragged last tiles leave the busiest SM ~30 % more
//   rows than the mean, bytes in flight that sag at each row's end, and x
//   read again from L2 for every row.  Here the grid is persistent, one
//   block per SM, and block b owns the flat rows (assigned block i, row r)
//   from b·nb·br/grid to (b+1)·nb·br/grid, so the blocks' shares differ by
//   one row at most; a share may cross from one assigned block into the
//   next.  d is cut into as few slices of equal width as keep a row's share
//   of one, its segment, within kSliceBytes; a tile is one segment, moved by
//   one bulk copy that completes on the stage's "full" mbarrier, and one
//   producer thread keeps the ring full under the stream's barrier
//   protocol.  It walks the rows with a cursor that reads an id only where
//   the assigned block changes, and leaves the consumers a flag, whether
//   the row lies inside A: with a lookup per row (a dependent load and a
//   64-bit division) the producer could not issue copies of 4-8 KB fast
//   enough, and the design ran at 31-68 % of its bound.  The block walks
//   slices outer and its rows inner, so only the slice of x in use sits in
//   shared memory (in T, widened as it is read, like A), read from device
//   memory once per block per slice and double-buffered on barriers of its
//   own, so that the next slice of x is copied while the last is read.  A
//   row's sums over the slices stay in shared memory and are added in slice
//   order by the one lane that owns the row in every slice; the row is
//   written once, after its last slice: fixed order, no atomics, the same
//   bits on every run.  A share of more than kPassRows rows is walked in
//   passes.  kSliceBytes = 32 KB gives five stages, 160 KB in flight; on
//   the H100 (scripts/split_sweep.py, which builds other widths with -D)
//   16 KB slices ran 1.0-1.4 % slower at PageRank's and the filter's
//   shapes and 8 KB slices 19-20 % slower.  Tiles of 2-16 rows' segments
//   tied with one within noise at 16-32 KB segments and were dropped.  It
//   runs there at 91-96 % of the bound, at or above the stream's rate over
//   the same bytes in whole rows of 32 KB, where the general design ran at
//   81-93 %.  At the stream's own shapes it trails the stream (18.5 % at
//   8 KB rows, whose 8 stages hold 64 KB; 1.75 % at 20 KB rows), so the
//   stream keeps rows of at most kMaxRowBytes.
// * The multi design (s2c2_coded_matvec_multi), for 2 <= nvec <= 16: the
//   cluster's chunks of a B-column product.  Each element of A feeds nvec
//   multiply-adds, so x must cost no more than A's bytes.  It is read from
//   device memory once per block, kStage 16-byte loads in flight per thread
//   (one at a time, each would wait out the latency of L2), widened to
//   float32 and kept column-major in shared memory, NV columns of ld floats
//   (NV in {2, 4, 8, 16}, the columns past nvec zero, so no width needs a
//   test in the inner loop): a lane's float4 of column q and its neighbours'
//   are consecutive 16-byte words, where a row-major [d][NV] would put a
//   warp's lanes on one bank at NV = 8; ld = 4 (mod 32) keeps the
//   transposing store free of conflicts too.  A warp computes R = kRows = 2
//   rows at once, R·NV float32 sums in registers, so each float4 of x read
//   from shared memory feeds both rows (at NV = 16 a 16-byte load of A needs
//   16 float4s of x).  The grid is persistent, one block of kWarps = 12 warps
//   per SM, where 64-row blocks filled 47 of the 132 SMs: a chunk of 3,000
//   rows at nb = 1 is 1,500 items of two rows, 11 or 12 per SM, so nearly
//   every warp has one and the others hide its latency.  (On the H100,
//   4-row items on 8 warps, which leave 2-3 of them idle per SM, were slower
//   at B = 8 and 16; 16 warps cap a thread at 128 registers, and spilled.)
//   Item j goes to block j mod grid and there to one warp, so the
//   SMs' counts of items differ by one at most.  A warp reads its rows whole,
//   16 bytes a lane, loading the next packets of both rows while it
//   multiplies the last ones, and its first packets are on their way while
//   x is staged; after that no warp waits on another.  At the end of an item
//   the warp sums its R·NV partials across lanes by halving: at each of the
//   5 steps a lane keeps one half of the values it holds and sends the other
//   half to its partner, about R·NV shuffles in all where one reduction per
//   value takes 5·R·NV.  Every sum has a fixed order and there are no
//   atomics: a chunk gives the same bits on every run.  Where NV columns of
//   all of d do not fit in a block's 227 KB, d is cut into slices that do,
//   and the block stages them in turn, between barriers, for every round of
//   its items.
// * The general path (s2c2_coded_matvec) for the nvec = 1 shapes that the
//   two streams refuse (rows not a multiple of 16 bytes, an unaligned A):
//   one warp per row, each lane issuing 16-byte read-only loads along the
//   row (a 512-byte coalesced request per warp instruction), accumulating in
//   float32, and the warp reducing with shuffles.  Each block
//   covers kRowsPerBlock rows of one assigned row-block and reads that
//   block's id itself (the TPU kernel's scalar prefetch).  The contraction
//   dim is walked by a loop inside the warp, which stands in for the TPU's
//   sequential d-tile grid axis and its VMEM accumulator.
//
// In the multi and general designs a ragged d, or an A that is not 16-byte
// aligned, takes scalar loads.  In all four an id outside A yields NaN rows
// and no read.
#include "common.cuh"

#include <atomic>

#include <math_constants.h>

namespace {

constexpr int64_t kSmemBytes = 232448;       // the most one block may use on Hopper
constexpr int kMaxDevices = 64;

// The SM count of the current device, and `kernel`'s dynamic shared memory
// limit raised to kSmemBytes: looked up and set once per device, since on
// every launch they would cost more host time than the launch itself.
// `sms_of` is the kernel's own cache, 0 until the device is set up.
template <typename Kernel>
cudaError_t persistent_setup(Kernel kernel, std::atomic<int> (&sms_of)[kMaxDevices], int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *sms = sms_of[dev].load(std::memory_order_acquire);
  if (*sms == 0) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    sms_of[dev].store(*sms, std::memory_order_release);
  }
  return cudaSuccess;
}

// -- the general path: one warp per row, nvec = 1 ----------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
coded_matvec_kernel(const T* __restrict__ a, const T* __restrict__ x,
                    const int32_t* __restrict__ ids, T* __restrict__ out,
                    int64_t n_blocks, int64_t tiles_per_block, int64_t br, int64_t d) {
  const int64_t i = blockIdx.x / tiles_per_block;  // which assigned block
  const int64_t row0 = (blockIdx.x % tiles_per_block) * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t id = ids[i];
  const bool valid = id >= 0 && id < n_blocks;

  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int64_t r = row0 + rr * kWarps + warp;
    if (r >= br) break;
    float acc = 0.f;
    if (valid) {
      const T* arow = a + (id * br + r) * d;
      if constexpr (VEC) {
        using P = s2c2::Packet16<T>;
        const int64_t n_packets = d / P::N;
#pragma unroll 4
        for (int64_t p = lane; p < n_packets; p += 32) {
          float av[P::N], xv[P::N];
          P::load(arow + p * P::N, av);
          P::load(x + p * P::N, xv);
#pragma unroll
          for (int e = 0; e < P::N; ++e) acc = fmaf(av[e], xv[e], acc);
        }
      } else {
        for (int64_t k = lane; k < d; k += 32)
          acc = fmaf(s2c2::to_float(arow[k]), s2c2::to_float(x[k]), acc);
      }
    }
    acc = s2c2::warp_sum(acc);
    // an id outside A yields NaN rows instead of an out-of-bounds read
    if (lane == 0) out[i * br + r] = s2c2::from_float<T>(valid ? acc : CUDART_NAN_F);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const int32_t* ids, void* out,
                   int64_t n_blocks, int64_t nb, int64_t br, int64_t d, bool vec,
                   cudaStream_t stream) {
  const int64_t tiles = (br + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 grid(static_cast<unsigned>(nb * tiles));
  const dim3 block(kWarps * 32);
  const T* a_ = static_cast<const T*>(a);
  const T* x_ = static_cast<const T*>(x);
  T* o_ = static_cast<T*>(out);
  if (vec)
    coded_matvec_kernel<T, true><<<grid, block, 0, stream>>>(a_, x_, ids, o_, n_blocks, tiles,
                                                             br, d);
  else
    coded_matvec_kernel<T, false><<<grid, block, 0, stream>>>(a_, x_, ids, o_, n_blocks, tiles,
                                                              br, d);
  return cudaGetLastError();
}


// -- the stream: persistent, TMA-fed ------------------------------------------

namespace stream {

constexpr int kConsumerWarps = 8;
constexpr int kMaxStages = 8;
constexpr int kMaxTileRows = 64;
constexpr int64_t kTileBytes = 64 * 1024;    // the most one bulk copy moves
constexpr int64_t kMaxRowBytes = 32 * 1024;  // MAX_STREAM_ROW_BYTES in coded_matvec.py

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
  static std::atomic<int> sms_of[kMaxDevices];
  int sms = 0;
  const cudaError_t err = persistent_setup(coded_matvec_stream_kernel<T>, sms_of, &sms);
  if (err != cudaSuccess) return err;
  const int64_t items = nb * ((br + tile_rows - 1) / tile_rows);
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  coded_matvec_stream_kernel<T><<<grid, (kConsumerWarps + 1) * 32, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), ids, static_cast<T*>(out),
      n_blocks, nb, br, d, static_cast<int>(tile_rows), static_cast<int>(stages));
  return cudaGetLastError();
}

}  // namespace stream


// -- the split-row stream: persistent, TMA-fed, rows over 32 KB ---------------

namespace split {

constexpr int kConsumerWarps = 8;
constexpr int kMaxStages = 8;
constexpr int kPassRows = 512;              // the partial sums one pass keeps in shared memory
#ifndef S2C2_SPLIT_SLICE_BYTES
#define S2C2_SPLIT_SLICE_BYTES (32 * 1024)
#endif
// the widest segment, one row's share of a slice; a tile is one segment
constexpr int64_t kSliceBytes = S2C2_SPLIT_SLICE_BYTES;
static_assert(kSliceBytes >= 16 && kSliceBytes % 16 == 0, "a segment is whole 16-byte packets");
static_assert(4 * kSliceBytes + kPassRows * 4 + (2 * kMaxStages + 4) * 8 + kMaxStages * 4 <=
                  kSmemBytes,
              "the ring holds two segments beside two slices of x");

// This lane's share of one segment of a row times the same slice of x, both
// in shared memory in T: n16 packets of 16 bytes.
template <typename T> struct SegDot;

template <> struct SegDot<float> {
  __device__ __forceinline__ static float lane_sum(const unsigned char* seg,
                                                   const unsigned char* xs, int n16, int lane) {
    return stream::RowDot<float>::lane_sum(seg, reinterpret_cast<const float*>(xs), 4 * n16,
                                           lane);
  }
};

template <> struct SegDot<__nv_bfloat16> {
  __device__ __forceinline__ static float lane_sum(const unsigned char* seg,
                                                   const unsigned char* xs, int n16, int lane) {
    const uint4* a = reinterpret_cast<const uint4*>(seg);
    const uint4* x = reinterpret_cast<const uint4*>(xs);
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
    for (int p = lane; p < n16; p += 32) {
      const uint4 u = a[p], v = x[p];
      const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&u);
      const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fa = __bfloat1622float2(ha[j]), fx = __bfloat1622float2(hx[j]);
        acc0 = fmaf(fa.x, fx.x, acc0);
        acc1 = fmaf(fa.y, fx.y, acc1);
      }
    }
    return acc0 + acc1;
  }
};

// Flat row f is row r = f % br of assigned block i = f / br; the cursor
// walks the flat rows in order and reads an id only where i changes (a
// lookup per row, a dependent load and a 64-bit division, held the producer
// below the rate of copies of 4-8 KB).
struct RowCursor {
  int64_t i, r, id;                              // id: -1 outside A (or past nb)

  __device__ __forceinline__ void load(const int32_t* __restrict__ ids, int64_t nb,
                                       int64_t n_blocks) {
    const int64_t v = i < nb ? ids[i] : -1;
    id = v >= 0 && v < n_blocks ? v : -1;
  }
  __device__ __forceinline__ void seek(const int32_t* __restrict__ ids, int64_t f, int64_t nb,
                                       int64_t br, int64_t n_blocks) {
    i = f / br;
    r = f - i * br;
    load(ids, nb, n_blocks);
  }
  __device__ __forceinline__ void next(const int32_t* __restrict__ ids, int64_t nb, int64_t br,
                                       int64_t n_blocks) {
    if (++r == br) {
      r = 0;
      ++i;
      load(ids, nb, n_blocks);
    }
  }
};

// Block b owns flat rows [b·nb·br / grid, (b + 1)·nb·br / grid).  It walks
// them in passes of at most kPassRows rows; each pass walks the slices of d
// in order, and each slice the pass's rows, one segment a tile.  Tile t
// (counted over the whole walk) lives in stage t % S with phase t / S, as in
// the stream; beside it the producer leaves a flag, whether the row's id is
// inside A, published by its arrival on the stage's "full" barrier, so the
// consumers read no id.  Slice u of the walk (counted over the passes) is
// copied into x buffer u % 2, with its own full and empty barriers at phase
// u / 2: the producer copies slice u + 1 of x while the consumers still read
// slice u, and waits only for slice u - 1's readers.  A row goes to consumer
// warp (row - pass start) mod W in every slice, so the same lane adds its
// slices' sums in slice order, and the row is written once, after its last.
template <typename T>
__global__ void __launch_bounds__((kConsumerWarps + 1) * 32, 1)
coded_matvec_split_kernel(const T* __restrict__ a, const T* __restrict__ x,
                          const int32_t* __restrict__ ids, T* __restrict__ out,
                          int64_t n_blocks, int64_t nb, int64_t br, int64_t d, int64_t slice,
                          int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t seg_bytes = slice * static_cast<int64_t>(sizeof(T));
  unsigned char* ring = smem;
  unsigned char* xbuf = smem + stages * seg_bytes;
  float* part = reinterpret_cast<float*>(xbuf + 2 * seg_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(part + kPassRows);
  uint64_t* empty = full + stages;
  uint64_t* xfull = empty + stages;
  uint64_t* xempty = xfull + 2;
  int* inside = reinterpret_cast<int*>(xempty + 2);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      stream::mbar_init(&full[s], 1);
      stream::mbar_init(&empty[s], kConsumerWarps);
    }
    for (int b = 0; b < 2; ++b) {
      stream::mbar_init(&xfull[b], 1);
      stream::mbar_init(&xempty[b], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int64_t total = nb * br;
  const int64_t r0 = blockIdx.x * total / gridDim.x;
  const int64_t r1 = (blockIdx.x + 1) * total / gridDim.x;
  const int64_t slices = (d + slice - 1) / slice;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int64_t t = 0, u = 0;

  if (warp == kConsumerWarps) {                  // the producer warp
    if (lane != 0) return;
    for (int64_t p0 = r0; p0 < r1; p0 += kPassRows) {
      const int64_t p1 = r1 - p0 < kPassRows ? r1 : p0 + kPassRows;
      for (int64_t s = 0; s < slices; ++s, ++u) {
        const int64_t k0 = s * slice;
        const uint32_t bytes = static_cast<uint32_t>((d - k0 < slice ? d - k0 : slice) *
                                                     static_cast<int64_t>(sizeof(T)));
        const int xb = static_cast<int>(u & 1);
        if (u >= 2) stream::mbar_wait(&xempty[xb], static_cast<uint32_t>((u / 2 - 1) & 1));
        stream::mbar_arrive_expect_tx(&xfull[xb], bytes);
        stream::bulk_load(xbuf + xb * seg_bytes, x + k0, bytes, &xfull[xb]);
        RowCursor cur;
        cur.seek(ids, p0, nb, br, n_blocks);
        for (int64_t f = p0; f < p1; ++f, ++t, cur.next(ids, nb, br, n_blocks)) {
          const int stage = static_cast<int>(t % stages);
          if (t >= stages)
            stream::mbar_wait(&empty[stage], static_cast<uint32_t>((t / stages - 1) & 1));
          inside[stage] = cur.id >= 0;
          if (cur.id < 0) {
            stream::mbar_arrive(&full[stage]);   // nothing to copy: the row becomes NaN
            continue;
          }
          stream::mbar_arrive_expect_tx(&full[stage], bytes);
          stream::bulk_load(ring + stage * seg_bytes, a + (cur.id * br + cur.r) * d + k0, bytes,
                            &full[stage]);
        }
      }
    }
    return;
  }

  for (int64_t p0 = r0; p0 < r1; p0 += kPassRows) {                     // consumers
    const int64_t p1 = r1 - p0 < kPassRows ? r1 : p0 + kPassRows;
    for (int64_t s = 0; s < slices; ++s, ++u) {
      const int64_t k0 = s * slice;
      const int n16 = static_cast<int>((d - k0 < slice ? d - k0 : slice) *
                                       static_cast<int64_t>(sizeof(T)) / 16);
      const int xb = static_cast<int>(u & 1);
      const unsigned char* xs = xbuf + xb * seg_bytes;
      stream::mbar_wait(&xfull[xb], static_cast<uint32_t>((u / 2) & 1));
      for (int64_t f = p0; f < p1; ++f, ++t) {
        const int stage = static_cast<int>(t % stages);
        stream::mbar_wait(&full[stage], static_cast<uint32_t>((t / stages) & 1));
        const int j = static_cast<int>(f - p0);
        if (j % kConsumerWarps == warp) {
          float sum = CUDART_NAN_F;
          if (inside[stage])
            sum = s2c2::warp_sum(SegDot<T>::lane_sum(ring + stage * seg_bytes, xs, n16, lane));
          if (lane == 0) {
            if (s > 0) sum = part[j] + sum;      // the slices' sums, in slice order
            if (s + 1 < slices)
              part[j] = sum;
            else
              out[f] = s2c2::from_float<T>(sum);
          }
        }
        __syncwarp();
        if (lane == 0) stream::mbar_arrive(&empty[stage]);
      }
      __syncwarp();
      if (lane == 0) stream::mbar_arrive(&xempty[xb]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const int32_t* ids, void* out,
                   int64_t n_blocks, int64_t nb, int64_t br, int64_t d, cudaStream_t stream) {
  const int64_t row_bytes = d * static_cast<int64_t>(sizeof(T));
  if (d < 1 || br < 1 || nb < 1 || row_bytes % 16 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return cudaErrorInvalidValue;
  // d is cut into as few slices of equal width (a whole number of 16-byte
  // packets) as keep each within kSliceBytes, so that no narrow last slice
  // costs a walk of its own; the ring holds as many segments as fit beside
  // two slices of x, the pass's partial sums, the flags and the barriers, at
  // most kMaxStages (at least 2: the static_assert above).
  const int64_t packet = 16 / static_cast<int64_t>(sizeof(T));
  const int64_t n_slices = (row_bytes + kSliceBytes - 1) / kSliceBytes;
  const int64_t slice = ((d + n_slices - 1) / n_slices + packet - 1) / packet * packet;
  const int64_t seg_bytes = slice * static_cast<int64_t>(sizeof(T));
  const int64_t fixed = 2 * seg_bytes + kPassRows * 4 + (2 * kMaxStages + 4) * 8 + kMaxStages * 4;
  int64_t stages = (kSmemBytes - fixed) / seg_bytes;
  if (stages > kMaxStages) stages = kMaxStages;
  const size_t smem = static_cast<size_t>(stages * seg_bytes + 2 * seg_bytes + kPassRows * 4 +
                                          (2 * stages + 4) * 8 + stages * 4);
  static std::atomic<int> sms_of[kMaxDevices];
  int sms = 0;
  const cudaError_t err = persistent_setup(coded_matvec_split_kernel<T>, sms_of, &sms);
  if (err != cudaSuccess) return err;
  const int64_t total = nb * br;
  const unsigned grid = static_cast<unsigned>(total < sms ? total : sms);
  coded_matvec_split_kernel<T><<<grid, (kConsumerWarps + 1) * 32, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), ids, static_cast<T*>(out), n_blocks,
      nb, br, d, slice, static_cast<int>(stages));
  return cudaGetLastError();
}

}  // namespace split


// -- the multi design: 2 <= nvec <= 16, x in shared memory ---------------------

namespace multi {

constexpr int kWarps = 12;
constexpr int kRows = 2;       // R: the rows a warp computes at once
constexpr int kStage = 8;      // loads of x a thread has in flight while staging

// floats a staged column of `cols` values takes: a multiple of 4 (16-byte
// columns) that is 4 past a multiple of 32 (a conflict-free transpose)
__host__ __device__ constexpr int64_t ld_of(int64_t cols) { return (cols + 31) / 32 * 32 + 4; }

// One 16-byte packet of A, widened to float: 4 float32 or 8 bfloat16 values.
template <typename T> struct Widen;

template <> struct Widen<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void run(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <> struct Widen<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void run(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

// Sum each of the V values in v over the warp's lanes by halving.  While a
// lane holds N > 1 values, the step at lane offset O keeps the half that the
// lane's bit O names and adds the partner's copy of it, which the partner
// sends in exchange for the other half; once N = 1 the steps left add the
// partner's value.  At the end the lane holds the sums of values first ..
// first + max(1, V/32) - 1 in v[0 ..], and lanes that differ only in the
// bits below 32/V hold the same sums.
template <int V, int N, int O>
__device__ __forceinline__ void halving_sum(float (&v)[V], int lane, int& first) {
  if constexpr (O > 0) {
    if constexpr (N > 1) {
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        const float send = upper ? v[j] : v[j + N / 2];
        const float keep = upper ? v[j + N / 2] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (upper) first += N / 2;
      halving_sum<V, N / 2, O / 2>(v, lane, first);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      halving_sum<V, 1, O / 2>(v, lane, first);
    }
  }
}

// Packets p, p + 32, ..., p + 32·(U - 1) of each row, zeros past p_end.
template <typename T, int U, int R>
__device__ __forceinline__ void load_batch(const T* const (&rows)[R], int64_t p, int64_t p_end,
                                           uint4 (&raw)[U][R]) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int r = 0; r < R; ++r)
      raw[u][r] = p + 32 * u < p_end
                      ? __ldg(reinterpret_cast<const uint4*>(rows[r]) + p + 32 * u)
                      : make_uint4(0u, 0u, 0u, 0u);
}

// xs[q·ld + k] = x[k·nvec + q] for the n = cols·nvec values of x, widened to
// float.  Each thread has kStage loads in flight, of 16 bytes where x is
// aligned to them, since one at a time the loads would each wait out the
// latency of L2.
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, float* xs, int n, int nvec,
                                        int ld) {
  constexpr int P = Widen<T>::N;
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && n % P == 0) {
    const int loads = n / P;
    for (int l0 = threadIdx.x; l0 < loads; l0 += kStage * blockDim.x) {
      uint4 raw[kStage];
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int l = l0 + j * blockDim.x;
        if (l < loads) raw[j] = __ldg(reinterpret_cast<const uint4*>(x) + l);
      }
#pragma unroll
      for (int j = 0; j < kStage; ++j) {
        const int l = l0 + j * blockDim.x;
        if (l < loads) {
          float v[P];
          Widen<T>::run(raw[j], v);
#pragma unroll
          for (int t = 0; t < P; ++t) {
            const int e = l * P + t, k = e / nvec;
            xs[(e - k * nvec) * ld + k] = v[t];
          }
        }
      }
    }
    return;
  }
  for (int e0 = threadIdx.x; e0 < n; e0 += kStage * blockDim.x) {
    float v[kStage];
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int e = e0 + j * blockDim.x;
      if (e < n) v[j] = s2c2::to_float(x[e]);
    }
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int e = e0 + j * blockDim.x;
      if (e < n) {
        const int k = e / nvec;
        xs[(e - k * nvec) * ld + k] = v[j];
      }
    }
  }
}

// Block b takes items b, b + grid, b + 2·grid, ...: its k-th goes to warp
// k mod kWarps in round k / kWarps.  Item j is assigned block j / tiles, rows
// (j % tiles)·R onwards.  x's slice s (all of d when it fits) is staged at
// the start of each round, or once when there is one slice.
template <typename T, int NV>
__global__ void __launch_bounds__(kWarps * 32, 1)
coded_matvec_multi_kernel(const T* __restrict__ a, const T* __restrict__ x,
                          const int32_t* __restrict__ ids, T* __restrict__ out,
                          int64_t n_blocks, int64_t nb, int64_t br, int64_t d, int nvec,
                          int64_t slice, int ld, bool vec) {
  extern __shared__ __align__(16) float xs[];     // NV columns of ld floats
  constexpr int P = Widen<T>::N;
  constexpr int V = kRows * NV;
  // packets of each row a lane loads at once: two, unless the sums and the
  // widened values would then leave too few registers
  constexpr int U = V * P < 128 ? 2 : 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t tiles = (br + kRows - 1) / kRows;
  const int64_t items = nb * tiles;
  const int64_t mine = (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int64_t rounds = (mine + kWarps - 1) / kWarps;
  const int64_t slices = (d + slice - 1) / slice;

  for (int e = threadIdx.x; e < (NV - nvec) * ld; e += blockDim.x) xs[nvec * ld + e] = 0.f;

  for (int64_t round = 0; round < rounds; ++round) {
    const int64_t k = round * kWarps + warp;
    const bool has = k < mine;                    // the same in every lane
    const int64_t item = blockIdx.x + k * gridDim.x;
    const int64_t i = has ? item / tiles : 0;
    const int64_t row0 = has ? item % tiles * kRows : 0;
    const int64_t id = has ? ids[i] : -1;
    const bool valid = id >= 0 && id < n_blocks;
    // a ragged last tile reads its last row again and stores it once
    const T* rows[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      rows[r] = a + ((valid ? id : 0) * br + (row0 + r < br ? row0 + r : br - 1)) * d;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;

    for (int64_t s = 0; s < slices; ++s) {
      const int64_t k0 = s * slice;
      const int kn = static_cast<int>(d - k0 < slice ? d - k0 : slice);
      const int64_t p_end = (k0 + kn) / P;
      // the first packets of A are on their way while x is staged
      uint4 raw[U][kRows];
      if (valid && vec) load_batch(rows, k0 / P + lane, p_end, raw);
      if (slices > 1 || round == 0) {
        __syncthreads();                          // no warp still reads the slice before
        stage_x(x + k0 * nvec, xs, kn * nvec, nvec, ld);
        __syncthreads();
      }
      if (!valid) continue;
      if (vec) {
        // software-pipelined: the next batch of packets is loaded while
        // this one is used, so the warp's loads never wait on its FMAs
        for (int64_t p = k0 / P + lane; p < p_end; p += 32 * U) {
          uint4 next[U][kRows];
          load_batch(rows, p + 32 * U, p_end, next);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (p + 32 * u >= p_end) break;
            float av[kRows][P];
#pragma unroll
            for (int r = 0; r < kRows; ++r) Widen<T>::run(raw[u][r], av[r]);
            const float* xk = xs + ((p + 32 * u) * P - k0);
#pragma unroll
            for (int q = 0; q < NV; ++q) {
              float xv[P];
#pragma unroll
              for (int j = 0; j < P / 4; ++j) {
                const float4 t = reinterpret_cast<const float4*>(xk + q * ld)[j];
                xv[4 * j] = t.x;
                xv[4 * j + 1] = t.y;
                xv[4 * j + 2] = t.z;
                xv[4 * j + 3] = t.w;
              }
              // rows innermost: consecutive FMAs add into different sums
#pragma unroll
              for (int e = 0; e < P; ++e)
#pragma unroll
                for (int r = 0; r < kRows; ++r)
                  acc[r * NV + q] = fmaf(av[r][e], xv[e], acc[r * NV + q]);
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int r = 0; r < kRows; ++r) raw[u][r] = next[u][r];
        }
      } else {
        for (int kk = lane; kk < kn; kk += 32) {
          float av[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) av[r] = s2c2::to_float(rows[r][k0 + kk]);
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            const float xv = xs[q * ld + kk];
#pragma unroll
            for (int r = 0; r < kRows; ++r) acc[r * NV + q] = fmaf(av[r], xv, acc[r * NV + q]);
          }
        }
      }
    }

    if (!has) continue;
    int first = 0;
    halving_sum<V, V, 16>(acc, lane, first);
    constexpr int kHeld = V >= 32 ? V / 32 : 1;
    constexpr int kCopies = V >= 32 ? 1 : 32 / V;
    if (lane % kCopies == 0) {
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        const int v = first + h, r = v / NV, q = v % NV;
        if (q < nvec && row0 + r < br)
          out[(i * br + row0 + r) * nvec + q] =
              s2c2::from_float<T>(valid ? acc[h] : CUDART_NAN_F);
      }
    }
  }
}

template <typename T, int NV>
cudaError_t launch_nv(const void* a, const void* x, const int32_t* ids, void* out,
                   int64_t n_blocks, int64_t nb, int64_t br, int64_t d, int nvec,
                   cudaStream_t stream) {
  if (d < 1 || br < 1 || nb < 1 || nvec < 2 || nvec > NV) return cudaErrorInvalidValue;
  // x's NV columns over all of d when they fit, else over the widest
  // multiple of 32 columns that does (a multiple of a packet, too)
  const int64_t max_ld = kSmemBytes / (NV * 4);
  const int64_t slice = ld_of(d) <= max_ld ? d : (max_ld - 4) / 32 * 32;
  const int ld = static_cast<int>(ld_of(slice));
  const bool vec = d % Widen<T>::N == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  static std::atomic<int> sms_of[kMaxDevices];
  int sms = 0;
  const cudaError_t err = persistent_setup(coded_matvec_multi_kernel<T, NV>, sms_of, &sms);
  if (err != cudaSuccess) return err;
  const int64_t items = nb * ((br + kRows - 1) / kRows);
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  coded_matvec_multi_kernel<T, NV><<<grid, kWarps * 32, static_cast<size_t>(NV) * ld * 4,
                                     stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), ids, static_cast<T*>(out), n_blocks,
      nb, br, d, nvec, slice, ld, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* a, const void* x, const int32_t* ids, void* out,
                   int64_t n_blocks, int64_t nb, int64_t br, int64_t d, int nvec,
                   cudaStream_t stream) {
  if (nvec <= 2) return launch_nv<T, 2>(a, x, ids, out, n_blocks, nb, br, d, nvec, stream);
  if (nvec <= 4) return launch_nv<T, 4>(a, x, ids, out, n_blocks, nb, br, d, nvec, stream);
  if (nvec <= 8) return launch_nv<T, 8>(a, x, ids, out, n_blocks, nb, br, d, nvec, stream);
  return launch_nv<T, 16>(a, x, ids, out, n_blocks, nb, br, d, nvec, stream);
}

}  // namespace multi

}  // namespace

// The general path: nvec = 1, any shape.
// a: (n_blocks·br, d); x: (d,); ids: (nb,) int32; out: (nb, br).
// `vec` asks for 16-byte loads: the caller checks d and the alignment.
S2C2_API int s2c2_coded_matvec(const void* a, const void* x, const void* ids, void* out,
                               int64_t n_blocks, int64_t nb, int64_t br, int64_t d,
                               int dtype, int vec, void* stream) {
  const auto* ids_ = static_cast<const int32_t*>(ids);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == s2c2::kFloat32)
    return launch<float>(a, x, ids_, out, n_blocks, nb, br, d, vec != 0, s);
  if (dtype == s2c2::kBFloat16)
    return launch<__nv_bfloat16>(a, x, ids_, out, n_blocks, nb, br, d, vec != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The multi design: 2 <= nvec <= 16, any d, any alignment; nb >= 1.
// a: (n_blocks·br, d); x: (d, nvec), row-major; ids: (nb,) int32;
// out: (nb, br, nvec).
S2C2_API int s2c2_coded_matvec_multi(const void* a, const void* x, const void* ids, void* out,
                                     int64_t n_blocks, int64_t nb, int64_t br, int64_t d,
                                     int nvec, int dtype, void* stream) {
  const auto* ids_ = static_cast<const int32_t*>(ids);
  auto s = static_cast<cudaStream_t>(stream);
  if (nvec < 2 || nvec > 16) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == s2c2::kFloat32)
    return multi::launch<float>(a, x, ids_, out, n_blocks, nb, br, d, nvec, s);
  if (dtype == s2c2::kBFloat16)
    return multi::launch<__nv_bfloat16>(a, x, ids_, out, n_blocks, nb, br, d, nvec, s);
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

// The split-row stream: nvec = 1, rows of a multiple of 16 bytes, a
// 16-byte-aligned A and x (the caller checks; anything else is refused).
// a: (n_blocks·br, d); x: (d,); ids: (nb,) int32; out: (nb, br); nb >= 1.
S2C2_API int s2c2_coded_matvec_split(const void* a, const void* x, const void* ids, void* out,
                                     int64_t n_blocks, int64_t nb, int64_t br, int64_t d,
                                     int dtype, void* stream) {
  const auto* ids_ = static_cast<const int32_t*>(ids);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == s2c2::kFloat32)
    return split::launch<float>(a, x, ids_, out, n_blocks, nb, br, d, s);
  if (dtype == s2c2::kBFloat16)
    return split::launch<__nv_bfloat16>(a, x, ids_, out, n_blocks, nb, br, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
