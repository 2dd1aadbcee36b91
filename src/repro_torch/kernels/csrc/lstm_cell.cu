// The speed predictor's LSTM (gate order i, f, g, o), two entry points:
//   s2c2_lstm_cell:     one step, gates = x·W_ihᵀ + h·W_hhᵀ + b,
//                       c' = σ(f)·c + σ(i)·tanh(g),  h' = σ(o)·tanh(c');
//   s2c2_lstm_sequence: a whole window from h = c = 0, for t = 0..T-1
//                       h, c = cell(xs[t], h, c);  ys[t] = h·W_outᵀ + b_out.
//
// Both replace src/repro/kernels/lstm_cell.py::lstm_cell_pallas; the sequence
// also replaces the lax.scan around it (src/repro/core/predictor.py::
// lstm_apply) and the output head, which the main path runs on every
// prediction.
//
// Bound on Hopper.  The predictor runs B = 12 workers with I = 1, H = 4,
// O = 1: a 32-step window moves about 3.5 kB (1 ns at the HBM rate) and does
// about 31 kFLOP, so neither bytes nor operations bound it.  What does is
// one launch plus a chain of T dependent steps, each a 4H × (I + H) product,
// three sigmoids, two tanh and an O × H head.  The cell pays a launch and a
// device-memory round trip of h and c for every step (and the head two more
// launches); the sequence pays one launch for the window.
// Why not wgmma or TMA: a row's step is a 16 × 5 product, which would leave
// a 64-row wgmma tile almost empty and put a warpgroup barrier on the chain,
// and a block's inputs are under 2 kB, which needs no bulk copy.
//
// Sequence design.  Batch rows are independent: each row gets a group of 4H
// threads, thread j owning gate row j, with its rows of W_ih, W_hh and b in
// registers for all T steps.  Each block first stages its rows' slice of xs
// in shared memory (16 kB of steps at a time), so the step loop reads no
// device memory; each step's ys are stored as soon as they are known.
//  * 4H ≤ 32 (the predictor's H = 4: 16 lanes, two rows per warp): the group
//    is a power-of-two segment of one warp.  The lanes of units u < H fetch
//    their f, g, o activations with __shfl_sync, update c (kept in a
//    register) and h, and h is broadcast to the whole group by H shuffles:
//    no barrier and no shared or global write of the state.  With the whole
//    h in every lane, lane o < O computes output o of the head directly.
//  * 4H > 32 (H up to 32): the activations go through shared memory, double
//    buffered, with one block barrier per step; after it every thread
//    updates all H units itself (c in registers), which gives it the whole
//    h for its next product and its head output without a second barrier.
// Activations use expf and tanhf, as the cell does, to stay within 1e-5 of
// the plain version over long windows.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void __launch_bounds__(kThreads)
lstm_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ c, const float* __restrict__ w_ih,
                 const float* __restrict__ w_hh, const float* __restrict__ b,
                 float* __restrict__ h_out, float* __restrict__ c_out,
                 int64_t batch, int in_dim, int hidden) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= batch * hidden) return;
  const int64_t bi = t / hidden;
  const int j = static_cast<int>(t % hidden);
  const float* xb = x + bi * in_dim;
  const float* hb = h + bi * hidden;
  float gate[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int64_t row = static_cast<int64_t>(q) * hidden + j;
    float s = b[row];
    for (int i = 0; i < in_dim; ++i) s = fmaf(xb[i], w_ih[row * in_dim + i], s);
    for (int i = 0; i < hidden; ++i) s = fmaf(hb[i], w_hh[row * hidden + i], s);
    gate[q] = s;
  }
  const float cn = sigmoid(gate[1]) * c[t] + sigmoid(gate[0]) * tanhf(gate[2]);
  c_out[t] = cn;
  h_out[t] = sigmoid(gate[3]) * tanhf(cn);
}

// ---------------------------------------------------------------------------
// The sequence kernel
// ---------------------------------------------------------------------------

constexpr int kSeqThreads = 256;          // threads of a block, at most
constexpr int kStageBytes = 16 * 1024;    // xs staged per block, per chunk of steps
constexpr int kMaxHidden = 32;            // keep in step with lstm_cell.py
constexpr int kMaxIn = 16;
constexpr unsigned kFull = 0xffffffffu;

struct SeqArgs {
  const float* xs;        // (T, B, I)
  const float* w_ih;      // (4H, I)
  const float* w_hh;      // (4H, H)
  const float* b;         // (4H,)
  const float* w_out;     // (O, H)
  const float* b_out;     // (O,)
  float* ys;              // (T, B, O)
  int64_t batch;
  int steps, in_dim, hidden, out_dim;
  int group;              // threads per batch row
  int rows;               // batch rows per block
  int chunk;              // steps of xs staged at a time
};

// The thread's registers: its gate row of W_ih, W_hh and b, and, for
// threads j < O, row j of the head.
template <int HMAX, int IMAX>
struct RowWeights {
  float wi[IMAX], wh[HMAX], wo[HMAX], bias, bo;

  __device__ __forceinline__ void load(const SeqArgs& a, int j) {
    const bool gate = j < 4 * a.hidden, head = j < a.out_dim;
#pragma unroll
    for (int i = 0; i < IMAX; ++i)
      wi[i] = (gate && i < a.in_dim) ? a.w_ih[j * a.in_dim + i] : 0.f;
#pragma unroll
    for (int k = 0; k < HMAX; ++k) {
      wh[k] = (gate && k < a.hidden) ? a.w_hh[j * a.hidden + k] : 0.f;
      wo[k] = (head && k < a.hidden) ? a.w_out[j * a.hidden + k] : 0.f;
    }
    bias = gate ? a.b[j] : 0.f;
    bo = head ? a.b_out[j] : 0.f;
  }

  // bias + x·w_ih (x is the row's input at this step, in shared memory)
  __device__ __forceinline__ float input_part(const float* x, int in_dim) const {
    float s = bias;
#pragma unroll
    for (int i = 0; i < IMAX; ++i)
      if (i < in_dim) s = fmaf(x[i], wi[i], s);
    return s;
  }
};

// Stage steps [t0, t0 + n) of the block's rows of xs into xs_s (n, rows, I);
// rows past the batch are left unwritten and never read into an output.
__device__ __forceinline__ void stage(const SeqArgs& a, float* xs_s, int t0, int n,
                                      int64_t row0, int live_rows) {
  const int per_step = live_rows * a.in_dim;
  for (int e = threadIdx.x; e < n * per_step; e += blockDim.x) {
    const int s = e / per_step, r = e - s * per_step;
    xs_s[s * a.rows * a.in_dim + r] =
        a.xs[(static_cast<int64_t>(t0 + s) * a.batch + row0) * a.in_dim + r];
  }
}

// 4H ≤ 32: one row per power-of-two segment of a warp, state in registers,
// exchanged by shuffles.  blockDim.x is a multiple of 32, so every shuffle
// runs on a full warp.
template <int HMAX, int IMAX>
__global__ void __launch_bounds__(kSeqThreads)
lstm_sequence_warp_kernel(const SeqArgs a) {
  extern __shared__ float xs_s[];                        // (chunk, rows, I)
  const int H = a.hidden, G = a.group;
  const int r = threadIdx.x / G, j = threadIdx.x % G;
  const int q = j / H, u = j % H;                        // gate and unit of lane j
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * a.rows;
  const int64_t left = a.batch - row0;
  const int live_rows = left < a.rows ? static_cast<int>(left) : a.rows;
  const bool live = r < live_rows;
  RowWeights<HMAX, IMAX> w;
  w.load(a, j);
  float h[HMAX];
#pragma unroll
  for (int k = 0; k < HMAX; ++k) h[k] = 0.f;
  float c = 0.f;

  for (int t0 = 0; t0 < a.steps; t0 += a.chunk) {
    const int n = min(a.chunk, a.steps - t0);
    __syncthreads();                                     // the last chunk is read
    stage(a, xs_s, t0, n, row0, live_rows);
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      float acc = live ? w.input_part(xs_s + (s * a.rows + r) * a.in_dim, a.in_dim) : 0.f;
#pragma unroll
      for (int k = 0; k < HMAX; ++k)
        if (k < H) acc = fmaf(h[k], w.wh[k], acc);
      const float act = q == 2 ? tanhf(acc) : sigmoid(acc);
      // lane u < H holds σ(i_u); it fetches σ(f_u), tanh(g_u), σ(o_u)
      const float f = __shfl_sync(kFull, act, H + u, G);
      const float g = __shfl_sync(kFull, act, 2 * H + u, G);
      const float o = __shfl_sync(kFull, act, 3 * H + u, G);
      c = f * c + act * g;
      const float hn = o * tanhf(c);
#pragma unroll
      for (int k = 0; k < HMAX; ++k)
        if (k < H) h[k] = __shfl_sync(kFull, hn, k, G);
      if (live && j < a.out_dim) {
        float y = w.bo;
#pragma unroll
        for (int k = 0; k < HMAX; ++k)
          if (k < H) y = fmaf(h[k], w.wo[k], y);
        a.ys[(static_cast<int64_t>(t0 + s) * a.batch + row0 + r) * a.out_dim + j] = y;
      }
    }
  }
}

// 4H > 32: one row per 4H consecutive threads; activations through shared
// memory, double buffered, one barrier per step.
template <int HMAX, int IMAX>
__global__ void __launch_bounds__(kSeqThreads)
lstm_sequence_block_kernel(const SeqArgs a) {
  extern __shared__ float smem[];
  const int H = a.hidden, G = a.group;                   // G = 4H
  float* gates = smem;                                   // (2, rows, 4H)
  float* xs_s = smem + 2 * a.rows * G;                   // (chunk, rows, I)
  const int r = threadIdx.x / G, j = threadIdx.x % G;
  const int q = j / H;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * a.rows;
  const int64_t left = a.batch - row0;
  const int live_rows = left < a.rows ? static_cast<int>(left) : a.rows;
  const bool live = r < live_rows;
  RowWeights<HMAX, IMAX> w;
  w.load(a, j);
  float c[HMAX];
#pragma unroll
  for (int k = 0; k < HMAX; ++k) c[k] = 0.f;
  float rec = 0.f;                                       // h·w_hh of this gate row
  int buf = 0;

  for (int t0 = 0; t0 < a.steps; t0 += a.chunk) {
    const int n = min(a.chunk, a.steps - t0);
    __syncthreads();
    stage(a, xs_s, t0, n, row0, live_rows);
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const float acc = (live ? w.input_part(xs_s + (s * a.rows + r) * a.in_dim, a.in_dim)
                              : 0.f) + rec;
      float* gr = gates + (buf * a.rows + r) * G;
      gr[j] = q == 2 ? tanhf(acc) : sigmoid(acc);
      __syncthreads();
      // every thread advances all H units of its row: c, then h, which feeds
      // its own next product and its head output at once
      rec = 0.f;
      float y = w.bo;
#pragma unroll
      for (int k = 0; k < HMAX; ++k) {
        if (k < H) {
          c[k] = gr[H + k] * c[k] + gr[k] * gr[2 * H + k];
          const float hk = gr[3 * H + k] * tanhf(c[k]);
          rec = fmaf(hk, w.wh[k], rec);
          y = fmaf(hk, w.wo[k], y);
        }
      }
      if (live && j < a.out_dim)
        a.ys[(static_cast<int64_t>(t0 + s) * a.batch + row0 + r) * a.out_dim + j] = y;
      buf ^= 1;
    }
  }
}

template <int HMAX, int IMAX>
void launch_sequence(const SeqArgs& a, unsigned grid, int threads, size_t smem,
                     cudaStream_t stream) {
  if constexpr (4 * HMAX <= 32) {
    lstm_sequence_warp_kernel<HMAX, IMAX><<<grid, threads, smem, stream>>>(a);
  } else {
    lstm_sequence_block_kernel<HMAX, IMAX><<<grid, threads, smem, stream>>>(a);
  }
}

template <int HMAX>
void launch_sequence_in(const SeqArgs& a, unsigned grid, int threads, size_t smem,
                        cudaStream_t stream) {
  if (a.in_dim == 1) launch_sequence<HMAX, 1>(a, grid, threads, smem, stream);
  else if (a.in_dim <= 4) launch_sequence<HMAX, 4>(a, grid, threads, smem, stream);
  else launch_sequence<HMAX, kMaxIn>(a, grid, threads, smem, stream);
}

}  // namespace

// x: (B, I); h, c, h_out, c_out: (B, H); w_ih: (4H, I); w_hh: (4H, H); b: (4H,).
S2C2_API int s2c2_lstm_cell(const void* x, const void* h, const void* c, const void* w_ih,
                            const void* w_hh, const void* b, void* h_out, void* c_out,
                            int64_t batch, int64_t in_dim, int64_t hidden, void* stream) {
  if (batch < 1 || in_dim < 1 || hidden < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t grid = (batch * hidden + kThreads - 1) / kThreads;
  lstm_cell_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(w_ih),
      static_cast<const float*>(w_hh), static_cast<const float*>(b),
      static_cast<float*>(h_out), static_cast<float*>(c_out), batch,
      static_cast<int>(in_dim), static_cast<int>(hidden));
  return static_cast<int>(cudaGetLastError());
}

// xs: (T, B, I); w_ih: (4H, I); w_hh: (4H, H); b: (4H,); w_out: (O, H);
// b_out: (O,); ys: (T, B, O).  H ≤ 32, I ≤ 16, O ≤ 4H.
S2C2_API int s2c2_lstm_sequence(const void* xs, const void* w_ih, const void* w_hh,
                                const void* b, const void* w_out, const void* b_out, void* ys,
                                int64_t steps, int64_t batch, int64_t in_dim, int64_t hidden,
                                int64_t out_dim, void* stream) {
  if (steps < 1 || steps > INT32_MAX || batch < 1 || in_dim < 1 || in_dim > kMaxIn ||
      hidden < 1 || hidden > kMaxHidden || out_dim < 1 || out_dim > 4 * hidden)
    return static_cast<int>(cudaErrorInvalidValue);
  SeqArgs a{static_cast<const float*>(xs), static_cast<const float*>(w_ih),
            static_cast<const float*>(w_hh), static_cast<const float*>(b),
            static_cast<const float*>(w_out), static_cast<const float*>(b_out),
            static_cast<float*>(ys), batch, static_cast<int>(steps),
            static_cast<int>(in_dim), static_cast<int>(hidden), static_cast<int>(out_dim),
            0, 0, 0};
  const int gates = 4 * a.hidden;
  size_t smem = 0;
  if (gates <= 32) {
    // a power-of-two segment of a warp per row; whole warps per block
    a.group = gates <= 4 ? 4 : gates <= 8 ? 8 : gates <= 16 ? 16 : 32;
    const int per_warp = 32 / a.group;
    const int64_t warps = (batch + per_warp - 1) / per_warp;
    a.rows = per_warp * static_cast<int>(std::min<int64_t>(warps, kSeqThreads / 32));
  } else {
    a.group = gates;
    a.rows = static_cast<int>(std::min<int64_t>(batch, kSeqThreads / gates));
    smem += sizeof(float) * 2 * a.rows * gates;
  }
  const int step_bytes = static_cast<int>(sizeof(float)) * a.rows * a.in_dim;
  a.chunk = static_cast<int>(std::min<int64_t>(steps, std::max(1, kStageBytes / step_bytes)));
  smem += static_cast<size_t>(step_bytes) * a.chunk;
  const int64_t grid = (batch + a.rows - 1) / a.rows;
  if (grid > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = a.rows * a.group;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto g = static_cast<unsigned>(grid);
  if (a.hidden <= 4) launch_sequence_in<4>(a, g, threads, smem, s);
  else if (a.hidden <= 8) launch_sequence_in<8>(a, g, threads, smem, s);
  else if (a.hidden <= 16) launch_sequence_in<16>(a, g, threads, smem, s);
  else launch_sequence_in<kMaxHidden>(a, g, threads, smem, s);
  return static_cast<int>(cudaGetLastError());
}
