// One fused LSTM step for the speed predictor (gate order i, f, g, o):
//   gates = x·W_ihᵀ + h·W_hhᵀ + b,  c' = σ(f)·c + σ(i)·tanh(g),  h' = σ(o)·tanh(c').
//
// Replaces src/repro/kernels/lstm_cell.py::lstm_cell_pallas.
//
// Bound on Hopper: launch latency.  The predictor runs B = 12 workers with
// I = 1 and H = 4, a few hundred bytes per step, so the time is the launch;
// the design keeps the step to one launch with no intermediate tensors.
// Design: one thread per (b, j) output element computes its four gate rows
// from the packed 4H weights (no per-gate padding), applies the activations
// and writes h' and c'.
#include "common.cuh"

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
