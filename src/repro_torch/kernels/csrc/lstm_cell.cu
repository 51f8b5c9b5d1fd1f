// One LSTM cell step in float32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_lstm_kernel`, launched by `lstm_cell`
// in src/repro/kernels/lstm_cell.py. Same function: gate order i, f, g, o,
// weights laid out (I, 4, H) and (H, 4, H), bias (4, H), float32 sums,
//   c' = sigmoid(f) c + sigmoid(i) tanh(g),   h' = sigmoid(o) tanh(c').
//
// What bounds it on an H100: at the ICU shapes (B = 8 or 16, I <= 76,
// H <= 32) one step moves 4-70 KB and does under 0.4 MFLOP, which is
// nanoseconds at 3.35 TB/s or 67 TFLOP/s; the step is bound by latency:
// the cost of launching it, and each thread's serial walk over I + H
// inputs (5-14 us of device time per step, PERF.md). The design therefore
// does the whole step in ONE launch (both products, the bias and the gate
// math fused, no intermediate in device memory) and keeps the kernel simple:
//   * one block per (batch row, tile of up to 256 hidden units);
//   * the row's x and h are staged once in shared memory;
//   * one thread per hidden unit j sums its four gate pre-activations over
//     I and H in float32; neighbouring threads read neighbouring j of
//     wx[k, g, :] and wh[k, g, :], so the weight reads are coalesced;
//   * the fused sigmoid/tanh then writes h' and c'.
// Launch overhead is what a later change would remove (a whole-sequence
// kernel, one launch per forward instead of 48).
//
// Plain C entry point, loaded with ctypes. It returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__global__ void lstm_cell_kernel(const float* __restrict__ x,
                                 const float* __restrict__ h,
                                 const float* __restrict__ c,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ b,
                                 float* __restrict__ h_out,
                                 float* __restrict__ c_out, int I, int H) {
  extern __shared__ float smem[];  // x row (I floats), then h row (H)
  float* sx = smem;
  float* sh = smem + I;
  const long long row = blockIdx.x;
  const float* xr = x + row * I;
  const float* hr = h + row * H;
  for (int k = threadIdx.x; k < I; k += blockDim.x) sx[k] = xr[k];
  for (int k = threadIdx.x; k < H; k += blockDim.x) sh[k] = hr[k];
  __syncthreads();

  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= H) return;
  const long long stride = 4LL * H;  // one input row of wx / wh

  // x @ wx and h @ wh are summed apart and added after, as in the plain
  // version: x @ wx + h @ wh + b
  float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f;
  for (int k = 0; k < I; ++k) {
    const float v = sx[k];
    const float* w = wx + k * stride + j;
    xi = fmaf(v, w[0], xi);
    xf = fmaf(v, w[H], xf);
    xg = fmaf(v, w[2 * H], xg);
    xo = fmaf(v, w[3 * H], xo);
  }
  float hi = 0.f, hf = 0.f, hg = 0.f, ho = 0.f;
  for (int k = 0; k < H; ++k) {
    const float v = sh[k];
    const float* w = wh + k * stride + j;
    hi = fmaf(v, w[0], hi);
    hf = fmaf(v, w[H], hf);
    hg = fmaf(v, w[2 * H], hg);
    ho = fmaf(v, w[3 * H], ho);
  }
  const float ig = sigmoid_f32(xi + hi + b[j]);
  const float fg = sigmoid_f32(xf + hf + b[H + j]);
  const float gg = tanhf(xg + hg + b[2 * H + j]);
  const float og = sigmoid_f32(xo + ho + b[3 * H + j]);
  const long long o = row * H + j;
  const float cn = fg * c[o] + ig * gg;
  c_out[o] = cn;
  h_out[o] = og * tanhf(cn);
}

}  // namespace

// x (B, I); h, c, h_out, c_out (B, H); wx (I, 4, H); wh (H, 4, H);
// b (4, H); all float32, contiguous, on one device. `stream` is a
// cudaStream_t. Returns a cudaError_t (0 on success).
extern "C" int repro_lstm_cell_f32(const void* x, const void* h,
                                   const void* c, const void* wx,
                                   const void* wh, const void* b, void* h_out,
                                   void* c_out, int B, int I, int H,
                                   void* stream) {
  int threads = ((H + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid(B, (H + threads - 1) / threads);
  const size_t smem = static_cast<size_t>(I + H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lstm_cell_kernel<<<grid, threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(c), static_cast<const float*>(wx),
      static_cast<const float*>(wh), static_cast<const float*>(b),
      static_cast<float*>(h_out), static_cast<float*>(c_out), I, H);
  return static_cast<int>(cudaGetLastError());
}
