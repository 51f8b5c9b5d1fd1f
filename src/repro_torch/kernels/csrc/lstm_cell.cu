// The LSTM cell with float32 math, for Hopper (sm_90a): one step, and a
// whole layer's sequence in one launch, on float32 or bfloat16 inputs.
//
// Replaces the Pallas TPU kernel `_lstm_kernel`, launched by `lstm_cell`
// in src/repro/kernels/lstm_cell.py, and its scan over time in the
// reference's `ICULSTM.forward` (src/repro/models/lstm.py). Same function:
// gate order i, f, g, o, weights laid out (I, 4, H) and (H, 4, H), bias
// (4, H), float32 sums,
//   c' = sigmoid(f) c + sigmoid(i) tanh(g),   h' = sigmoid(o) tanh(c').
// As the Pallas cell casts them, every input is read in its own dtype
// (float32 or bfloat16) and taken to float32, and h' and c' are written in
// h's and c's dtypes. The sequence kernel takes one dtype for all its
// inputs and returns h and c in it, so with bfloat16 it rounds h and c to
// bfloat16 after every step, as a scan of the cell would.
//
// What bounds it on an H100: at the ICU shapes (B = 8 or 16, I <= 76,
// H <= 32) one step moves 4-70 KB and does under 0.4 MFLOP, which is
// nanoseconds at 3.35 TB/s or 67 TFLOP/s; the step is bound by latency.
//
// `lstm_cell_kernel` (one step, `repro_lstm_cell`): both products, the
// bias and the gate math fused in one launch; one block per (batch row,
// tile of up to 256 hidden units), the row's x and h staged in shared
// memory, one thread per hidden unit summing its four gates over I and H
// with coalesced weight reads; one instance per mask of input dtypes, so no
// load branches on its dtype. Called once per timestep, its cost is the
// host's launch (29-43 us through the wrapper against 5-14 us on the card).
//
// `lstm_sequence_kernel` (T steps, `repro_lstm_sequence`): a layer in
// ONE launch, so the host pays one launch per layer, not one per step. The
// serial chain of T dependent steps is what is left; the design keeps each
// step short and everything it reads on chip:
//   * one block per batch row; the sequence runs in segments of TS steps,
//     the whole sequence when it fits (every ICU shape: T = 48);
//   * wx is staged once in shared memory by cp.async when it takes at
//     most half of it (39 KB at I = 76, H = 32), else read through L1/L2;
//     a segment's inputs arrive by cp.async in one burst;
//   * the input half x_t . wx does not depend on h: it is computed first
//     for the whole segment, 16 steps a pass, one thread per gate column,
//     the passes spread over R groups of threads (256 threads a block for
//     H <= 32), and kept in shared memory;
//   * the recurrence, H <= 32 (every ICU shape): one warp walks the
//     steps. Lane j owns hidden unit j: its four gates' columns of wh
//     (4H floats) in registers, h and c in registers; h passes between the
//     lanes through shared memory under __syncwarp, so a step waits on no
//     block barrier, only on its dot over H and the gate math;
//   * the recurrence, H > 32 (up to 256): one thread per gate column, wh
//     read through L1/L2 (1 MiB at H = 256); a step is a dot over H
//     against h in shared memory, a barrier, the gate math by H threads,
//     and a barrier;
//   * the gate math takes exp2 and the reciprocal from the special-function
//     unit (`sigmoid_sfu`, `tanh_sfu`): expf, tanhf and IEEE division are
//     branchy instruction sequences, and the gate math is most of a step's
//     serial chain.
//   x . wx and h . wh are summed apart and then added, with the bias last,
//   as the step kernel does.
//
// Training: the sequence kernel's TRAIN instances also record every step's
// activated gates and cell state, and `lstm_sequence_bwd_kernel`
// (`repro_lstm_sequence_backward`) walks the gradient back through time
// from them (its design note is beside it). The reference has no backward
// kernel: its gradient is JAX's autodiff of the scanned cell.
//
// Plain C entry points, loaded with ctypes. Each returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <array>
#include <type_traits>
#include <utility>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoid_f32(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// bit k of `dtypes` set: tensor k of (x, h, c, wx, wh, b) is bfloat16;
// h_out and c_out take h's and c's dtypes
enum { BF_X = 1, BF_H = 2, BF_C = 4, BF_WX = 8, BF_WH = 16, BF_B = 32 };
constexpr int CELL_DTYPE_MASKS = 64;

// the element type of the tensor whose bit is `BIT` in `M`
template <int M, int BIT>
using CellT = std::conditional_t<(M & BIT) != 0, bf16, float>;

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// One instance per dtype mask M, so that every load and store is typed at
// compile time; M = 0 is the all-float32 kernel.
template <int M>
__global__ void lstm_cell_kernel(const CellT<M, BF_X>* __restrict__ x,
                                 const CellT<M, BF_H>* __restrict__ h,
                                 const CellT<M, BF_C>* __restrict__ c,
                                 const CellT<M, BF_WX>* __restrict__ wx,
                                 const CellT<M, BF_WH>* __restrict__ wh,
                                 const CellT<M, BF_B>* __restrict__ b,
                                 CellT<M, BF_H>* __restrict__ h_out,
                                 CellT<M, BF_C>* __restrict__ c_out, int I,
                                 int H) {
  extern __shared__ float smem[];  // x row (I floats), then h row (H)
  float* sx = smem;
  float* sh = smem + I;
  const long long row = blockIdx.x;
  const auto* xr = x + row * I;
  const auto* hr = h + row * H;
  for (int k = threadIdx.x; k < I; k += blockDim.x) sx[k] = to_f32(xr[k]);
  for (int k = threadIdx.x; k < H; k += blockDim.x) sh[k] = to_f32(hr[k]);
  __syncthreads();

  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= H) return;
  const long long stride = 4LL * H;  // one input row of wx / wh

  // x @ wx and h @ wh are summed apart and added after, as in the plain
  // version: x @ wx + h @ wh + b
  float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f;
  for (int k = 0; k < I; ++k) {
    const float v = sx[k];
    const auto* w = wx + k * stride + j;
    xi = fmaf(v, to_f32(w[0]), xi);
    xf = fmaf(v, to_f32(w[H]), xf);
    xg = fmaf(v, to_f32(w[2 * H]), xg);
    xo = fmaf(v, to_f32(w[3 * H]), xo);
  }
  float hi = 0.f, hf = 0.f, hg = 0.f, ho = 0.f;
  for (int k = 0; k < H; ++k) {
    const float v = sh[k];
    const auto* w = wh + k * stride + j;
    hi = fmaf(v, to_f32(w[0]), hi);
    hf = fmaf(v, to_f32(w[H]), hf);
    hg = fmaf(v, to_f32(w[2 * H]), hg);
    ho = fmaf(v, to_f32(w[3 * H]), ho);
  }
  const float ig = sigmoid_f32(xi + hi + to_f32(b[j]));
  const float fg = sigmoid_f32(xf + hf + to_f32(b[H + j]));
  const float gg = tanhf(xg + hg + to_f32(b[2 * H + j]));
  const float og = sigmoid_f32(xo + ho + to_f32(b[3 * H + j]));
  const long long o = row * H + j;
  const float cn = fg * to_f32(c[o]) + ig * gg;
  store_as(c_out + o, cn);
  store_as(h_out + o, og * tanhf(cn));
}

template <int M>
int launch_cell(const void* x, const void* h, const void* c, const void* wx,
                const void* wh, const void* b, void* h_out, void* c_out,
                int B, int I, int H, cudaStream_t stream) {
  int threads = ((H + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid(B, (H + threads - 1) / threads);
  const size_t smem = static_cast<size_t>(I + H) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lstm_cell_kernel<M><<<grid, threads, smem, stream>>>(
      static_cast<const CellT<M, BF_X>*>(x),
      static_cast<const CellT<M, BF_H>*>(h),
      static_cast<const CellT<M, BF_C>*>(c),
      static_cast<const CellT<M, BF_WX>*>(wx),
      static_cast<const CellT<M, BF_WH>*>(wh),
      static_cast<const CellT<M, BF_B>*>(b),
      static_cast<CellT<M, BF_H>*>(h_out), static_cast<CellT<M, BF_C>*>(c_out),
      I, H);
  return static_cast<int>(cudaGetLastError());
}

using CellLaunch = int (*)(const void*, const void*, const void*, const void*,
                           const void*, const void*, void*, void*, int, int,
                           int, cudaStream_t);

// launch_cell<M> for every M, indexed by the dtype mask
template <int... M>
constexpr std::array<CellLaunch, sizeof...(M)> cell_launches(
    std::integer_sequence<int, M...>) {
  return {&launch_cell<M>...};
}

}  // namespace

// x (B, I); h, c, h_out, c_out (B, H); wx (I, 4, H); wh (H, 4, H);
// b (4, H); each float32 or bfloat16 as `dtypes` says (bit k: input k of
// x, h, c, wx, wh, b is bfloat16; h_out and c_out as h and c),
// contiguous, on one device. `stream` is a cudaStream_t. Returns a
// cudaError_t (0 on success).
extern "C" int repro_lstm_cell(const void* x, const void* h, const void* c,
                               const void* wx, const void* wh, const void* b,
                               void* h_out, void* c_out, int B, int I, int H,
                               int dtypes, void* stream) {
  static constexpr auto launches =
      cell_launches(std::make_integer_sequence<int, CELL_DTYPE_MASKS>{});
  if (dtypes < 0 || dtypes >= CELL_DTYPE_MASKS)
    return static_cast<int>(cudaErrorInvalidValue);
  return launches[dtypes](x, h, c, wx, wh, b, h_out, c_out, B, I, H,
                          static_cast<cudaStream_t>(stream));
}

namespace {

constexpr int SEQ_TC = 16;   // timesteps of the input half per pass
constexpr int REG_H = 32;    // hidden sizes one warp runs, wh in registers
constexpr size_t SEQ_SMEM_CAP = 200 * 1024;  // shared memory a block takes

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The gate math on the special-function unit: exp2 and reciprocal in one
// instruction each, where expf, tanhf and an IEEE division are branchy
// sequences on the step's serial chain. Each is within a few 1e-7 of the
// exact value on [-1, 1]; chip_smoke.py and tests/test_torch_cuda.py hold
// whole sequences (T up to 130) to the plain version at 1e-5.
__device__ __forceinline__ float sigmoid_sfu(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

__device__ __forceinline__ float tanh_sfu(float v) {
  const float e = __expf(-2.f * fabsf(v));
  return copysignf(__fdividef(1.f - e, 1.f + e), v);
}

// How the sequence kernel uses shared memory, in floats: h (H, zero-padded
// to at least REG_H), the step's gates (4H), wx (I x 4H) when staged, then
// a segment of
// TS timesteps: its inputs (TS / SEQ_TC passes of I x SEQ_TC, k-major) and
// its input half (TS x 4H).
struct SeqLayout {
  size_t h, gates, wx, x, xw, total;
  __host__ __device__ SeqLayout(int TS, int I, int H, bool stage_wx) {
    const size_t G = 4 * static_cast<size_t>(H);
    h = 0;
    gates = H > REG_H ? (H + 3) & ~3 : REG_H;
    wx = gates + G;
    x = wx + (stage_wx ? static_cast<size_t>(I) * G : 0);
    xw = x + static_cast<size_t>(TS) * I;
    total = xw + static_cast<size_t>(TS) * G;
  }
};

// h or c rounded to the sequence's dtype: the plain scan of the cell
// carries them in it from step to step
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// The training forward's record of one step of one hidden unit: the four
// activated gates of row `bt` = t * B + b (gates (T, B, 4H)) and its cell
// state before the rounding (cs (T, B, H)).
__device__ __forceinline__ void save_step(float* gates, float* cs, int bt,
                                          int H, int j, float ig, float fg,
                                          float gg, float og, float c) {
  float* gr = gates + static_cast<long long>(bt) * 4 * H + j;
  gr[0] = ig;
  gr[H] = fg;
  gr[2 * H] = gg;
  gr[3 * H] = og;
  cs[static_cast<long long>(bt) * H + j] = c;
}

// xs (T, B, I); hs (T, B, H) or null; all of type T_ (float or bf16),
// staged in shared memory as float32. Inputs are read through
// static_cast<float> in place, with no helper call: so written, the float
// instance compiles to the same SASS as the float32-only kernel it
// replaced (tools/kernel_ab.py checks). One block per batch row; blockDim.x
// = R x G32, G32 = 4H rounded up to 32: R groups of one thread per gate
// column share the input half's passes. TS (a multiple of SEQ_TC) steps a
// segment. HR: the recurrence's width on one warp (8, 16 or 32, at least
// H; wh and h zero-padded to it), or 0 for the block-wide recurrence.
// TRAIN (the training forward): also write every step's activated gates
// i, f, g, o to `gates` (T, B, 4H) and its cell state before the rounding
// to the dtype to `cs` (T, B, H), both float32, for the backward kernel;
// the serving instances (TRAIN = false) read neither pointer, which come
// last so that the other parameters keep their offsets.
template <int HR, typename T_, bool TRAIN>
__global__ void lstm_sequence_kernel(const T_* __restrict__ xs,
                                     const T_* __restrict__ wx,
                                     const T_* __restrict__ wh,
                                     const T_* __restrict__ b,
                                     T_* __restrict__ h_out,
                                     T_* __restrict__ c_out,
                                     T_* __restrict__ hs, int T, int B,
                                     int I, int H, int TS, int stage_wx,
                                     float* __restrict__ gates_out,
                                     float* __restrict__ cs) {
  constexpr bool F32 = std::is_same<T_, float>::value;
  extern __shared__ __align__(16) float seq_smem[];
  const SeqLayout lay(TS, I, H, stage_wx);
  float* hsh = seq_smem + lay.h;
  float* gates = seq_smem + lay.gates;
  float* xsh = seq_smem + lay.x;
  float* xwsh = seq_smem + lay.xw;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int G = 4 * H;
  const int g32 = (G + 31) & ~31;
  const int n = tid % g32;          // gate column: gate n / H, unit n % H
  const int grp = tid / g32;        // which passes of the input half
  const int groups = blockDim.x / g32;
  const bool col = n < G;

  if (stage_wx) {
    if constexpr (F32) {
      for (int e = tid; e < I * H; e += blockDim.x)  // I x 4H floats, by 4
        cp_async16(seq_smem + lay.wx + 4 * e,
                   reinterpret_cast<const float*>(wx) + 4 * e);
    } else {
      for (int e = tid; e < 4 * I * H; e += blockDim.x)
        seq_smem[lay.wx + e] = static_cast<float>(wx[e]);
    }
  }
  for (int e = tid; e < static_cast<int>(lay.gates); e += blockDim.x)
    hsh[e] = 0.f;

  // the recurrence's state, kept from one segment to the next
  float h = 0.f, c = 0.f;
  constexpr int WR = HR > 0 ? HR : 1;
  float w[4][WR];
  float bias[4];
  if (HR > 0) {  // lane j owns unit j: its four gates' columns of wh
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int k = 0; k < WR; ++k)
        w[g][k] = (tid < H && k < H)
                      ? static_cast<float>(
                            wh[static_cast<long long>(k) * G + g * H + tid])
                      : 0.f;
      bias[g] = tid < H ? static_cast<float>(b[g * H + tid]) : 0.f;
    }
  } else {
    bias[0] = col ? static_cast<float>(b[n]) : 0.f;
  }

  for (int s0 = 0; s0 < T; s0 += TS) {
    const int sn = min(TS, T - s0);
    // 1. the segment's inputs, by cp.async, k-major within each pass
    for (int e = tid; e < sn * I; e += blockDim.x) {
      const int t = e / I, k = e - t * I;
      float* dst = xsh + ((t / SEQ_TC) * I + k) * SEQ_TC + t % SEQ_TC;
      const T_* src = xs + (static_cast<long long>(s0 + t) * B + row) * I + k;
      if constexpr (F32)
        cp_async4(dst, reinterpret_cast<const float*>(src));
      else
        *dst = static_cast<float>(*src);
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. the input half, x_t . wx, SEQ_TC steps a pass, into xwsh
    if (col) {
      const int passes = (sn + SEQ_TC - 1) / SEQ_TC;
      const auto run_passes = [&](const auto* wcol) {
        for (int pass = grp; pass < passes; pass += groups) {
          const float* xp = xsh + static_cast<size_t>(pass) * I * SEQ_TC;
          float acc[SEQ_TC];
#pragma unroll
          for (int t = 0; t < SEQ_TC; ++t) acc[t] = 0.f;
#pragma unroll 4
          for (int k = 0; k < I; ++k) {
            const float wk =
                static_cast<float>(wcol[static_cast<long long>(k) * G]);
            const float4* x4 = reinterpret_cast<const float4*>(xp + k * SEQ_TC);
#pragma unroll
            for (int q = 0; q < SEQ_TC / 4; ++q) {
              const float4 v = x4[q];
              acc[4 * q] = fmaf(v.x, wk, acc[4 * q]);
              acc[4 * q + 1] = fmaf(v.y, wk, acc[4 * q + 1]);
              acc[4 * q + 2] = fmaf(v.z, wk, acc[4 * q + 2]);
              acc[4 * q + 3] = fmaf(v.w, wk, acc[4 * q + 3]);
            }
          }
          const int t0 = pass * SEQ_TC;
#pragma unroll
          for (int t = 0; t < SEQ_TC; ++t)
            if (t0 + t < sn) xwsh[(t0 + t) * G + n] = acc[t];
        }
      };
      if (stage_wx)
        run_passes(seq_smem + lay.wx + n);
      else
        run_passes(wx + n);
    }
    __syncthreads();

    // 3. the recurrence over the segment
    if (HR > 0) {
      // H <= 32: warp 0 alone; lane j owns unit j, h and c in registers;
      // h passes through shared memory between the lanes of one warp, so a
      // step waits on no block barrier. The dot runs over HR >= H in order
      // (zero weights past H), as the step kernel's does over H.
      if (tid < 32) {
        for (int t = 0; t < sn; ++t) {
          float hv[WR], pre[4];
#pragma unroll
          for (int k = 0; k < WR; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(hsh + k);
            hv[k] = v.x;
            hv[k + 1] = v.y;
            hv[k + 2] = v.z;
            hv[k + 3] = v.w;
          }
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[g] = tid < H ? xwsh[t * G + g * H + tid] : 0.f;
          __syncwarp();  // every lane has read h before it changes
          // k outermost: the four gates' sums are four independent chains
          float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < WR; ++k)
#pragma unroll
            for (int g = 0; g < 4; ++g) a[g] = fmaf(hv[k], w[g][k], a[g]);
          if (tid < H) {
            const float ig = sigmoid_sfu(pre[0] + a[0] + bias[0]);
            const float fg = sigmoid_sfu(pre[1] + a[1] + bias[1]);
            const float gg = tanh_sfu(pre[2] + a[2] + bias[2]);
            const float og = sigmoid_sfu(pre[3] + a[3] + bias[3]);
            c = fg * c + ig * gg;
            if constexpr (TRAIN)
              save_step(gates_out, cs, (s0 + t) * B + row, H, tid, ig, fg, gg,
                        og, c);
            h = round_to(og * tanh_sfu(c), xs);
            c = round_to(c, xs);
            hsh[tid] = h;
            if (hs != nullptr)
              store_as(hs + (static_cast<long long>(s0 + t) * B + row) * H +
                           tid,
                       h);
          }
          __syncwarp();
        }
      }
    } else {
      // H > 32: one thread per gate column, wh read through L1/L2; a step
      // is the dot over H (four partial sums) against h in shared memory,
      // a barrier, the gate math by H threads, a barrier
      for (int t = 0; t < sn; ++t) {
        if (col) {
          float a[4] = {0.f, 0.f, 0.f, 0.f};
          const T_* wc = wh + n;
          int k = 0;
          for (; k + 4 <= H; k += 4) {
            a[0] = fmaf(hsh[k],
                        static_cast<float>(wc[static_cast<long long>(k) * G]),
                        a[0]);
            a[1] = fmaf(
                hsh[k + 1],
                static_cast<float>(wc[static_cast<long long>(k + 1) * G]),
                a[1]);
            a[2] = fmaf(
                hsh[k + 2],
                static_cast<float>(wc[static_cast<long long>(k + 2) * G]),
                a[2]);
            a[3] = fmaf(
                hsh[k + 3],
                static_cast<float>(wc[static_cast<long long>(k + 3) * G]),
                a[3]);
          }
          for (; k < H; ++k)
            a[0] = fmaf(hsh[k],
                        static_cast<float>(wc[static_cast<long long>(k) * G]),
                        a[0]);
          gates[n] = xwsh[t * G + n] + ((a[0] + a[1]) + (a[2] + a[3])) +
                     bias[0];
        }
        __syncthreads();  // the step's gates are whole; h reads are done
        if (tid < H) {
          const float ig = sigmoid_sfu(gates[tid]);
          const float fg = sigmoid_sfu(gates[H + tid]);
          const float gg = tanh_sfu(gates[2 * H + tid]);
          const float og = sigmoid_sfu(gates[3 * H + tid]);
          c = fg * c + ig * gg;
          if constexpr (TRAIN)
            save_step(gates_out, cs, (s0 + t) * B + row, H, tid, ig, fg, gg,
                      og, c);
          h = round_to(og * tanh_sfu(c), xs);
          c = round_to(c, xs);
          hsh[tid] = h;
          if (hs != nullptr)
            store_as(hs + (static_cast<long long>(s0 + t) * B + row) * H + tid,
                     h);
        }
        __syncthreads();  // h is whole; gate reads are done
      }
    }
    __syncthreads();  // the segment's buffers are free
  }
  if (tid < H) {
    store_as(h_out + static_cast<long long>(row) * H + tid, h);
    store_as(c_out + static_cast<long long>(row) * H + tid, c);
  }
}

template <typename T_, bool TRAIN>
int launch_sequence(const void* xs, const void* wx, const void* wh,
                    const void* b, void* h_out, void* c_out, void* hs,
                    float* gates, float* cs, int T, int B, int I, int H,
                    int ts, bool stage_wx, size_t smem, int threads,
                    cudaStream_t stream) {
  const auto kernel = H <= 8    ? lstm_sequence_kernel<8, T_, TRAIN>
                      : H <= 16 ? lstm_sequence_kernel<16, T_, TRAIN>
                      : H <= 32 ? lstm_sequence_kernel<32, T_, TRAIN>
                                : lstm_sequence_kernel<0, T_, TRAIN>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, threads, smem, stream>>>(
      static_cast<const T_*>(xs), static_cast<const T_*>(wx),
      static_cast<const T_*>(wh), static_cast<const T_*>(b),
      static_cast<T_*>(h_out), static_cast<T_*>(c_out), static_cast<T_*>(hs),
      T, B, I, H, ts, stage_wx, gates, cs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xs (T, B, I); wx (I, 4, H); wh (H, 4, H); b (4, H); h_out, c_out (B, H);
// hs (T, B, H) or null; all float32 (bf16 = 0) or all bfloat16 (bf16 = 1),
// contiguous, on one device; T, B >= 1, 1 <= H <= 256, and a segment of
// SEQ_TC steps within SEQ_SMEM_CAP. gates (T, B, 4H) and cs (T, B, H),
// float32, both null (serving) or both given with hs (the training
// forward, which records what `repro_lstm_sequence_backward` reads).
// `stream` is a cudaStream_t. Returns a cudaError_t (0 on success).
extern "C" int repro_lstm_sequence(const void* xs, const void* wx,
                                   const void* wh, const void* b, void* h_out,
                                   void* c_out, void* hs, void* gates,
                                   void* cs, int T, int B, int I, int H,
                                   int bf16_inputs, void* stream) {
  if (H < 1 || 4 * H > 1024 || T < 1 || (gates == nullptr) != (cs == nullptr)
      || (gates != nullptr && hs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto bytes = [&](int ts, bool stage) {
    return SeqLayout(ts, I, H, stage).total * sizeof(float);
  };
  // wx is staged when it takes at most half the cap; the segment is the
  // whole sequence when it fits, else the most SEQ_TC-step passes that do
  const bool stage_wx = (reinterpret_cast<uintptr_t>(wx) & 15) == 0 &&
                        bytes(0, true) <= SEQ_SMEM_CAP / 2;
  const int t_pad = (T + SEQ_TC - 1) / SEQ_TC * SEQ_TC;
  int ts = t_pad;
  while (ts > SEQ_TC && bytes(ts, stage_wx) > SEQ_SMEM_CAP) ts -= SEQ_TC;
  if (bytes(ts, stage_wx) > SEQ_SMEM_CAP)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bytes(ts, stage_wx);
  const int g32 = (4 * H + 31) / 32 * 32;
  const int threads = g32 * (g32 < 256 ? 256 / g32 : 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(gates);
  float* c = static_cast<float*>(cs);
  if (bf16_inputs)
    return g ? launch_sequence<bf16, true>(xs, wx, wh, b, h_out, c_out, hs, g,
                                           c, T, B, I, H, ts, stage_wx, smem,
                                           threads, s)
             : launch_sequence<bf16, false>(xs, wx, wh, b, h_out, c_out, hs,
                                            g, c, T, B, I, H, ts, stage_wx,
                                            smem, threads, s);
  return g ? launch_sequence<float, true>(xs, wx, wh, b, h_out, c_out, hs, g,
                                          c, T, B, I, H, ts, stage_wx, smem,
                                          threads, s)
           : launch_sequence<float, false>(xs, wx, wh, b, h_out, c_out, hs, g,
                                           c, T, B, I, H, ts, stage_wx, smem,
                                           threads, s);
}

namespace {

// The backward through time of one layer (`repro_lstm_sequence_backward`):
// the serial chain of the gradient, t = T-1 ... 0, from what the training
// forward recorded. Per step and hidden unit j, with dh = dhs_t + dh_next
// (+ dh_T at the last step) and dc carried (dc_T at the last step),
//   tc = tanh(c_t),   dc += dh o (1 - tc^2),
//   dI = dc g i (1 - i),   dF = dc c_{t-1} f (1 - f),
//   dG = dc i (1 - g^2),   dO = dh tc o (1 - o),   dc <- dc f,
// where c_t is the state before the rounding to the dtype (what tanh read)
// and c_{t-1} the rounded state the forward carried; then the chain's
// product dh_next = dGates_t . wh^T (the 4H pre-activation gradients
// against wh's row of each hidden unit). The products off the chain (the
// weights' gradients, dxs) are matrix products over all T x B rows, left to
// the caller.
//
// What bounds it: like the forward, T dependent steps; at the ICU shapes a
// step moves under 10 KB and its products are a few kFLOP, so the chain's
// latency is what is left. One block per batch row; H threads do a step's
// gate math, then the dot over 4H of every hidden unit is spread over all
// warps, one hidden unit a warp at a time, lanes striding wh's row (read
// through L1/L2, coalesced; up to 1 MiB at H = 256) and a shuffle sum; the
// next step's recorded gates and states are loaded before the barrier, so
// their latency is off the chain.
template <typename T_>
__global__ void lstm_sequence_bwd_kernel(const T_* __restrict__ wh,
                                         const float* __restrict__ gates,
                                         const float* __restrict__ cs,
                                         const T_* __restrict__ dhs,
                                         const T_* __restrict__ dh_last,
                                         const T_* __restrict__ dc_last,
                                         float* __restrict__ dgates, int T,
                                         int B, int H) {
  extern __shared__ float bwd_smem[];
  float* dgs = bwd_smem;           // the step's 4H gate gradients
  float* dhn = bwd_smem + 4 * H;   // dh_next (H)
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int G = 4 * H;
  float dc = 0.f;
  // this thread's inputs of step t (unit tid)
  float ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f, c = 0.f, cp = 0.f, up = 0.f;
  const auto load = [&](int t) {
    const long long bt = static_cast<long long>(t) * B + row;
    const float* gr = gates + bt * G + tid;
    ig = gr[0];
    fg = gr[H];
    gg = gr[2 * H];
    og = gr[3 * H];
    c = cs[bt * H + tid];
    cp = t > 0 ? round_to(cs[(bt - B) * H + tid], wh) : 0.f;
    up = dhs != nullptr ? static_cast<float>(dhs[bt * H + tid]) : 0.f;
  };
  if (tid < H) {
    const long long o = static_cast<long long>(row) * H + tid;
    dc = dc_last != nullptr ? static_cast<float>(dc_last[o]) : 0.f;
    dhn[tid] = dh_last != nullptr ? static_cast<float>(dh_last[o]) : 0.f;
    load(T - 1);
  }
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    if (tid < H) {
      const float dh = dhn[tid] + up;
      const float tc = tanhf(c);
      dc = fmaf(dh * og, 1.f - tc * tc, dc);
      const float di = dc * gg * ig * (1.f - ig);
      const float df = dc * cp * fg * (1.f - fg);
      const float dg = dc * ig * (1.f - gg * gg);
      const float dout = dh * tc * og * (1.f - og);
      dc *= fg;
      dgs[tid] = di;
      dgs[H + tid] = df;
      dgs[2 * H + tid] = dg;
      dgs[3 * H + tid] = dout;
      float* dr = dgates + (static_cast<long long>(t) * B + row) * G + tid;
      dr[0] = di;
      dr[H] = df;
      dr[2 * H] = dg;
      dr[3 * H] = dout;
      if (t > 0) load(t - 1);
    }
    __syncthreads();  // the step's gate gradients are whole
    if (t > 0) {
      for (int k = warp; k < H; k += warps) {
        const T_* wr = wh + static_cast<long long>(k) * G;
        float a0 = 0.f, a1 = 0.f;
        int n = lane;
        for (; n + 32 < G; n += 64) {
          a0 = fmaf(dgs[n], static_cast<float>(wr[n]), a0);
          a1 = fmaf(dgs[n + 32], static_cast<float>(wr[n + 32]), a1);
        }
        if (n < G) a0 = fmaf(dgs[n], static_cast<float>(wr[n]), a0);
        float a = a0 + a1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane == 0) dhn[k] = a;
      }
    }
    __syncthreads();  // dh_next is whole; the gate gradients are read
  }
}

template <typename T_>
int launch_sequence_bwd(const void* wh, const float* gates, const float* cs,
                        const void* dhs, const void* dh_last,
                        const void* dc_last, float* dgates, int T, int B,
                        int H, cudaStream_t stream) {
  const int threads = std::max(32, (4 * H + 31) / 32 * 32);
  const size_t smem = sizeof(float) * 5 * static_cast<size_t>(H);
  lstm_sequence_bwd_kernel<T_><<<B, threads, smem, stream>>>(
      static_cast<const T_*>(wh), gates, cs, static_cast<const T_*>(dhs),
      static_cast<const T_*>(dh_last), static_cast<const T_*>(dc_last),
      dgates, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wh (H, 4, H) and the upstream gradients dhs (T, B, H), dh_last and
// dc_last (B, H), each of which may be null (a zero gradient), all float32
// (bf16 = 0) or all bfloat16 (bf16 = 1); gates (T, B, 4H) and cs (T, B, H)
// as `repro_lstm_sequence`'s training forward wrote them; dgates (T, B, 4H)
// float32, the gradient of every step's pre-activation gates i, f, g, o.
// Contiguous, on one device; T, B >= 1, 1 <= H <= 256. Returns a
// cudaError_t (0 on success).
extern "C" int repro_lstm_sequence_backward(
    const void* wh, const void* gates, const void* cs, const void* dhs,
    const void* dh_last, const void* dc_last, void* dgates, int T, int B,
    int H, int bf16_inputs, void* stream) {
  if (H < 1 || 4 * H > 1024 || T < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gates);
  const float* c = static_cast<const float*>(cs);
  float* dg = static_cast<float*>(dgates);
  if (bf16_inputs)
    return launch_sequence_bwd<bf16>(wh, g, c, dhs, dh_last, dc_last, dg, T,
                                     B, H, s);
  return launch_sequence_bwd<float>(wh, g, c, dhs, dh_last, dc_last, dg, T,
                                    B, H, s);
}
