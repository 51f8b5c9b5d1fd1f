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
// activated gates and cell state, and `repro_lstm_sequence_backward` (two
// launches: `lstm_bwd_fused_kernel`, `lstm_bwd_reduce_kernel`) computes the
// whole layer's gradient from them: the chain back through time and the
// products off it (its design note is beside it). The reference has no
// backward kernel: its gradient is JAX's autodiff of the scanned cell.
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

// The backward through time of one layer (`repro_lstm_sequence_backward`),
// whole, in two launches: `lstm_bwd_fused_kernel` (the chain and the
// products off it, one block per batch row) and `lstm_bwd_reduce_kernel`
// (the rows' partial weight gradients summed in a fixed order).
//
// The chain, t = T-1 ... 0, from what the training forward recorded. Per
// step and hidden unit j, with dh = dhs_t + dh_next (+ dh_T at the last
// step) and dc carried (dc_T at the last step),
//   tc = tanh(c_t),   dc += dh o (1 - tc^2),
//   dI = dc g i (1 - i),   dF = dc c_{t-1} f (1 - f),
//   dG = dc i (1 - g^2),   dO = dh tc o (1 - o),   dc <- dc f,
// where c_t is the state before the rounding to the dtype (what tanh read)
// and c_{t-1} the rounded state the forward carried; then
// dh_next = dGates_t . wh^T. Off the chain, from each step's dGates_t:
//   dxs_t = dGates_t . wx^T,   dwx += x_t^T dGates_t,
//   dwh += h_{t-1}^T dGates_t (h_{-1} = 0),   db += dGates_t.
//
// What bounds it: T dependent steps. At the ICU shapes (B = 32, T = 48,
// I <= 76, H <= 32) the whole call moves at most ~2.4 MB and does at most
// ~86 MFLOP (chip_smoke.py's `sequence_bwd_bound`), about a microsecond of
// the card's rates; what is left is the chain's latency and the host's
// launches. So:
//   * the chain, H <= 32 (every ICU shape): lane j owns unit j. It does
//     the unit's gate math (on the special-function unit, `tanh_sfu`; the
//     factors that do not depend on dh are read and formed a step ahead),
//     writes the gate gradients, and after a __syncwarp forms each gate's
//     part of dh_next[j]: a dot over the H units against wh[j][g] in
//     registers, as four sums (one per residue of the unit mod 4, each in
//     order) added pairwise. One warp owns all four gates up to H = 16; at
//     H = 32, a warp per gate, whose parts meet in shared memory under a
//     named barrier of the 128 chain threads (`chain_gate_warps`). The
//     gates' parts are added pairwise, in a fixed order. No block barrier
//     on the chain. H > 32 (up to 256, test shapes only): the gate math by
//     H threads, then dh_next by 8 warps, a unit a warp, lanes striding
//     wh's row (read through L1/L2) and a butterfly; two barriers of the
//     chain's threads a step;
//   * the products run in the same block, behind the chain: the chain
//     writes each chunk of C steps' dGates into a ring of two chunks in
//     shared memory, and 256 consumer threads take each chunk when it is
//     whole: dxs in register tiles of 2 steps x 4 rows of wx (wx staged
//     once in shared memory when it fits), and the row's partial
//     [dwx; dwh; db] (K = I + H + 1 rows of u_t = [x_t, h_{t-1}, 1]) as
//     8 x 8 register tiles of u_t^T dGates_t, accumulated over t in order
//     (t = T-1 ... 0). Where every tile has a thread (every ICU shape) the
//     tiles stay in registers across the chunks, else each chunk adds into
//     the row's slice of the workspace;
//   * the consumers also stage the chain's record (gates, cell states, the
//     upstream dhs) and the products' inputs (x_t, h_{t-1}) one chunk
//     ahead, by cp.async for float32. Named barriers pass the chunks: the
//     record is full (consumers arrive, the chain waits), a chunk's
//     dGates are full (the chain arrives, the consumers wait), a ring slot
//     is free again (consumers arrive, the chain waits);
//   * no atomics: each row writes its own partials (B x KP x GP floats:
//     the K rows padded to 8, the gate columns to HP), which the reduction
//     sums over b = 0 ... B-1 in order, so a second call is bit-equal;
//     dGates never reach device memory.

constexpr int BWD_TC = 8;             // timesteps a chunk, when they fit
constexpr int BWD_CONSUMERS = 256;    // threads of the products
constexpr int BWD_WIDE_CHAIN = 256;   // threads of the chain for H > 32
constexpr size_t BWD_SMEM_CAP = 200 * 1024;

// named barriers (0 is __syncthreads): record full and dGates full, one
// per ring slot; dGates slot free; the consumers alone; the chain alone
enum {
  BAR_REC = 1,
  BAR_DG_FULL = 3,
  BAR_DG_FREE = 5,
  BAR_CONSUMERS = 7,
  BAR_CHAIN = 8
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the producer's half: marks arrival without waiting; the barrier orders
// the arriving threads' shared-memory writes before the waiting threads'
// reads (PTX's producer/consumer pattern)
__device__ __forceinline__ void named_arrive(int id, int threads) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The chain's warps for H <= 32 (HR, the width a lane's dot runs over):
// one warp owns all four gates up to H = 16; at H = 32 one warp holding
// all of wh's row (128 registers) keeps two loads in flight and takes
// about twice as long a step as a warp per gate, whose parts of dh_next
// meet in shared memory; at H = 8 and 16 that meeting costs more than it
// saves (clock64 stamps on an H100, PERF.md). H > 32: 8 warps.
__host__ __device__ constexpr int chain_gate_warps(int hr) {
  return hr == 32 ? 4 : 1;
}
__host__ __device__ constexpr int chain_threads(int hr) {
  return hr > 0 ? 32 * chain_gate_warps(hr) : BWD_WIDE_CHAIN;
}

__host__ __device__ __forceinline__ size_t up4(size_t v) {
  return (v + 3) & ~static_cast<size_t>(3);
}

// The fused kernel's shared memory, in floats: wx (I rows of GP + 4, when
// staged), then two ring slots each of dGates (C x GP), the record's gates
// (C x 4H), cell states (C + 1 steps x H: slot 0 is the state before the
// chunk), dhs (C x H) and u (C x KP), then 256 floats for dh_next. HP is
// the gate width the dGates and the partials are laid out in: the chain's
// 8, 16 or 32, or H rounded up to 4; GP = 4 HP; KP = K rounded up to 8.
struct BwdLayout {
  int hp, gp, kp;
  size_t wx, dg, gates, cs, dhs, u, dhn, total;
  __host__ __device__ BwdLayout(int C, int I, int H, bool stage_wx) {
    hp = H <= 8 ? 8 : H <= 16 ? 16 : H <= 32 ? 32 : (H + 3) & ~3;
    gp = 4 * hp;
    kp = (I + H + 1 + 7) & ~7;
    const size_t c = static_cast<size_t>(C);
    wx = 0;
    dg = stage_wx ? static_cast<size_t>(I) * (gp + 4) : 0;
    gates = dg + 2 * c * gp;
    cs = gates + 2 * c * 4 * H;
    dhs = up4(cs + 2 * (c + 1) * H);
    u = up4(dhs + 2 * c * H);
    dhn = u + 2 * c * kp;
    total = dhn + 256;
  }
};

// the steps of chunk k: t_lo ... t_hi, counted from the end of the sequence
struct Chunk {
  int lo, n;
  __device__ Chunk(int k, int T, int C) {
    const int hi = T - 1 - k * C;
    lo = max(0, hi - C + 1);
    n = hi - lo + 1;
  }
};

__device__ __forceinline__ void stage_elem(float* dst, const float* src) {
  cp_async4(dst, src);
}
__device__ __forceinline__ void stage_elem(float* dst, const bf16* src) {
  *dst = __bfloat162float(*src);
}

// Rows s = 0 ... n-1 of w elements from src + off(s) (off(s) < 0: zeros)
// to dst + s ds, as float32, by threads tid, tid + threads, ...: float32
// by cp.async (not waited for), 16 bytes at a time where the rows allow.
template <typename S, typename Off>
__device__ __forceinline__ void stage_rows(float* dst, int ds, const S* src,
                                           int n, int w, const Off& off,
                                           int tid, int threads) {
  const bool v4 = std::is_same<S, float>::value && (w & 3) == 0 &&
                  (ds & 3) == 0 &&
                  ((reinterpret_cast<uintptr_t>(src) |
                    reinterpret_cast<uintptr_t>(dst)) &
                   15) == 0;
  if (v4) {
    const int w4 = w >> 2;
    for (int e = tid; e < n * w4; e += threads) {
      const int s = e / w4, q = 4 * (e - s * w4);
      const long long o = off(s);
      float* d = dst + s * ds + q;
      if (o >= 0)
        cp_async16(d, reinterpret_cast<const float*>(src) + o + q);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = tid; e < n * w; e += threads) {
      const int s = e / w, q = e - s * w;
      const long long o = off(s);
      if (o >= 0)
        stage_elem(dst + s * ds + q, src + o + q);
      else
        dst[s * ds + q] = 0.f;
    }
  }
}

// HR: the width of a chain lane's dot (8, 16 or 32, at least H), or 0 for
// the block-wide chain. xs (T, B, I), wx (I, 4, H), wh (H, 4, H), hs (T, B, H),
// dhs (T, B, H) or null, dh_last, dc_last (B, H) or null, dxs (T, B, I) or
// null (not wanted), all of type T_; gates (T, B, 4H) and cs (T, B, H)
// float32, as the training forward wrote them; ws (B, KP, GP) float32, the
// rows' partials. C steps a chunk.
template <int HR, typename T_>
__global__ void __launch_bounds__(chain_threads(HR) + BWD_CONSUMERS, 1)
    lstm_bwd_fused_kernel(const T_* __restrict__ xs,
                          const T_* __restrict__ wx,
                          const T_* __restrict__ wh,
                          const T_* __restrict__ hs,
                          const float* __restrict__ gates,
                          const float* __restrict__ cs,
                          const T_* __restrict__ dhs,
                          const T_* __restrict__ dh_last,
                          const T_* __restrict__ dc_last,
                          T_* __restrict__ dxs, float* __restrict__ ws,
                          int T, int B, int I, int H, int C, int stage_wx) {
  constexpr int GW = chain_gate_warps(HR);  // the chain's warps, H <= 32
  constexpr int GPW = 4 / GW;                // the gates each of them owns
  constexpr int WR = HR > 0 ? HR : 1;
  constexpr int NCH = chain_threads(HR);
  constexpr int NC = BWD_CONSUMERS;
  constexpr int NALL = NCH + NC;
  extern __shared__ __align__(16) float bwd_smem[];
  const BwdLayout lay(C, I, H, stage_wx);
  const int HP = HR > 0 ? HR : lay.hp, GP = 4 * HP, KP = lay.kp, G = 4 * H;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int chunks = (T + C - 1) / C;
  float* const sdg = bwd_smem + lay.dg;
  float* const sgates = bwd_smem + lay.gates;
  float* const scs = bwd_smem + lay.cs;
  float* const sdhs = bwd_smem + lay.dhs;
  float* const su = bwd_smem + lay.u;

  // dGates' pad columns stay 0; u's column I + H is 1 (db's row), its pad
  // columns 0, in both slots; wx in gate columns of HP, zero-padded
  for (int e = tid; e < 2 * C * GP; e += NALL) sdg[e] = 0.f;
  for (int e = tid; e < 2 * C * KP; e += NALL)
    su[e] = e % KP == I + H ? 1.f : 0.f;
  if (stage_wx && HP == H) {
    stage_rows(bwd_smem + lay.wx, GP + 4, wx, I, G,
               [&](int k) { return static_cast<long long>(k) * G; }, tid,
               NALL);
    cp_async_wait_all();
  } else if (stage_wx) {
    for (int e = tid; e < I * GP; e += NALL) {
      const int k = e / GP, n = e - k * GP, g = n / HP, m = n - g * HP;
      bwd_smem[lay.wx + static_cast<size_t>(k) * (GP + 4) + n] =
          m < H ? static_cast<float>(wx[static_cast<long long>(k) * G +
                                        g * H + m])
                : 0.f;
    }
  }
  __syncthreads();

  if (tid < NCH) {
    // ------------------------------------------------------------ the chain
    // H <= 32: lane j owns unit j in each of the GW warps, warp gw gates
    // gw GPW ... gw GPW + GPW - 1; H > 32: thread j owns unit j
    const int lane = tid & 31, gw = tid >> 5;
    const int j = HR > 0 ? lane : tid;
    const int g0 = HR > 0 && GW > 1 ? gw * GPW : 0;  // this warp's gates
    float dc = 0.f;
    float dhn = 0.f;                  // H <= 32: dh_next[j]
    // H <= 32, GW = 4: two step-parities of the four gates' parts of
    // dh_next (2 x 4 x 32); H > 32: dh_next
    float* const sdhn = bwd_smem + lay.dhn;
    float w[GPW][WR];                 // H <= 32: wh[j][g][0 ... HR), own g
    if (j < H) {
      const long long o = static_cast<long long>(row) * H + j;
      dc = dc_last != nullptr ? static_cast<float>(dc_last[o]) : 0.f;
      dhn = dh_last != nullptr ? static_cast<float>(dh_last[o]) : 0.f;
      if (HR == 0) sdhn[j] = dhn;
    }
    if (HR > 0) {
#pragma unroll
      for (int q = 0; q < GPW; ++q)
#pragma unroll
        for (int m = 0; m < WR; ++m)
          w[q][m] = j < H && m < H
                        ? static_cast<float>(
                              wh[(static_cast<long long>(j) * 4 + g0 + q) * H + m])
                        : 0.f;
    } else {
      named_sync(BAR_CHAIN, NCH);
    }
    int par = 0;
    for (int k = 0; k < chunks; ++k) {
      const int p = k & 1;
      const Chunk ch(k, T, C);
      const float* rg = sgates + static_cast<size_t>(p) * C * G;
      const float* rc = scs + static_cast<size_t>(p) * (C + 1) * H;
      const float* rd = sdhs + static_cast<size_t>(p) * C * H;
      float* dg = sdg + static_cast<size_t>(p) * C * GP;
      named_sync(BAR_REC + p, NALL);
      if (k >= 2) named_sync(BAR_DG_FREE + p, NALL);
      // step s's factors of the gate gradients, which do not depend on dh:
      // read and formed a step ahead, off the chain
      float fi = 0.f, ff = 0.f, fgg = 0.f, fo = 0.f, fc = 0.f, fg = 0.f,
            up = 0.f;
      const auto factors = [&](int s) {
        const float* gr = rg + static_cast<size_t>(s) * G + j;
        const float ig = gr[0], f = gr[H], gg = gr[2 * H], og = gr[3 * H];
        const float tc = tanh_sfu(rc[(s + 1) * H + j]);
        const float cp = round_to(rc[s * H + j], wh);
        up = rd[s * H + j];
        fc = og * (1.f - tc * tc);
        fi = gg * ig * (1.f - ig);
        ff = cp * f * (1.f - f);
        fgg = ig * (1.f - gg * gg);
        fo = tc * og * (1.f - og);
        fg = f;
      };
      if (j < H) factors(ch.n - 1);
      for (int s = ch.n - 1; s >= 0; --s) {
        float* dr = dg + static_cast<size_t>(s) * GP;
        if (j < H) {
          const float dh = (HR > 0 ? dhn : sdhn[j]) + up;
          dc = fmaf(dh, fc, dc);
          const auto grad = [&](int g) {
            return g == 0 ? dc * fi : g == 1 ? dc * ff : g == 2 ? dc * fgg
                                                                : dh * fo;
          };
#pragma unroll
          for (int q = 0; q < (HR > 0 ? GPW : 4); ++q)
            dr[(g0 + q) * HP + j] = grad(g0 + q);
          dc *= fg;
          if (HR == 0 && s > 0) factors(s - 1);
        }
        if (HR > 0) {
          __syncwarp();  // this warp's gates' gradients are whole
          if (j < H && s > 0) factors(s - 1);
          // gate g's part of dh_next[j]: four sums over the units m of one
          // residue mod 4, each in order, summed pairwise
          float a[GPW][4] = {};
#pragma unroll
          for (int m = 0; m < WR; m += 4)
#pragma unroll
            for (int q = 0; q < GPW; ++q) {
              const float4 v = *reinterpret_cast<const float4*>(
                  dr + (g0 + q) * HP + m);
              a[q][0] = fmaf(v.x, w[q][m], a[q][0]);
              a[q][1] = fmaf(v.y, w[q][m + 1], a[q][1]);
              a[q][2] = fmaf(v.z, w[q][m + 2], a[q][2]);
              a[q][3] = fmaf(v.w, w[q][m + 3], a[q][3]);
            }
          float part[GPW];
#pragma unroll
          for (int q = 0; q < GPW; ++q)
            part[q] = (a[q][0] + a[q][1]) + (a[q][2] + a[q][3]);
          if (GW == 1) {
            dhn = (part[0] + part[GPW > 1 ? 1 : 0]) +
                  (part[GPW > 2 ? 2 : 0] + part[GPW > 3 ? 3 : 0]);
          } else {
            float* x = sdhn + par * 128;
            x[gw * 32 + lane] = part[0];
            named_sync(BAR_CHAIN, NCH);  // the four gates' parts are whole
            dhn = (x[lane] + x[32 + lane]) + (x[64 + lane] + x[96 + lane]);
            par ^= 1;
          }
        } else {
          named_sync(BAR_CHAIN, NCH);  // the step's gate gradients are whole
          for (int u = gw; u < H; u += NCH / 32) {
            const T_* wr = wh + static_cast<long long>(u) * G;
            float a = 0.f;
            for (int g = 0; g < 4; ++g)
              for (int m = lane; m < H; m += 32)
                a = fmaf(dr[g * HP + m], static_cast<float>(wr[g * H + m]),
                         a);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              a += __shfl_xor_sync(0xffffffffu, a, off);
            if (lane == 0) sdhn[u] = a;
          }
          named_sync(BAR_CHAIN, NCH);  // dh_next is whole
        }
      }
      named_arrive(BAR_DG_FULL + p, NALL);
    }
    return;
  }

  // -------------------------------------------------------- the consumers
  const int ctid = tid - NCH;
  // chunk k's record and u into ring slot k & 1; its copies are waited for
  // by the caller
  const auto stage = [&](int k) {
    const int p = k & 1;
    const Chunk ch(k, T, C);
    const long long rows = static_cast<long long>(B);
    float* ru = su + static_cast<size_t>(p) * C * KP;
    stage_rows(sgates + static_cast<size_t>(p) * C * G, G, gates, ch.n, G,
               [&](int s) { return ((ch.lo + s) * rows + row) * G; }, ctid,
               NC);
    stage_rows(scs + static_cast<size_t>(p) * (C + 1) * H, H, cs, ch.n + 1, H,
               [&](int s) {
                 const int t = ch.lo - 1 + s;
                 return t >= 0 ? (t * rows + row) * H : -1LL;
               },
               ctid, NC);
    stage_rows(sdhs + static_cast<size_t>(p) * C * H, H, dhs, ch.n, H,
               [&](int s) {
                 return dhs != nullptr ? ((ch.lo + s) * rows + row) * H : -1LL;
               },
               ctid, NC);
    stage_rows(ru, KP, xs, ch.n, I,
               [&](int s) { return ((ch.lo + s) * rows + row) * I; }, ctid,
               NC);
    stage_rows(ru + I, KP, hs, ch.n, H,
               [&](int s) {
                 const int t = ch.lo + s;
                 return t > 0 ? ((t - 1) * rows + row) * H : -1LL;
               },
               ctid, NC);
  };

  // [dwx; dwh; db]'s partial: 8 x 8 tiles, rows {4rt..+3, KP/2 + 4rt..+3},
  // columns {4ct..+3, GP/2 + 4ct..+3}
  const int col_tiles = GP / 8, tiles = (KP / 8) * col_tiles;
  const bool resident = tiles <= NC;
  float* const wsr = ws + static_cast<long long>(row) * KP * GP;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const auto tile_rows = [&](int tile, int i) {
    return (i < 4 ? 0 : KP / 2 - 4) + 4 * (tile / col_tiles) + i;
  };
  const auto tile_col = [&](int tile, int half) {
    return half * (GP / 2) + 4 * (tile % col_tiles);
  };
  const auto store_tile = [&](int tile) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(wsr +
                                   static_cast<size_t>(tile_rows(tile, i)) *
                                       GP +
                                   tile_col(tile, h)) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
  };
  const int kq_n = (I + 3) / 4;  // dxs: rows kq + j kq_n of wx, j < 4

  stage(0);
  cp_async_wait_all();
  named_arrive(BAR_REC, NALL);
  for (int k = 0; k < chunks; ++k) {
    const int p = k & 1;
    const Chunk ch(k, T, C);
    const bool next = k + 1 < chunks;
    if (next) {
      named_sync(BAR_CONSUMERS, NC);  // slot p ^ 1's u is read
      stage(k + 1);  // in flight while the chain walks chunk k
    }
    named_sync(BAR_DG_FULL + p, NALL);
    if (next) {
      cp_async_wait_all();
      named_arrive(BAR_REC + (p ^ 1), NALL);
    }
    const float* dg = sdg + static_cast<size_t>(p) * C * GP;
    const float* ru = su + static_cast<size_t>(p) * C * KP;

    // dxs_t = dGates_t . wx^T: 2 steps x 4 rows a thread, over n in order
    if (dxs != nullptr) {
      for (int tile = ctid; tile < (ch.n + 1) / 2 * kq_n; tile += NC) {
        const int s0 = 2 * (tile / kq_n), kq = tile % kq_n;
        const float* d0 = dg + static_cast<size_t>(s0) * GP;
        const float* d1 = dg + static_cast<size_t>(min(s0 + 1, ch.n - 1)) * GP;
        float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if (stage_wx) {
          const float* wr[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wr[j] = bwd_smem + lay.wx +
                    static_cast<size_t>(min(kq + j * kq_n, I - 1)) * (GP + 4);
#pragma unroll 2
          for (int n = 0; n < GP; n += 4) {
            const float4 a = *reinterpret_cast<const float4*>(d0 + n);
            const float4 b = *reinterpret_cast<const float4*>(d1 + n);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 v = *reinterpret_cast<const float4*>(wr[j] + n);
              o[0][j] = fmaf(a.x, v.x, o[0][j]);
              o[0][j] = fmaf(a.y, v.y, o[0][j]);
              o[0][j] = fmaf(a.z, v.z, o[0][j]);
              o[0][j] = fmaf(a.w, v.w, o[0][j]);
              o[1][j] = fmaf(b.x, v.x, o[1][j]);
              o[1][j] = fmaf(b.y, v.y, o[1][j]);
              o[1][j] = fmaf(b.z, v.z, o[1][j]);
              o[1][j] = fmaf(b.w, v.w, o[1][j]);
            }
          }
        } else {
          for (int n = 0; n < GP; ++n) {
            const int g = n / HP, m = n - g * HP;
            if (m >= H) continue;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float v = static_cast<float>(
                  wx[static_cast<long long>(min(kq + j * kq_n, I - 1)) * G +
                     g * H + m]);
              o[0][j] = fmaf(d0[n], v, o[0][j]);
              o[1][j] = fmaf(d1[n], v, o[1][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + i, kk = kq + j * kq_n;
            if (s < ch.n && kk < I)
              store_as(dxs + (static_cast<long long>(ch.lo + s) * B + row) *
                                 I +
                           kk,
                       o[i][j]);
          }
      }
    }

    // the row's partial += u_t^T dGates_t, t descending
    for (int tile = ctid; tile < tiles; tile += NC) {
      if (!resident) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (k > 0)
              v = *reinterpret_cast<const float4*>(
                  wsr + static_cast<size_t>(tile_rows(tile, i)) * GP +
                  tile_col(tile, h));
            acc[i][4 * h] = v.x;
            acc[i][4 * h + 1] = v.y;
            acc[i][4 * h + 2] = v.z;
            acc[i][4 * h + 3] = v.w;
          }
      }
      const int r0 = tile_rows(tile, 0), r1 = tile_rows(tile, 4);
      const int n0 = tile_col(tile, 0), n1 = tile_col(tile, 1);
#pragma unroll 2
      for (int s = ch.n - 1; s >= 0; --s) {
        const float* us = ru + static_cast<size_t>(s) * KP;
        const float* ds = dg + static_cast<size_t>(s) * GP;
        const float4 u0 = *reinterpret_cast<const float4*>(us + r0);
        const float4 u1 = *reinterpret_cast<const float4*>(us + r1);
        const float4 e0 = *reinterpret_cast<const float4*>(ds + n0);
        const float4 e1 = *reinterpret_cast<const float4*>(ds + n1);
        const float uu[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
        const float dd[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(uu[i], dd[j], acc[i][j]);
      }
      if (!resident) store_tile(tile);
    }
    if (k + 2 < chunks) named_arrive(BAR_DG_FREE + p, NALL);
  }
  if (resident && ctid < tiles) store_tile(ctid);
}

// dwx (I, 4, H), dwh (H, 4, H), db (4, H) in T_: the rows' partials summed
// over b = 0 ... B-1 in order, one thread an entry
template <typename T_>
__global__ void lstm_bwd_reduce_kernel(const float* __restrict__ ws,
                                       T_* __restrict__ dwx,
                                       T_* __restrict__ dwh,
                                       T_* __restrict__ db, int B, int I,
                                       int H, int KP, int GP, int HP) {
  const int G = 4 * H;
  const long long entries = static_cast<long long>(I + H + 1) * G;
  const long long row_stride = static_cast<long long>(KP) * GP;
  for (long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       o < entries; o += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(o / G), n = static_cast<int>(o % G);
    const int g = n / H, m = n - g * H;
    const float* p = ws + static_cast<long long>(r) * GP + g * HP + m;
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += p[b * row_stride];
    if (r < I)
      store_as(dwx + o, acc);
    else if (r < I + H)
      store_as(dwh + (o - static_cast<long long>(I) * G), acc);
    else
      store_as(db + n, acc);
  }
}

template <typename T_>
int launch_sequence_bwd(const void* xs, const void* wx, const void* wh,
                        const void* hs, const float* gates, const float* cs,
                        const void* dhs, const void* dh_last,
                        const void* dc_last, void* dxs, void* dwx, void* dwh,
                        void* db, float* ws, int T, int B, int I, int H,
                        int C, bool stage_wx, size_t smem,
                        cudaStream_t stream) {
  const auto kernel = H <= 8    ? lstm_bwd_fused_kernel<8, T_>
                      : H <= 16 ? lstm_bwd_fused_kernel<16, T_>
                      : H <= 32 ? lstm_bwd_fused_kernel<32, T_>
                                : lstm_bwd_fused_kernel<0, T_>;
  const int threads =
      chain_threads(H <= 8 ? 8 : H <= 16 ? 16 : H <= 32 ? 32 : 0) +
      BWD_CONSUMERS;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, threads, smem, stream>>>(
      static_cast<const T_*>(xs), static_cast<const T_*>(wx),
      static_cast<const T_*>(wh), static_cast<const T_*>(hs), gates, cs,
      static_cast<const T_*>(dhs), static_cast<const T_*>(dh_last),
      static_cast<const T_*>(dc_last), static_cast<T_*>(dxs), ws, T, B, I, H,
      C, stage_wx);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdLayout lay(C, I, H, stage_wx);
  const long long entries = static_cast<long long>(I + H + 1) * 4 * H;
  const int blocks = static_cast<int>(
      std::min<long long>((entries + 255) / 256, 4096));
  lstm_bwd_reduce_kernel<T_><<<blocks, 256, 0, stream>>>(
      ws, static_cast<T_*>(dwx), static_cast<T_*>(dwh), static_cast<T_*>(db),
      B, I, H, lay.kp, lay.gp, lay.hp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The floats of the workspace `repro_lstm_sequence_backward` takes:
// B x KP x GP (the rows' partial weight gradients).
extern "C" long long repro_lstm_sequence_backward_workspace(int B, int I,
                                                            int H) {
  const BwdLayout lay(1, I, H, false);
  return static_cast<long long>(B) * lay.kp * lay.gp;
}

// xs (T, B, I); wx (I, 4, H); wh (H, 4, H); hs (T, B, H); the upstream
// gradients dhs (T, B, H), dh_last and dc_last (B, H), each of which may be
// null (a zero gradient); gates (T, B, 4H) and cs (T, B, H) float32 as
// `repro_lstm_sequence`'s training forward wrote them. Writes dxs (T, B,
// I; null: not computed), dwx, dwh and db (4, H). All but gates, cs and ws
// float32 (bf16 = 0) or all bfloat16 (bf16 = 1); contiguous, on one
// device; T, B, I >= 1, 1 <= H <= 256. ws: `ws_floats` float32 of
// scratch, at least `repro_lstm_sequence_backward_workspace(B, I, H)`. Two
// launches on `stream` (a cudaStream_t). Returns a cudaError_t (0 on
// success).
extern "C" int repro_lstm_sequence_backward(
    const void* xs, const void* wx, const void* wh, const void* hs,
    const void* gates, const void* cs, const void* dhs, const void* dh_last,
    const void* dc_last, void* dxs, void* dwx, void* dwh, void* db, void* ws,
    long long ws_floats, int T, int B, int I, int H, int bf16_inputs,
    void* stream) {
  if (H < 1 || H > 256 || T < 1 || B < 1 || I < 1 ||
      ws_floats < repro_lstm_sequence_backward_workspace(B, I, H))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto bytes = [&](int c, bool stage) {
    return BwdLayout(c, I, H, stage).total * sizeof(float);
  };
  // wx is staged (for dxs) when it takes at most half the cap; the chunk is
  // BWD_TC steps, or the most that fit
  const bool stage_wx = dxs != nullptr && bytes(0, true) <= BWD_SMEM_CAP / 2;
  int C = std::min(BWD_TC, T);
  while (C > 1 && bytes(C, stage_wx) > BWD_SMEM_CAP) --C;
  if (bytes(C, stage_wx) > BWD_SMEM_CAP)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bytes(C, stage_wx);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gates);
  const float* c = static_cast<const float*>(cs);
  float* w = static_cast<float*>(ws);
  if (bf16_inputs)
    return launch_sequence_bwd<bf16>(xs, wx, wh, hs, g, c, dhs, dh_last,
                                     dc_last, dxs, dwx, dwh, db, w, T, B, I,
                                     H, C, stage_wx, smem, s);
  return launch_sequence_bwd<float>(xs, wx, wh, hs, g, c, dhs, dh_last,
                                    dc_last, dxs, dwx, dwh, db, w, T, B, I, H,
                                    C, stage_wx, smem, s);
}
