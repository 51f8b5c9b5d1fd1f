// Mamba2 selective-state-space scan (one B/C group), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssm_kernel`, launched by `ssm_scan` in
// src/repro/kernels/ssm_scan.py. Same function, in its sequential form
// (the form of `ssm_scan_reference`): per batch row and head, a float32
// state h (P, N) starts at zero and for t = 0 .. L-1
//   h <- exp(dt_t a) h + (dt_t x_t) (x) B_t,     y_t = h C_t + D x_t;
// y is returned in x's dtype and the final h in float32.
//
// What bounds it on an H100: at zamba2's prefill shape (B 4, L 512, H 80,
// P 64, N 64, x/B/C bf16) one call moves ~48 MB (a 14 us byte bound) and
// does ~3.4 GFLOP, so it is bound by bytes; but the recurrence is serial in
// L, so a simple kernel pays the latency of 512 dependent steps, and its
// 2 FMAs per state element and step on the float32 CUDA cores take ~45 us
// even when every SM issues one every cycle. What the design does:
//   * the state stays in registers for the whole sequence: each (head, p)
//     row is split over 4 neighbouring threads of a warp, each holding N/4
//     of its state values (N is a compile-time bound, padded to 16/32/64/
//     128 with zero B and C, which keep the padding at 0); y_t's partial
//     sums meet by two warp shuffles. Four threads per row give the card
//     4x the warps of one thread per row, to hide the latency of each
//     step's dependent FMAs. (The chunked SSD form of the Pallas kernel
//     would need a (T, T, heads) decay tile that does not fit a block's
//     shared memory.)
//   * a block covers 64 consecutive (head, p) rows of one batch row, which
//     lie side by side in x and y, and stages 32 steps of its inputs in
//     shared memory at a time: B_t and C_t (shared by all heads, read as
//     broadcasts, each thread's quarter padded by 4 floats so the 16-byte
//     reads of a warp's 4 quarters hit distinct banks), x_t and dt_t. The
//     step loop waits on no device memory; y_t goes straight out, row
//     after row on neighbouring addresses;
//   * any L, H and P, and N <= 128: nothing has to divide anything.
//
// Plain C entry point, loaded with ctypes. It returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TCH = 32;  // steps staged at a time
constexpr int RB = 64;   // (head, p) rows per block
constexpr int S = 4;     // threads per row
constexpr int THREADS = RB * S;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// padded floats per staged step of B or C: 4 quarters of NS / 4 + 4
__host__ __device__ constexpr int ldb(int ns) { return S * (ns / S + 4); }

size_t smem_bytes(int ns) {
  return sizeof(float) * static_cast<size_t>(TCH) * (2 * ldb(ns) + 2 * RB);
}

// x, y (B, L, H, P); dt (B, L, H) f32; a, d (H,) f32; bm, cm (B, L, N);
// hout (B, H, P, N) f32. Block (64 rows j = h * P + p, batch row); thread
// (row, quarter s), holding state values n = s * NS/4 .. (s+1) * NS/4 - 1.
template <typename T, int NS>
__global__ void __launch_bounds__(THREADS)
    ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ dskip,
                    T* __restrict__ y, float* __restrict__ hout, int L, int H,
                    int P, int N) {
  constexpr int NPT = NS / S;  // state values per thread
  constexpr int LDB = ldb(NS);
  extern __shared__ float4 smem4[];
  float* bs = reinterpret_cast<float*>(smem4);  // TCH x LDB
  float* cs = bs + TCH * LDB;                   // TCH x LDB
  float* xs = cs + TCH * LDB;                   // TCH x RB
  float* ds = xs + TCH * RB;                    // TCH x RB (heads)

  const int tid = threadIdx.x;
  const int r = tid / S, s = tid % S;
  const int b = blockIdx.y;
  const long long hp = static_cast<long long>(H) * P;
  const long long j0 = static_cast<long long>(blockIdx.x) * RB;
  const long long j = j0 + r;
  const bool active = j < hp;
  const int rows_in = static_cast<int>(min(static_cast<long long>(RB), hp - j0));
  const int h_lo = static_cast<int>(j0 / P);
  const int heads_in = static_cast<int>((j0 + rows_in - 1) / P) - h_lo + 1;
  const int h = active ? static_cast<int>(j / P) : h_lo;
  const float ah = a[h];
  const float dh = dskip[h];
  float st[NPT];
#pragma unroll
  for (int i = 0; i < NPT; ++i) st[i] = 0.f;

  const long long xbase = static_cast<long long>(b) * L * hp + j0;
  const long long dbase = static_cast<long long>(b) * L * H + h_lo;
  const long long bbase = static_cast<long long>(b) * L * N;

  for (int t0 = 0; t0 < L; t0 += TCH) {
    const int tn = min(TCH, L - t0);
    __syncthreads();  // the last chunk's readers are done
    // compile-time trip counts, unrolled: each thread's loads are all in
    // flight before the first one is used
#pragma unroll
    for (int i = 0; i < (TCH * NS + THREADS - 1) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      if (e < TCH * NS) {
        const int tt = e / NS, n = e % NS;
        const bool in = tt < tn && n < N;
        const long long g = bbase + static_cast<long long>(t0 + tt) * N + n;
        const int dst = tt * LDB + (n / NPT) * (NPT + 4) + n % NPT;
        bs[dst] = in ? to_f32(bm[g]) : 0.f;
        cs[dst] = in ? to_f32(cm[g]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < TCH * RB / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int tt = e / RB, rr = e % RB;
      const long long t = static_cast<long long>(t0 + tt);
      xs[e] = tt < tn && rr < rows_in ? to_f32(x[xbase + t * hp + rr]) : 0.f;
      ds[e] = tt < tn && rr < heads_in ? dt[dbase + t * H + rr] : 0.f;
    }
    __syncthreads();

    // every thread runs the steps (inactive rows on zeros), so the
    // shuffles see whole warps
    for (int tt = 0; tt < tn; ++tt) {
      const float dtv = ds[tt * RB + (h - h_lo)];
      const float xv = xs[tt * RB + r];
      const float decay = expf(dtv * ah);
      const float dx = xv * dtv;
      const float4* bt = reinterpret_cast<const float4*>(
          bs + tt * LDB + s * (NPT + 4));
      const float4* ct = reinterpret_cast<const float4*>(
          cs + tt * LDB + s * (NPT + 4));
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < NPT / 4; ++q) {
        const float4 bv = bt[q], cv = ct[q];
        st[4 * q] = st[4 * q] * decay + dx * bv.x;
        st[4 * q + 1] = st[4 * q + 1] * decay + dx * bv.y;
        st[4 * q + 2] = st[4 * q + 2] * decay + dx * bv.z;
        st[4 * q + 3] = st[4 * q + 3] * decay + dx * bv.w;
        acc[0] = fmaf(st[4 * q], cv.x, acc[0]);
        acc[1] = fmaf(st[4 * q + 1], cv.y, acc[1]);
        acc[2] = fmaf(st[4 * q + 2], cv.z, acc[2]);
        acc[3] = fmaf(st[4 * q + 3], cv.w, acc[3]);
      }
      float part = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (s == 0 && active)
        y[xbase + static_cast<long long>(t0 + tt) * hp + r] =
            from_f32<T>(part + xv * dh);
    }
  }

  if (!active) return;
  float* ho = hout + (static_cast<long long>(b) * hp + j) * N + s * NPT;
#pragma unroll
  for (int i = 0; i < NPT; ++i)
    if (s * NPT + i < N) ho[i] = st[i];
}

template <typename T, int NS>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* d, void* y, void* hout, int B, int L,
           int H, int P, int N, cudaStream_t stream) {
  const long long rows = static_cast<long long>(H) * P;
  const dim3 grid(static_cast<unsigned>((rows + RB - 1) / RB), B);
  const size_t smem = smem_bytes(NS);
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel<T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_scan_kernel<T, NS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(d),
      static_cast<T*>(y), static_cast<float*>(hout), L, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* a, const void* bm,
             const void* cm, const void* d, void* y, void* hout, int B,
             int L, int H, int P, int N, cudaStream_t s) {
  if (N <= 16) return launch<T, 16>(x, dt, a, bm, cm, d, y, hout, B, L, H, P, N, s);
  if (N <= 32) return launch<T, 32>(x, dt, a, bm, cm, d, y, hout, B, L, H, P, N, s);
  if (N <= 64) return launch<T, 64>(x, dt, a, bm, cm, d, y, hout, B, L, H, P, N, s);
  return launch<T, 128>(x, dt, a, bm, cm, d, y, hout, B, L, H, P, N, s);
}

}  // namespace

// x, y (B, L, H, P) and bm, cm (B, L, N) of one dtype (0 float32,
// 1 bfloat16); dt (B, L, H), a and d (H,), hout (B, H, P, N) float32; all
// contiguous, on one device; L >= 1, 1 <= N <= 128.
// `stream` is a cudaStream_t. Returns a cudaError_t (0 on success).
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, const void* d,
                              void* y, void* hout, int dtype, int B, int L,
                              int H, int P, int N, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, a, bm, cm, d, y, hout, B, L, H, P,
                                   N, s);
  return dispatch<float>(x, dt, a, bm, cm, d, y, hout, B, L, H, P, N, s);
}
