// Forward attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by
// `flash_attention` in src/repro/kernels/flash_attention.py. Same function:
//   q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D); K/V head h / (Hq / Hkv) (GQA);
//   queries end-aligned (query i sits at key position Lk - Lq + i);
//   logits = (q . k) * scale, then softcap * tanh(logits / softcap), then
//   the causal (k <= q) and sliding-window (k > q - window) masks;
//   float32 sums; a row with no live key gives 0, as the Pallas kernel's
//   `l == 0 -> 1` does.
//
// What bounds it on an H100: at zamba2's prefill shape (B 4, H 32, L 512,
// D 80, bf16, causal) one call moves ~42 MB (a 12.5 us byte bound) and does
// ~5.4 GFLOP of products (5.4 us on the bf16 tensor cores), so a tuned
// kernel is bound by bytes. This first kernel does the products on the
// float32 CUDA cores (67 TFLOP/s), so it is bound by its own FMAs and the
// shared-memory loads that feed them; tensor cores (mma / wgmma) are the
// next step. What the design does:
//   * one block of 256 threads per (q tile of 64 rows, q head, batch row);
//     the q tile and each 64-key K/V tile are staged once in shared memory
//     as float32, rows padded to D + 1 floats so a column read by 16 rows
//     hits 16 banks;
//   * each thread owns a 4 x 4 patch of the 64 x 64 logits tile and a
//     4-row x ceil(D/16)-column patch of the float32 output accumulator;
//     row max and row sum go across the 16 threads of a row group by warp
//     shuffles; the tile's probabilities pass through shared memory to the
//     P . V product;
//   * the key loop runs only over tiles that hold a live key of the q tile
//     (the causal and window limits), the Pallas kernel's dead-tile skip;
//   * any Lq <= Lk and D <= 256: ragged tiles are masked, not refused.
//
// Plain C entry point, loaded with ctypes. It returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per staged tile
constexpr int THREADS = 256;  // 16 row groups x 16 threads
constexpr int LDP = BK + 1;   // padded row stride of the probability tile
constexpr float NEG_INF = -1e30f;

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

size_t smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) *
         (static_cast<size_t>(BQ + 2 * BK) * ld + static_cast<size_t>(BQ) * LDP);
}

// DC = ceil(D / 16) output columns per thread, a compile-time bound so the
// accumulator stays in registers.
template <typename T, int DC>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Hq,
                     int Hkv, int Lq, int Lk, int D, int causal,
                     int has_window, int window, int has_softcap,
                     float softcap, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;            // BQ x ld
  float* ks = qs + BQ * ld;    // BK x ld
  float* vs = ks + BK * ld;    // BK x ld
  float* ps = vs + BK * ld;    // BQ x LDP

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const int tx = tid & 15;  // keys tx + 16 j; columns tx + 16 c
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q_off = Lk - Lq;

  const T* qb = q + (static_cast<long long>(b) * Hq + h) * Lq * D;
  const T* kb = k + (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  const T* vb = v + (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  T* ob = o + (static_cast<long long>(b) * Hq + h) * Lq * D;

  // staging loops are unrolled so that each thread keeps several loads in
  // flight
#pragma unroll 4
  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e - (e / D) * D;
    qs[r * ld + c] =
        (q0 + r < Lq) ? to_f32(qb[static_cast<long long>(q0 + r) * D + c]) : 0.f;
  }

  // keys that can be live for some row of this tile
  const int q_first = q0 + q_off;
  const int q_last = min(q0 + BQ, Lq) - 1 + q_off;
  int k_begin = 0, k_end = Lk;
  if (causal) k_end = min(Lk, q_last + 1);
  if (has_window) k_begin = max(0, q_first - window + 1);
  k_begin = (k_begin / BK) * BK;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the last tile's readers are done (and qs is staged)
#pragma unroll 4
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e - (e / D) * D;
      const bool in = kt + r < Lk;
      const long long g = static_cast<long long>(kt + r) * D + c;
      ks[r * ld + c] = in ? to_f32(kb[g]) : 0.f;
      vs[r * ld + c] = in ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i + q_off;
      bool live[4];
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kt + tx + 16 * j;
        float x = s[i][j] * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        live[j] = kp < Lk && (!causal || kp <= qp) &&
                  (!has_window || kp > qp - window);
        s[i][j] = live[j] ? x : NEG_INF;
        tmax = fmaxf(tmax, s[i][j]);
      }
      // the 16 threads of a row group are 16 neighbouring lanes
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      alpha[i] = (m[i] == NEG_INF) ? 0.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * LDP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
    }
    __syncthreads();  // the probability tile is whole

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha[i];
    const int kn = min(BK, Lk - kt);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < D ? vs[kk * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D)
        ob[static_cast<long long>(r) * D + col] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Lq, int Lk, int D, int causal, int has_window,
           int window, int has_softcap, float softcap, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, DC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Lq, Lk, D,
      causal, has_window, window, has_softcap, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Lq, int Lk, int D, int causal,
             int has_window, int window, int has_softcap, float softcap,
             float scale, cudaStream_t s) {
  if (D <= 32)
    return launch<T, 2>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, causal,
                        has_window, window, has_softcap, softcap, scale, s);
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, causal,
                        has_window, window, has_softcap, softcap, scale, s);
  if (D <= 80)
    return launch<T, 5>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, causal,
                        has_window, window, has_softcap, softcap, scale, s);
  if (D <= 128)
    return launch<T, 8>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, causal,
                        has_window, window, has_softcap, softcap, scale, s);
  return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, causal, has_window,
                       window, has_softcap, softcap, scale, s);
}

}  // namespace

// q, o (B, Hq, Lq, D); k, v (B, Hkv, Lk, D); all of one dtype (0 float32,
// 1 bfloat16), contiguous, on one device; 1 <= D <= 256, Hq % Hkv == 0,
// Lq <= Lk. `stream` is a cudaStream_t. Returns a cudaError_t (0 on
// success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype, int B,
                                     int Hq, int Hkv, int Lq, int Lk, int D,
                                     int causal, int has_window, int window,
                                     int has_softcap, float softcap,
                                     float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, causal,
                                   has_window, window, has_softcap, softcap,
                                   scale, s);
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, Lq, Lk, D, causal,
                         has_window, window, has_softcap, softcap, scale, s);
}
