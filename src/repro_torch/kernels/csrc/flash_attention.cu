// Forward attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by
// `flash_attention` in src/repro/kernels/flash_attention.py. Same function:
//   q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D); K/V head h / (Hq / Hkv) (GQA);
//   queries end-aligned (query i sits at key position Lk - Lq + i);
//   logits = (q . k) * scale, then softcap * tanh(logits / softcap), then
//   the causal (k <= q) and sliding-window (k > q - window) masks;
//   float32 running max and sum; a row with no live key gives 0, as the
//   Pallas kernel's `l == 0 -> 1` does; key tiles with no live key are
//   skipped; any Lq, Lk and D <= 256 (ragged tiles are masked). With
//   Lq > Lk the query offset Lk - Lq is negative, as in the Pallas kernel:
//   the start/stop logic below (k_begin, k_end, q_first, q_last, the
//   tile masks) reads signed positions, so a causal tile before key 0
//   stages no key tile and writes zeros, and a non-causal one without a
//   window sees every key.
//
// What bounds it on an H100: at zamba2's prefill shape (B 4, H 32, L 512,
// D 80, bf16, causal) one call moves ~42 MB (a 12.5 us byte bound) and does
// ~5.4 GFLOP of products over the live pairs (5.4 us on the bf16 tensor
// cores), so a tuned kernel is bound by bytes. Two kernels:
//
// bf16 (`flash_bf16_kernel`, serving): FlashAttention-2 on the tensor cores
// with `mma.sync.m16n8k16` (bf16 in, f32 accumulators).
//   * one block of 4 warps per (64-query tile, q head, batch row); each
//     warp owns 16 query rows; the q tiles are the grid's slowest axis,
//     reversed, so the causal triangle's long tiles of every head start
//     first and the short ones fill the tail;
//   * q, and K/V tiles of 64 keys, are staged in shared memory as bf16 by
//     16-byte cp.async copies, K/V double-buffered so tile t+1 loads while
//     tile t computes; rows are padded by 16 bytes so the 8 row addresses
//     of an ldmatrix fall in 8 distinct bank quads;
//   * D is padded with zero columns up to the instantiated width DP (a
//     multiple of 16): zeros change neither q.k nor the written columns;
//   * S = Q.K^T per warp from ldmatrix fragments (Q's kept in registers
//     for DP <= 128); scale, softcap and the masks act on the accumulator
//     fragments, the masks only on tiles that cross the diagonal, the
//     window edge or the end of the keys; the online softmax reduces over
//     the 4 lanes of a quad, in exp2 units;
//   * P is rounded to bf16 in registers and used as the A operand of P.V
//     as it stands (the C layout of two m16n8 tiles is the A layout of one
//     m16n8k16), V's fragments come from ldmatrix.trans; P never touches
//     shared memory;
//   * the output is divided by l (0 -> 1), rounded to bf16, staged in the
//     warp's own q rows and written with 16-byte coalesced stores.
//
// float32 (`flash_f32_kernel`): the CUDA-core kernel. TF32 or bf16
// products could not meet the float32 tolerance of 2e-5, so it keeps full
// float32 FMAs: one block of 256 threads per (64-query tile, q head, batch
// row), q and K/V tiles in shared memory as float32 (rows padded to D + 1
// floats), each thread a 4 x 4 patch of the logits and a 4-row patch of the
// output; probabilities pass through shared memory to P.V.
//
// Plain C entry point, loaded with ctypes. It returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per staged tile
constexpr float NEG_INF = -1e30f;
// the log-sum-exp written for a row with no live key: the backward's
// exp(s - lse) is then 0 there, not NaN. Each kernel has an instance
// that writes it (LSE, the training forward) and one that does not
// (serving), and takes the pointer last, so that the serving instance's
// other parameters keep their offsets and its code is the one it was
// before the training forward existed.
constexpr float LSE_DEAD = INFINITY;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;  // 16 row groups x 16 threads
constexpr int LDP = BK + 1;       // padded row stride of the probability tile

size_t f32_smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) *
         (static_cast<size_t>(BQ + 2 * BK) * ld + static_cast<size_t>(BQ) * LDP);
}

// DC = ceil(D / 16) output columns per thread, a compile-time bound so the
// accumulator stays in registers.
template <int DC, bool LSE>
__global__ void __launch_bounds__(F32_THREADS)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                     int has_window, int window, int has_softcap,
                     float softcap, float scale, float* __restrict__ lse) {
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

  const float* qb = q + (static_cast<long long>(b) * Hq + h) * Lq * D;
  const float* kb = k + (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  const float* vb = v + (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  float* ob = o + (static_cast<long long>(b) * Hq + h) * Lq * D;

  // staging loops are unrolled so that each thread keeps several loads in
  // flight
#pragma unroll 4
  for (int e = tid; e < BQ * D; e += F32_THREADS) {
    const int r = e / D, c = e - (e / D) * D;
    qs[r * ld + c] = (q0 + r < Lq) ? qb[static_cast<long long>(q0 + r) * D + c]
                                   : 0.f;
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
    for (int e = tid; e < BK * D; e += F32_THREADS) {
      const int r = e / D, c = e - (e / D) * D;
      const bool in = kt + r < Lk;
      const long long g = static_cast<long long>(kt + r) * D + c;
      ks[r * ld + c] = in ? kb[g] : 0.f;
      vs[r * ld + c] = in ? vb[g] : 0.f;
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
      if (col < D) ob[static_cast<long long>(r) * D + col] = acc[i][c] / den;
    }
    if (LSE && tx == 0)
      lse[(static_cast<long long>(b) * Hq + h) * Lq + r] =
          l[i] == 0.f ? LSE_DEAD : m[i] + logf(l[i]);
  }
}

template <int DC>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B,
               int Hq, int Hkv, int Lq, int Lk, int D, int causal,
               int has_window, int window, int has_softcap, float softcap,
               float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(D);
  const auto kernel = lse != nullptr ? flash_f32_kernel<DC, true>
                                     : flash_f32_kernel<DC, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Lq + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hkv, Lq, Lk,
      D, causal, has_window, window, has_softcap, softcap, scale, lse);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B,
                 int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                 int has_window, int window, int has_softcap, float softcap,
                 float scale, cudaStream_t s) {
  if (D <= 32)
    return launch_f32<2>(q, k, v, o, lse, B, Hq, Hkv, Lq, Lk, D, causal,
                         has_window, window, has_softcap, softcap, scale, s);
  if (D <= 64)
    return launch_f32<4>(q, k, v, o, lse, B, Hq, Hkv, Lq, Lk, D, causal,
                         has_window, window, has_softcap, softcap, scale, s);
  if (D <= 80)
    return launch_f32<5>(q, k, v, o, lse, B, Hq, Hkv, Lq, Lk, D, causal,
                         has_window, window, has_softcap, softcap, scale, s);
  if (D <= 128)
    return launch_f32<8>(q, k, v, o, lse, B, Hq, Hkv, Lq, Lk, D, causal,
                         has_window, window, has_softcap, softcap, scale, s);
  return launch_f32<16>(q, k, v, o, lse, B, Hq, Hkv, Lq, Lk, D, causal,
                        has_window, window, has_softcap, softcap, scale, s);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 4;                 // 16 query rows each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BQ = 16 * TC_WARPS;        // query rows per block
constexpr float LOG2E = 1.4426950408889634f;

// Staged rows hold DP + 8 bf16 (16 bytes more than DP), so that row r
// starts (DP / 8 + 1) 16-byte units after row r - 1, an odd number: the 8
// rows an ldmatrix reads fall in 8 distinct 16-byte bank quads.
constexpr int TC_PAD = 8;

// Stage ROWS rows of D columns, from row `row0` of `src` (an (L, D) slab),
// into `dst` (row stride DP + TC_PAD); rows at or past `valid` are zero.
// With `vec` (D % 8 == 0, 16-byte aligned slabs) by 16-byte cp.async
// copies, each thread's share of the DP / 8 chunks a row fixed at compile
// time; else by plain loads and stores.
template <int DP, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int valid, int D,
                                           bool vec) {
  constexpr int LD = DP + TC_PAD;
  constexpr int CH = DP / 8;
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < (ROWS * CH + TC_THREADS - 1) / TC_THREADS; ++i) {
      const int slot = tid + i * TC_THREADS;
      const int r = slot / CH, c = (slot - r * CH) * 8;
      if (slot < ROWS * CH && c < D) {
        const bool in = r < valid;
        cp_async16(dst + r * LD + c,
                   in ? src + static_cast<long long>(row0 + r) * D + c : src,
                   in);
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < ROWS * D; e += TC_THREADS) {
      const int r = e / D, c = e - r * D;
      dst[r * LD + c] =
          r < valid ? src[static_cast<long long>(row0 + r) * D + c] : zero;
    }
  }
}

// DP: D padded with zero columns to a multiple of 16.
template <int DP, bool LSE>
__global__ void __launch_bounds__(TC_THREADS)
    flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                      int has_window, int window, int has_softcap,
                      float softcap, float scale, int vec,
                      float* __restrict__ lse) {
  constexpr int LD = DP + TC_PAD;
  constexpr int KSTEPS = DP / 16;  // k-steps of q . k
  constexpr int NT = DP / 8;       // 8-column tiles of the output
  constexpr bool Q_IN_REGS = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // TC_BQ x LD
  bf16* ks = qs + TC_BQ * LD;                    // 2 buffers of BK x LD
  bf16* vs = ks + 2 * BK * LD;                   // 2 buffers of BK x LD

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  // grid (Hq, B, q tiles), q tiles reversed: blocks are dispatched in
  // order of their linear index, so every head's heaviest causal tiles
  // start first and the light ones fill the tail
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;
  const int hk = h / (Hq / Hkv);
  const int q_off = Lk - Lq;

  const bf16* qb = q + (static_cast<long long>(b) * Hq + h) * Lq * D;
  const bf16* kb = k + (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  const bf16* vb = v + (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  bf16* ob = o + (static_cast<long long>(b) * Hq + h) * Lq * D;

  // zero the padding columns [D, DP) of every staged row once; the loads
  // below write only columns < D
  if (D < DP) {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < (TC_BQ + 4 * BK) * (DP - D); e += TC_THREADS) {
      const int r = e / (DP - D);
      qs[r * LD + D + (e - r * (DP - D))] = zero;
    }
  }

  // keys that can be live for some row of this tile
  const int q_first = q0 + q_off;
  const int q_last = min(q0 + TC_BQ, Lq) - 1 + q_off;
  int k_begin = 0, k_end = Lk;
  if (causal) k_end = min(Lk, q_last + 1);
  if (has_window) k_begin = max(0, q_first - window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  stage_rows<DP, TC_BQ>(qs, qb, q0, Lq - q0, D, vec);
  cp_async_commit();
  if (n_tiles > 0) {
    stage_rows<DP, BK>(ks, kb, k_begin, Lk - k_begin, D, vec);
    stage_rows<DP, BK>(vs, vb, k_begin, Lk - k_begin, D, vec);
  }
  cp_async_commit();

  const int wrow = warp * 16;  // the warp's first row in the tile
  // key positions of this lane's two rows, g and g + 8
  const int qp0 = q0 + wrow + g + q_off;
  const int qp1 = qp0 + 8;
  // ldmatrix addresses: lane l gives row (l & 7) of matrix (l >> 3)
  const int lrow = lane & 7, lmat = lane >> 3;
  // A (q): matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15), rows first
  const int a_row = wrow + ((lmat & 1) << 3) + lrow, a_col = (lmat >> 1) << 3;
  // B of q.k^T (k rows are keys): (keys 0-7, d 0-7), (keys 0-7, d 8-15),
  // (keys 8-15, d 0-7), (keys 8-15, d 8-15)
  const int k_row = ((lmat >> 1) << 3) + lrow, k_col = (lmat & 1) << 3;
  // B of p.v, transposed (v rows are keys): (keys 0-7, d 0-7),
  // (keys 8-15, d 0-7), (keys 0-7, d 8-15), (keys 8-15, d 8-15)
  const int v_row = ((lmat & 1) << 3) + lrow, v_col = (lmat >> 1) << 3;

  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of S
  float l_r[2] = {0.f, 0.f};  // this lane's part of the running sum
  // Without softcap (and with scale > 0) the max commutes with the scale:
  // S stays raw and exp2 takes s * sl - m * sl in one FMA. Else S is
  // mapped to log2 units first and sl = 1.
  const bool raw = !has_softcap && scale > 0.f;
  const float sl = raw ? scale * LOG2E : 1.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * BK;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      bf16* kn = ks + (buf ^ 1) * BK * LD;
      bf16* vn = vs + (buf ^ 1) * BK * LD;
      stage_rows<DP, BK>(kn, kb, kt + BK, Lk - kt - BK, D, vec);
      stage_rows<DP, BK>(vn, vb, kt + BK, Lk - kt - BK, D, vec);
      cp_async_commit();
      cp_async_wait<1>();  // q and tile `it` have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kc = ks + buf * BK * LD;
    const bf16* vc = vs + buf * BK * LD;
    if (Q_IN_REGS && it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldmatrix_x4(qf[Q_IN_REGS ? kk : 0],
                    smem_u32(qs + a_row * LD + kk * 16 + a_col));
    }

    // S = Q . K^T: 8 tiles of 8 keys, each 4 floats a lane (rows g, g + 8;
    // keys 2 t4, 2 t4 + 1)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      if (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[Q_IN_REGS ? kk : 0][e];
      } else {
        ldmatrix_x4(a, smem_u32(qs + a_row * LD + kk * 16 + a_col));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk,
                    smem_u32(kc + (np * 16 + k_row) * LD + kk * 16 + k_col));
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    if (!raw) {  // scale and softcap, in log2 units
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e] * scale;
          s[n][e] =
              (has_softcap ? softcap * tanhf(x / softcap) : x) * LOG2E;
        }
    }
    // masks, only on tiles that hold a dead (row, key) pair
    const bool need_mask = kt + BK > Lk ||
                           (causal && kt + BK - 1 > q_first) ||
                           (has_window && kt <= q_last - window);
    if (need_mask) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kt + n * 8 + 2 * t4 + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          const bool live = kp < Lk && (!causal || kp <= qp) &&
                            (!has_window || kp > qp - window);
          if (!live) s[n][e] = -INFINITY;
        }
    }

    // online softmax; a quad's 4 lanes hold one row
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no live key so far keeps -inf; subtract 0 there so
      // its p and alpha come out 0, not NaN
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl;
      alpha[r] = exp2_approx(m_r[r] * sl - mu[r]);
      m_r[r] = mx[r];
    }
    // P in bf16 as the A operand of P . V: k-step j covers key tiles 2j
    // (a0 row g, a1 row g + 8) and 2j + 1 (a2, a3)
    uint32_t pa[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float p0 = exp2_approx(fmaf(s[n][0], sl, -mu[0]));
      const float p1 = exp2_approx(fmaf(s[n][1], sl, -mu[0]));
      const float p2 = exp2_approx(fmaf(s[n][2], sl, -mu[1]));
      const float p3 = exp2_approx(fmaf(s[n][3], sl, -mu[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P . V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, smem_u32(vc + (kk * 16 + v_row) * LD + np * 16 + v_col));
        mma_bf16(oacc[2 * np], pa[kk], bv[0], bv[1]);
        mma_bf16(oacc[2 * np + 1], pa[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();  // tile `it`'s buffers are free for tile it + 2
  }
  cp_async_wait<0>();  // q's copies, when no key tile was live

  // finalize: O / l (0 -> 1) in bf16, staged in the warp's own q rows
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[r] = l == 0.f ? 1.f : l;
    // the row's log-sum-exp of the scaled (softcapped) logits: m_r is in
    // raw units (times scale) or in log2 units (times ln 2)
    const int qr = q0 + wrow + g + 8 * r;
    if (LSE && t4 == 0 && qr < Lq)
      lse[(static_cast<long long>(b) * Hq + h) * Lq + qr] =
          l == 0.f ? LSE_DEAD
                   : m_r[r] * (raw ? scale : 1.f / LOG2E) + logf(l);
  }
  __syncthreads();  // every thread's copies into q's rows have landed
  bf16* os = qs + wrow * LD;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(os + g * LD + col) =
        __floats2bfloat162_rn(oacc[n][0] / den[0], oacc[n][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(os + (g + 8) * LD + col) =
        __floats2bfloat162_rn(oacc[n][2] / den[1], oacc[n][3] / den[1]);
  }
  __syncwarp();
  const int rows = min(16, Lq - (q0 + wrow));
  bf16* orow = ob + static_cast<long long>(q0 + wrow) * D;
  if (vec) {
    const int chunks = D / 8;
    for (int e = lane; e < rows * chunks; e += 32) {
      const int r = e / chunks, c = (e - r * chunks) * 8;
      *reinterpret_cast<uint4*>(orow + static_cast<long long>(r) * D + c) =
          *reinterpret_cast<const uint4*>(os + r * LD + c);
    }
  } else {
    for (int e = lane; e < rows * D; e += 32) {
      const int r = e / D, c = e - r * D;
      orow[static_cast<long long>(r) * D + c] = os[r * LD + c];
    }
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B,
                int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                int has_window, int window, int has_softcap, float softcap,
                float scale, cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(bf16) * static_cast<size_t>(TC_BQ + 4 * BK) * (DP + TC_PAD);
  const auto kernel = lse != nullptr ? flash_bf16_kernel<DP, true>
                                     : flash_bf16_kernel<DP, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                  aligned(o);
  const dim3 grid(Hq, B, (Lq + TC_BQ - 1) / TC_BQ);
  kernel<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hkv, Lq, Lk, D,
      causal, has_window, window, has_softcap, softcap, scale, vec, lse);
  return static_cast<int>(cudaGetLastError());
}

// the padded widths instantiated: D goes to the first that holds it
int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                  int has_window, int window, int has_softcap, float softcap,
                  float scale, cudaStream_t s) {
#define REPRO_FLASH_BF16(DP)                                                  \
  if (D <= DP)                                                              \
    return launch_bf16<DP>(q, k, v, o, lse, B, Hq, Hkv, Lq, Lk, D, causal,  \
                           has_window, window, has_softcap, softcap, scale, \
                           s);
  REPRO_FLASH_BF16(32)
  REPRO_FLASH_BF16(64)
  REPRO_FLASH_BF16(80)
  REPRO_FLASH_BF16(96)
  REPRO_FLASH_BF16(128)
  REPRO_FLASH_BF16(192)
  REPRO_FLASH_BF16(256)
#undef REPRO_FLASH_BF16
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o (B, Hq, Lq, D); k, v (B, Hkv, Lk, D); all of one dtype (0 float32,
// 1 bfloat16), contiguous, on one device; 1 <= D <= 256, Hq % Hkv == 0,
// any Lq, Lk >= 1. lse (B, Hq, Lq) float32 or null: each row's log-sum-exp
// of its scaled (softcapped) live logits, +inf for a row with no live key
// (the training forward; serving passes null). `stream` is a cudaStream_t.
// Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int dtype, int B, int Hq, int Hkv,
                                     int Lq, int Lk, int D, int causal,
                                     int has_window, int window,
                                     int has_softcap, float softcap,
                                     float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1)
    return dispatch_bf16(q, k, v, o, l, B, Hq, Hkv, Lq, Lk, D, causal,
                         has_window, window, has_softcap, softcap, scale, s);
  return dispatch_f32(q, k, v, o, l, B, Hq, Hkv, Lq, Lk, D, causal,
                      has_window, window, has_softcap, softcap, scale, s);
}
