// The backward of flash attention, for Hopper (sm_90a), float32 or
// bfloat16 inputs with float32 math.
//
// The gradient of `repro_flash_attention` (flash_attention.cu), which
// replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py. The reference has no backward
// kernel: it trains through JAX's autodiff of its attention. This is the
// gradient of exactly what the forward computes: GQA (K/V head h / group),
// end-aligned queries (q_offset = Lk - Lq, negative for Lq > Lk), the
// causal (k <= q) and window (k > q - window) masks, the tanh softcap
// s = c tanh(s0 / c) of s0 = scale q.k, and 0 for a row with no live key.
// With the forward's row log-sum-exp L (+inf for a row with no live key),
//   P = exp(s - L) on live pairs, 0 elsewhere;   D_i = sum_d dO_id O_id;
//   dV = P^T dO;   dP = dO V^T;   dS = P (dP - D);
//   dS0 = dS (1 - (s / c)^2) scale   (without softcap: dS scale);
//   dQ = dS0 K;   dK = dS0^T Q,
// FlashAttention-2's order, in three launches:
//   1. `flash_bwd_dot_kernel`: D, one warp per query row;
//   2. `flash_bwd_dkdv_kernel`: one block per (key tile, K/V head, batch
//      row), which loops over the group's Hq / Hkv query heads and their
//      query tiles that can see a key of the tile, dK and dV summed in
//      registers, so GQA needs no atomics;
//   3. `flash_bwd_dq_kernel`: one block per (64-query tile, q head, batch
//      row), which loops over the key tiles the forward visits.
//
// What bounds it on an H100: at qwen2-1.5b's training shape (B 8, Hq 12,
// Hkv 2, L 1024, D 128, causal, bf16) one call reads q, k, v, O, dO and
// writes dq, dk, dv, ~118 MB (35 us at 3.35 TB/s), and does 2.5 times the
// forward's products over the live pairs, ~65 GFLOP (66 us at the bf16
// tensor-core rate): bound by operations. Two designs, by dtype:
//
// bf16, D <= 128 (training): the products on the tensor cores with
// `mma.sync.m16n8k16` (bf16 in, float32 sums), as the forward's bf16
// kernel (csrc/mma_bf16.cuh): blocks of 4 warps, each warp 16 rows (keys
// in dK/dV, queries in dQ) against tiles of 64 of the other side staged
// in shared memory as bf16 by cp.async (rows padded by 16 bytes, D padded
// with zero columns to DP); S and dP per warp from ldmatrix fragments, P
// and dS rounded to bf16 in registers and used as the A operand of the
// next products as they stand (the C layout of two m16n8 tiles is the A
// layout of one m16n8k16), the other operand by ldmatrix.trans; the dK,
// dV and dQ sums stay in registers. No double buffering, no wgmma yet.
//
// float32 (and bf16 above D = 128): every product on the CUDA cores in
// float32 (TF32 or bf16 products could not meet the float32 tolerance),
// tiles staged as float32 (rows padded to D + 1 floats), 256 threads a
// block, each thread a 4-row x KR-key patch of S and dP and a KR-key (or
// 4-row) x DC-column patch of the sums; P and dS pass through shared
// memory.
//
// Plain C entry point, loaded with ctypes; it returns the first
// cudaGetLastError() that is not 0, so a refused launch is reported.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 16 row groups x 16 threads
constexpr int BQ = 64;        // query rows per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// D_i = sum_d dO_id O_id for `rows` rows of D values
template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ delta,
                                     long long rows, int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(to_f32(o[row * D + c]), to_f32(dout[row * D + c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// Stage `rows` rows of D columns, from row `row0` of `src` (an (L, D)
// slab), into `dst` as float32 with row stride D + 1; rows at or past
// `valid` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int valid, int rows, int D) {
  const int ld = D + 1;
#pragma unroll 4
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    dst[r * ld + c] =
        r < valid ? to_f32(src[static_cast<long long>(row0 + r) * D + c]) : 0.f;
  }
}

struct Masks {
  int Lq, Lk, q_off, causal, has_window, window, has_softcap;
  float softcap, scale;
};

// For the staged tiles qs, dos (BQ query rows from q0) and ks, vs (16 KR
// keys from k0): P and dS0 of the thread's 4 rows (ty * 4 + i) x KR keys
// (tx + 16 j), written to ps (when given) and dss, row stride 16 KR + 1.
// lse_s and del_s hold the tile's rows' log-sum-exp and D.
template <int KR>
__device__ __forceinline__ void tile_scores(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* del_s, float* ps, float* dss, int q0,
    int k0, int D, const Masks& mk) {
  constexpr int LDS = 16 * KR + 1;
  const int ld = D + 1;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float s[4][KR], dp[4][KR];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < KR; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qv[4], ov[4], kv[KR], vv[KR];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty * 4 + i) * ld + c];
      ov[i] = dos[(ty * 4 + i) * ld + c];
    }
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      kv[j] = ks[(tx + 16 * j) * ld + c];
      vv[j] = vs[(tx + 16 * j) * ld + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KR; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qp = q0 + r + mk.q_off;
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      const int kp = k0 + tx + 16 * j;
      const bool live = q0 + r < mk.Lq && kp < mk.Lk &&
                        (!mk.causal || kp <= qp) &&
                        (!mk.has_window || kp > qp - mk.window);
      const float x = s[i][j] * mk.scale;
      const float sn = mk.has_softcap ? mk.softcap * tanhf(x / mk.softcap) : x;
      const float p = live ? expf(sn - lse_s[r]) : 0.f;
      float ds = p * (dp[i][j] - del_s[r]);
      if (mk.has_softcap) {
        const float t = sn / mk.softcap;
        ds *= 1.f - t * t;
      }
      if (ps != nullptr) ps[r * LDS + tx + 16 * j] = p;
      dss[r * LDS + tx + 16 * j] = ds * mk.scale;
    }
  }
}

// KR: keys per thread in the scores (the key tile is 16 KR); DC: columns
// of D per thread (tx + 16 c), a compile-time bound so the sums stay in
// registers.
template <typename T, int KR, int DC>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int Hq, int Hkv, int D, Masks mk) {
  constexpr int BK = 16 * KR;
  constexpr int LDS = BK + 1;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* ks = smem;                 // BK x ld
  float* vs = ks + BK * ld;         // BK x ld
  float* qs = vs + BK * ld;         // BQ x ld
  float* dos = qs + BQ * ld;        // BQ x ld
  float* ps = dos + BQ * ld;        // BQ x LDS
  float* dss = ps + BQ * LDS;       // BQ x LDS
  float* lse_s = dss + BQ * LDS;    // BQ
  float* del_s = lse_s + BQ;        // BQ

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int Lq = mk.Lq, Lk = mk.Lk;
  const long long kv_off = (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  stage(ks, k + kv_off, k0, Lk - k0, BK, D);
  stage(vs, v + kv_off, k0, Lk - k0, BK, D);

  // query rows that see a key of this tile
  const int k_last = min(k0 + BK, Lk) - 1;
  int q_begin = mk.causal ? max(0, k0 - mk.q_off) : 0;
  const int q_end = mk.has_window ? min(Lq, k_last + mk.window - mk.q_off) : Lq;
  q_begin = (q_begin / BQ) * BQ;

  float dka[KR][DC], dva[KR][DC];
#pragma unroll
  for (int r = 0; r < KR; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[r][c] = dva[r][c] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const long long row0 = (static_cast<long long>(b) * Hq + hk * group + hh) * Lq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the last tile's readers are done
      stage(qs, q + row0 * D, q0, Lq - q0, BQ, D);
      stage(dos, dout + row0 * D, q0, Lq - q0, BQ, D);
      for (int e = tid; e < BQ; e += THREADS) {
        const bool in = q0 + e < Lq;
        lse_s[e] = in ? lse[row0 + q0 + e] : INFINITY;
        del_s[e] = in ? delta[row0 + q0 + e] : 0.f;
      }
      __syncthreads();
      tile_scores<KR>(qs, dos, ks, vs, lse_s, del_s, ps, dss, q0, k0, D, mk);
      __syncthreads();  // P and dS are whole
      // dV += P^T dO and dK += dS0^T Q for the thread's keys ty * KR + r
      const int rows = min(BQ, Lq - q0);
#pragma unroll 2
      for (int i = 0; i < rows; ++i) {
        float pv[KR], sv[KR], ov[DC], qv[DC];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          pv[r] = ps[i * LDS + ty * KR + r];
          sv[r] = dss[i * LDS + ty * KR + r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int col = tx + 16 * c;
          ov[c] = col < D ? dos[i * ld + col] : 0.f;
          qv[c] = col < D ? qs[i * ld + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < KR; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dva[r][c] = fmaf(pv[r], ov[c], dva[r][c]);
            dka[r][c] = fmaf(sv[r], qv[c], dka[r][c]);
          }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int key = k0 + ty * KR + r;
    if (key >= Lk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        const long long o = kv_off + static_cast<long long>(key) * D + col;
        store_as(dk + o, dka[r][c]);
        store_as(dv + o, dva[r][c]);
      }
    }
  }
}

template <typename T, int KR, int DC>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv,
    int D, Masks mk) {
  constexpr int BK = 16 * KR;
  constexpr int LDS = BK + 1;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;                 // BQ x ld
  float* dos = qs + BQ * ld;        // BQ x ld
  float* ks = dos + BQ * ld;        // BK x ld
  float* vs = ks + BK * ld;         // BK x ld
  float* dss = vs + BK * ld;        // BQ x LDS
  float* lse_s = dss + BQ * LDS;    // BQ
  float* del_s = lse_s + BQ;        // BQ

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int Lq = mk.Lq, Lk = mk.Lk;
  const long long row0 = (static_cast<long long>(b) * Hq + h) * Lq;
  const long long kv_off = (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  stage(qs, q + row0 * D, q0, Lq - q0, BQ, D);
  stage(dos, dout + row0 * D, q0, Lq - q0, BQ, D);
  for (int e = tid; e < BQ; e += THREADS) {
    const bool in = q0 + e < Lq;
    lse_s[e] = in ? lse[row0 + q0 + e] : INFINITY;
    del_s[e] = in ? delta[row0 + q0 + e] : 0.f;
  }

  // keys that can be live for some row of this tile, as the forward
  const int q_first = q0 + mk.q_off;
  const int q_last = min(q0 + BQ, Lq) - 1 + mk.q_off;
  int k_begin = 0, k_end = Lk;
  if (mk.causal) k_end = min(Lk, q_last + 1);
  if (mk.has_window) k_begin = max(0, q_first - mk.window + 1);
  k_begin = (k_begin / BK) * BK;

  float dqa[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dqa[i][c] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // the last tile's readers are done (and q is staged)
    stage(ks, k + kv_off, kt, Lk - kt, BK, D);
    stage(vs, v + kv_off, kt, Lk - kt, BK, D);
    __syncthreads();
    tile_scores<KR>(qs, dos, ks, vs, lse_s, del_s, nullptr, dss, q0, kt, D,
                    mk);
    __syncthreads();  // dS is whole
    const int kn = min(BK, Lk - kt);
#pragma unroll 2
    for (int j = 0; j < kn; ++j) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dss[(ty * 4 + i) * LDS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int col = tx + 16 * c;
        kv[c] = col < D ? ks[j * ld + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) dqa[i][c] = fmaf(sv[i], kv[c], dqa[i][c]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store_as(dq + (row0 + r) * D + col, dqa[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, D <= 128: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;               // 16 rows (keys or queries) each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_TILE = 16 * TC_WARPS;    // rows per tile, both sides
constexpr int TC_PAD = 8;                 // bf16 a staged row is padded by

// Stage ROWS = TC_TILE rows of D columns from row `row0` of `src` (an
// (L, D) slab) into `dst` (row stride DP + TC_PAD); rows at or past
// `valid` are zero. With `vec` (D % 8 == 0, 16-byte aligned slabs) by
// 16-byte cp.async copies, else by plain loads and stores; the caller
// commits and waits.
template <int DP>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           int row0, int valid, int D,
                                           bool vec) {
  constexpr int LD = DP + TC_PAD;
  constexpr int CH = DP / 8;
  const int tid = threadIdx.x;
  if (vec) {
    for (int slot = tid; slot < TC_TILE * CH; slot += TC_THREADS) {
      const int r = slot / CH, c = (slot - r * CH) * 8;
      if (c < D) {
        const bool in = r < valid;
        cp_async16(dst + r * LD + c,
                   in ? src + static_cast<long long>(row0 + r) * D + c : src,
                   in);
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < TC_TILE * D; e += TC_THREADS) {
      const int r = e / D, c = e - r * D;
      dst[r * LD + c] =
          r < valid ? src[static_cast<long long>(row0 + r) * D + c] : zero;
    }
  }
}

// The tensor-core kernels' shared tiles: four of TC_TILE rows of DP + 8
// bf16 (K, V and Q, dO), then the query tile's log-sum-exp and D. The
// padding columns [D, DP) of every row are zeroed once.
template <int DP>
__device__ __forceinline__ void zero_padding(bf16* tiles, int D) {
  constexpr int LD = DP + TC_PAD;
  if (D < DP) {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = threadIdx.x; e < 4 * TC_TILE * (DP - D); e += TC_THREADS) {
      const int r = e / (DP - D);
      tiles[r * LD + D + (e - r * (DP - D))] = zero;
    }
  }
}

// ldmatrix lane addresses (lane l gives row l & 7 of matrix l >> 3):
// A from rows (m) x columns (k); B from rows that are its n dimension
// (non-transposed); B from rows that are its k dimension (transposed).
struct Frag {
  int a_row, a_col, b_row, b_col, t_row, t_col;
  __device__ Frag(int lane) {
    const int lrow = lane & 7, lmat = lane >> 3;
    a_row = ((lmat & 1) << 3) + lrow;
    a_col = (lmat >> 1) << 3;
    b_row = ((lmat >> 1) << 3) + lrow;
    b_col = (lmat & 1) << 3;
    t_row = ((lmat & 1) << 3) + lrow;
    t_col = (lmat >> 1) << 3;
  }
};

// acc (16 x 64) += A rows [a0, a0 + 16) of `as` . B^T, B the 64 rows of
// `bs` (both row stride LD, KSTEPS k-steps of 16 columns): the 8 n-tiles
// of 8 B rows each, in mma C layout.
template <int DP>
__device__ __forceinline__ void mma_abt(float (&acc)[8][4], const bf16* as,
                                        int a0, const bf16* bs,
                                        const Frag& f) {
  constexpr int LD = DP + TC_PAD;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, smem_u32(as + (a0 + f.a_row) * LD + kk * 16 + f.a_col));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, smem_u32(bs + (np * 16 + f.b_row) * LD + kk * 16 +
                              f.b_col));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DP) += P (16 x 64, bf16 A fragments of 4 k-steps) . B, B the
// 64 rows of `bs` (its k dimension) by DP columns.
template <int DP>
__device__ __forceinline__ void mma_pb(float (&acc)[DP / 8][4],
                                       const uint32_t (&pa)[4][4],
                                       const bf16* bs, const Frag& f) {
  constexpr int LD = DP + TC_PAD;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int np = 0; np < DP / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, smem_u32(bs + (kk * 16 + f.t_row) * LD + np * 16 +
                                    f.t_col));
      mma_bf16(acc[2 * np], pa[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], pa[kk], b[2], b[3]);
    }
  }
}

// P and dS0 of one (query, key) element from its raw logit and dP.
__device__ __forceinline__ void p_ds(float s, float dp, float lse,
                                     float dl, bool live, const Masks& mk,
                                     float& p, float& ds) {
  const float x = s * mk.scale;
  const float sn = mk.has_softcap ? mk.softcap * tanhf(x / mk.softcap) : x;
  p = live ? __expf(sn - lse) : 0.f;
  ds = p * (dp - dl);
  if (mk.has_softcap) {
    const float t = sn / mk.softcap;
    ds *= 1.f - t * t;
  }
  ds *= mk.scale;
}

__device__ __forceinline__ bool live_pair(int qi, int kp, const Masks& mk) {
  const int qp = qi + mk.q_off;
  return qi < mk.Lq && kp < mk.Lk && (!mk.causal || kp <= qp) &&
         (!mk.has_window || kp > qp - mk.window);
}

// dK and dV on the tensor cores: one block of 4 warps per (64-key tile,
// K/V head, batch row), each warp 16 keys; per query tile S^T = K Q^T and
// dP^T = V dO^T (16 x 64 per warp), then P^T and dS^T in bf16 as A
// operands of dV += P^T dO and dK += dS^T Q, the sums in float32
// registers.
template <int DP>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dkdv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq, int Hkv, int D,
    Masks mk, int vec) {
  constexpr int LD = DP + TC_PAD;
  constexpr int NT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TC_TILE * LD;
  bf16* qs = vs + TC_TILE * LD;
  bf16* dos = qs + TC_TILE * LD;
  float* lse_s = reinterpret_cast<float*>(dos + TC_TILE * LD);
  float* del_s = lse_s + TC_TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Frag f(lane);
  const int k0 = blockIdx.x * TC_TILE, hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv, Lq = mk.Lq, Lk = mk.Lk;
  const int wk = warp * 16;
  const long long kv_off = (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  zero_padding<DP>(ks, D);
  stage_tile<DP>(ks, k + kv_off, k0, Lk - k0, D, vec);
  stage_tile<DP>(vs, v + kv_off, k0, Lk - k0, D, vec);
  cp_async_commit();

  const int k_last = min(k0 + TC_TILE, Lk) - 1;
  int q_begin = mk.causal ? max(0, k0 - mk.q_off) : 0;
  const int q_end =
      mk.has_window ? min(Lq, k_last + mk.window - mk.q_off) : Lq;
  q_begin = (q_begin / TC_TILE) * TC_TILE;

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int hh = 0; hh < group; ++hh) {
    const long long row0 =
        (static_cast<long long>(b) * Hq + hk * group + hh) * Lq;
    for (int q0 = q_begin; q0 < q_end; q0 += TC_TILE) {
      __syncthreads();  // the last tile's readers are done
      stage_tile<DP>(qs, q + row0 * D, q0, Lq - q0, D, vec);
      stage_tile<DP>(dos, dout + row0 * D, q0, Lq - q0, D, vec);
      cp_async_commit();
      for (int e = tid; e < TC_TILE; e += TC_THREADS) {
        const bool in = q0 + e < Lq;
        lse_s[e] = in ? lse[row0 + q0 + e] : INFINITY;
        del_s[e] = in ? delta[row0 + q0 + e] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      float st[8][4], dpt[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      mma_abt<DP>(st, ks, wk, qs, f);
      mma_abt<DP>(dpt, vs, wk, dos, f);
      // element (n, e): key row wk + g (+8 for e >= 2), query n*8 + 2t4
      // (+1 for odd e)
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = n * 8 + 2 * t4 + (e & 1);
          const int kp = k0 + wk + g + ((e >> 1) << 3);
          p_ds(st[n][e], dpt[n][e], lse_s[qc], del_s[qc],
               live_pair(q0 + qc, kp, mk), mk, p[e], d[e]);
        }
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        sa[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
        sa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
      }
      mma_pb<DP>(dva, pa, dos, f);
      mma_pb<DP>(dka, sa, qs, f);
    }
  }
  cp_async_wait<0>();  // K and V's copies, when no query tile was live
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + wk + g + ((e >> 1) << 3);
      const int col = n * 8 + 2 * t4 + (e & 1);
      if (key < Lk && col < D) {
        const long long o = kv_off + static_cast<long long>(key) * D + col;
        dk[o] = __float2bfloat16(dka[n][e]);
        dv[o] = __float2bfloat16(dva[n][e]);
      }
    }
}

// dQ on the tensor cores: one block of 4 warps per (64-query tile, q
// head, batch row), each warp 16 queries; per key tile S = Q K^T and
// dP = dO V^T, then dS in bf16 as the A operand of dQ += dS K.
template <int DP>
__global__ void __launch_bounds__(TC_THREADS) flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Hq, int Hkv, int D, Masks mk, int vec) {
  constexpr int LD = DP + TC_PAD;
  constexpr int NT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + TC_TILE * LD;
  bf16* qs = vs + TC_TILE * LD;
  bf16* dos = qs + TC_TILE * LD;
  float* lse_s = reinterpret_cast<float*>(dos + TC_TILE * LD);
  float* del_s = lse_s + TC_TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const Frag f(lane);
  const int q0 = blockIdx.x * TC_TILE, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv), Lq = mk.Lq, Lk = mk.Lk;
  const int wq = warp * 16;
  const long long row0 = (static_cast<long long>(b) * Hq + h) * Lq;
  const long long kv_off = (static_cast<long long>(b) * Hkv + hk) * Lk * D;
  zero_padding<DP>(ks, D);
  stage_tile<DP>(qs, q + row0 * D, q0, Lq - q0, D, vec);
  stage_tile<DP>(dos, dout + row0 * D, q0, Lq - q0, D, vec);
  cp_async_commit();
  for (int e = tid; e < TC_TILE; e += TC_THREADS) {
    const bool in = q0 + e < Lq;
    lse_s[e] = in ? lse[row0 + q0 + e] : INFINITY;
    del_s[e] = in ? delta[row0 + q0 + e] : 0.f;
  }

  const int q_first = q0 + mk.q_off;
  const int q_last = min(q0 + TC_TILE, Lq) - 1 + mk.q_off;
  int k_begin = 0, k_end = Lk;
  if (mk.causal) k_end = min(Lk, q_last + 1);
  if (mk.has_window) k_begin = max(0, q_first - mk.window + 1);
  k_begin = (k_begin / TC_TILE) * TC_TILE;

  float dqa[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  __syncthreads();  // lse_s and del_s are whole
  // this lane's two query rows, g and g + 8 of the warp's 16
  const float lse_r[2] = {lse_s[wq + g], lse_s[wq + g + 8]};
  for (int kt = k_begin; kt < k_end; kt += TC_TILE) {
    __syncthreads();  // the last tile's readers are done
    stage_tile<DP>(ks, k + kv_off, kt, Lk - kt, D, vec);
    stage_tile<DP>(vs, v + kv_off, kt, Lk - kt, D, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<DP>(s, qs, wq, ks, f);
    mma_abt<DP>(dp, dos, wq, vs, f);
    uint32_t sa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wq + g + ((e >> 1) << 3);
        const int kp = kt + n * 8 + 2 * t4 + (e & 1);
        float p;
        p_ds(s[n][e], dp[n][e], (e >> 1) ? lse_r[1] : lse_r[0], del_s[r],
             live_pair(q0 + r, kp, mk), mk, p, d[e]);
      }
      sa[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
      sa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
    }
    mma_pb<DP>(dqa, sa, ks, f);
  }
  cp_async_wait<0>();  // q's copies, when no key tile was live
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + wq + g + ((e >> 1) << 3);
      const int col = n * 8 + 2 * t4 + (e & 1);
      if (r < Lq && col < D)
        dq[(row0 + r) * D + col] = __float2bfloat16(dqa[n][e]);
    }
}

template <int DP>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const bf16* dout, const float* lse, const float* delta,
                bf16* dq, bf16* dk, bf16* dv, int B, int Hq, int Hkv, int D,
                Masks mk, cudaStream_t stream) {
  constexpr size_t smem = sizeof(bf16) * 4 * TC_TILE * (DP + TC_PAD) +
                          sizeof(float) * 2 * TC_TILE;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                  aligned(dout);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_bf16_kernel<DP>
      <<<dim3((mk.Lk + TC_TILE - 1) / TC_TILE, Hkv, B), TC_THREADS, smem,
         stream>>>(q, k, v, dout, lse, delta, dk, dv, Hq, Hkv, D, mk, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_bf16_kernel<DP>
      <<<dim3((mk.Lq + TC_TILE - 1) / TC_TILE, Hq, B), TC_THREADS, smem,
         stream>>>(q, k, v, dout, lse, delta, dq, Hq, Hkv, D, mk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dot(const void* o, const void* dout, float* delta, long long rows,
               int D, cudaStream_t stream) {
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                            stream>>>(static_cast<const T*>(o),
                                      static_cast<const T*>(dout), delta,
                                      rows, D);
  return static_cast<int>(cudaGetLastError());
}

// the CUDA-core kernels: dK and dV, then dQ
template <typename T, int KR, int DC>
int launch_cores(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int D,
                 Masks mk, cudaStream_t stream) {
  constexpr int BK = 16 * KR;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const size_t ld = D + 1;
  const size_t dkdv_smem =
      sizeof(float) * ((2 * BK + 2 * BQ) * ld + 2 * BQ * (BK + 1) + 2 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, KR, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dkdv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, KR, DC>
      <<<dim3((mk.Lk + BK - 1) / BK, Hkv, B), THREADS, dkdv_smem, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), Hq, Hkv, D, mk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dq_smem =
      sizeof(float) * ((2 * BQ + 2 * BK) * ld + BQ * (BK + 1) + 2 * BQ);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, KR, DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dq_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, KR, DC>
      <<<dim3((mk.Lq + BQ - 1) / BQ, Hq, B), THREADS, dq_smem, stream>>>(
          qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Hq, Hkv, D, mk);
  return static_cast<int>(cudaGetLastError());
}

// float32: the CUDA-core kernels, key tiles of 64 (KR 4) up to D = 128
// and of 32 (KR 2) up to 256, so that the staged tiles fit in shared
// memory
int dispatch_f32(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, int B, int Hq, int Hkv, int D,
                 Masks mk, cudaStream_t s) {
  if (D <= 32)
    return launch_cores<float, 4, 2>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     B, Hq, Hkv, D, mk, s);
  if (D <= 64)
    return launch_cores<float, 4, 4>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     B, Hq, Hkv, D, mk, s);
  if (D <= 128)
    return launch_cores<float, 4, 8>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     B, Hq, Hkv, D, mk, s);
  return launch_cores<float, 2, 16>(q, k, v, dout, lse, delta, dq, dk, dv,
                                    B, Hq, Hkv, D, mk, s);
}

// bf16: the tensor-core kernels up to D = 128 (D padded with zero columns
// to the first instantiated width that holds it), the CUDA-core kernels
// above
int dispatch_bf16(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                  int D, Masks mk, cudaStream_t s) {
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
#define REPRO_FLASH_BWD_BF16(DP)                                            \
  if (D <= DP)                                                              \
    return launch_bf16<DP>(qb, kb, vb, db, lse, delta, dqb, dkb, dvb, B, Hq, \
                           Hkv, D, mk, s);
  REPRO_FLASH_BWD_BF16(32)
  REPRO_FLASH_BWD_BF16(64)
  REPRO_FLASH_BWD_BF16(80)
  REPRO_FLASH_BWD_BF16(96)
  REPRO_FLASH_BWD_BF16(128)
#undef REPRO_FLASH_BWD_BF16
  return launch_cores<bf16, 2, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                   Hq, Hkv, D, mk, s);
}

}  // namespace

// q, o, dout, dq (B, Hq, Lq, D); k, v, dk, dv (B, Hkv, Lk, D); all of one
// dtype (0 float32, 1 bfloat16); lse (B, Hq, Lq) float32 as the forward
// wrote it; delta (B, Hq, Lq) float32 scratch. Contiguous, on one device;
// 1 <= D <= 256, Hq % Hkv == 0, Lq, Lk >= 1. The masks, softcap and scale
// as the forward took them. `stream` is a cudaStream_t. Returns a
// cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int dtype, int B, int Hq, int Hkv, int Lq, int Lk, int D,
    int causal, int has_window, int window, int has_softcap, float softcap,
    float scale, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv || Lq < 1 || Lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Masks mk{Lq, Lk, Lk - Lq, causal, has_window, window, has_softcap,
                 softcap, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  const long long rows = static_cast<long long>(B) * Hq * Lq;
  const int err = dtype == 1 ? launch_dot<bf16>(o, dout, d, rows, D, s)
                             : launch_dot<float>(o, dout, d, rows, D, s);
  if (err) return err;
  if (dtype == 1)
    return dispatch_bf16(q, k, v, dout, l, d, dq, dk, dv, B, Hq, Hkv, D, mk,
                         s);
  return dispatch_f32(q, k, v, dout, l, d, dq, dk, dv, B, Hq, Hkv, D, mk, s);
}
