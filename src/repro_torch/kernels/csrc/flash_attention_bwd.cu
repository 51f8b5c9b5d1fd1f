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
// FlashAttention-2's order, in three launches (four when dK and dV are
// summed from partials, below):
//   1. `flash_bwd_dot_kernel`: D, one warp per query row;
//   2. the dK/dV kernel: one block per (key tile, K/V head, batch row),
//      which loops over the group's Hq / Hkv query heads (or a slice of
//      them) and their query tiles that can see a key of the tile, dK and
//      dV summed in registers;
//   3. the dQ kernel: one block per (query tile, q head, batch row), which
//      loops over the key tiles the forward visits.
// Deterministic: no floating-point atomics, every sum in a fixed order, so
// two calls give the same bits. dQ is its own pass, which recomputes S
// and dP: 7 products per live (query, key) pair and column of D instead of
// the 5 of a kernel that adds dQ with atomics (1.4 times the products).
//
// What bounds it on an H100: at qwen2-1.5b's training shape (B 8, Hq 12,
// Hkv 2, L 1024, D 128, causal, bf16) one call reads q, k, v, O, dO and
// writes dq, dk, dv, ~118 MB (35 us at 3.35 TB/s), and does 2.5 times the
// forward's products over the live pairs, ~65 GFLOP (66 us at the bf16
// tensor-core rate): bound by operations. Two designs, by dtype:
//
// bf16, D <= 128 (training): wgmma and TMA (csrc/hopper.cuh), as the
// forward's bf16 kernel. Each block has a producer warpgroup (one warp
// issues the loads) and two consumer warpgroups of 64 rows (setmaxnreg:
// 40 and 232 registers a thread).
//   * dK/dV (`flash_bwd_dkdv_bf16_kernel`): 128 keys a block, keys as
//     wgmma's M. The producer loads the K and V tile once, then streams
//     Q and dO tiles of 64 queries over the slice's heads and query tiles
//     through a TMA ring of 3 stages (full/empty mbarriers), with the
//     tile's log-sum-exp and D rows copied beside them. Per tile each
//     warpgroup computes S^T = K Q^T and dP^T = V dO^T (m64n64k16, both
//     operands from shared memory; at D = 128 in two passes of 32
//     queries, m64n32k16, for registers), P^T and dS^T in float32 on the
//     accumulator fragments, then dV += P^T dO and dK += dS^T Q with P^T
//     and dS^T from registers (rounded to bf16 in pairs: the accumulator
//     layout is the A-register layout) and dO and Q as MN-major B operands
//     (m64nDNk16, DN = 80 at D = 80). dK and dV stay in registers (2 x DN
//     / 2 floats a thread).
//   * dQ (`flash_bwd_dq_bf16_kernel`): 128 queries a block, Q and dO
//     loaded once, K and V tiles of 64 keys streamed; S = Q K^T and
//     dP = dO V^T from shared memory, dS from registers into dQ += dS K
//     with K MN-major. The query tiles are the grid's slowest axis,
//     reversed, longest causal tiles first.
//   * The grid. At qwen2's shape the dK/dV grid of (8 key tiles, 2 K/V
//     heads, 8 batch rows) is 128 blocks, under one a streaming
//     multiprocessor (132 on an H100), and under the causal mask key tile
//     j has 6 (16 - 2 j) (query tile, head) pairs of work: the first
//     block does 96, the mean 54, so one block each would leave the card
//     idle 44% of the time. So the group's heads are split into `slices`,
//     the fewest that give at least two blocks a multiprocessor (qwen2: 3
//     slices of 2 heads, 384 blocks of 32 to 4 pairs), the key tiles the
//     grid's slowest axis in ascending order (the longest causal work
//     first), and each slice writes float32 partial dK and dV that a
//     fourth launch (`flash_bwd_sum_kernel`) sums in slice order into
//     bf16: at qwen2's shape 50 MB of partials written and read again
//     (~30 us at the HBM rate) against ~40% less idle time. With one slice
//     the kernel writes bf16 dK and dV itself.
//   * q, k, v and dO are (D, L, H, B) tensor maps with boxes of 64 columns
//     by 64 rows and 128-byte swizzle (a box past L reads zeros, columns
//     past D read zeros: D = 80 is two boxes, of which the products read
//     80 columns). D % 8 != 0 or a base that is not 16-byte aligned takes
//     the producer warp's staging path (stage_tile), the same swizzled
//     tiles by plain loads.
//   * Both kernels ping-pong their two warpgroups (csrc/hopper.cuh): each
//     issues its S and dP products on its turn only, so one warpgroup's
//     elementwise work runs under the other's products. The elementwise
//     step is compiled once per (softcap, tile holds a dead pair), chosen
//     per tile, so no per-element test or unused division remains in it.
//   Not done: overlapping one tile's elementwise work with the next tile's
//   products inside a warpgroup.
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

#include <type_traits>

#include "hopper.cuh"

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
// bf16, D <= 128: tensor cores (wgmma), TMA, warp specialisation
// ---------------------------------------------------------------------------

constexpr int TC_CONSUMERS = 256;              // two consumer warpgroups
// and a producer warpgroup, of which one warp loads: the block's registers
// (168 a thread at 384 threads) rebalance exactly, the producer giving
// back 128 a thread (40 left) and the consumers taking 64 more (232). (24
// and 240, FlashAttention-3's split, leave this producer too few: it
// spills.)
constexpr int TC_THREADS = TC_CONSUMERS + 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int WG_ROWS = 64;   // a warpgroup's own rows (keys or queries)
constexpr int TC_TILE = 2 * WG_ROWS;  // a block's own rows
constexpr int TC_OTHER = 64;  // rows of a streamed tile (queries or keys)
constexpr int TC_STAGES = 3;  // the ring of streamed tiles
constexpr float LOG2E = 1.4426950408889634f;

// The shared memory of both kernels: two tiles of the block's own rows
// (K and V, or Q and dO), TC_STAGES stages of two streamed tiles, the
// stages' log-sum-exp and D rows (dK/dV), the barriers; 1024 bytes of
// slack to align the tiles.
template <int DP>
struct BwdTile {
  static constexpr size_t SMEM =
      1024 + sizeof(bf16) * (2 * TC_TILE * DP + 2 * TC_STAGES * TC_OTHER * DP) +
      sizeof(float) * 2 * TC_STAGES * TC_OTHER +
      sizeof(uint64_t) * (1 + 2 * TC_STAGES);
};

// P and dS0 of one (query, key) element from its raw logit s and dP; lse2
// is the row's log-sum-exp times log2(e) (+inf for a row with no live
// key). CAP: with the softcap, its tanh as the forward's bf16 kernel takes
// it (tanh_fast). A template, so that the call sites branch on the
// softcap once per tile: a per-element `x / softcap` is evaluated whether
// or not it is used, and with softcap 0 (no softcap) it takes the
// division's slow path on every element, slower than the tile's products.
template <bool CAP>
__device__ __forceinline__ void p_ds(float s, float dp, float lse2,
                                     float dl, bool live, const Masks& mk,
                                     float& p, float& ds) {
  if (CAP) {
    const float t = tanh_fast(s * mk.scale * (1.f / mk.softcap));
    p = live ? exp2_approx(fmaf(mk.softcap * t, LOG2E, -lse2)) : 0.f;
    ds = p * (dp - dl) * (1.f - t * t) * mk.scale;
  } else {
    p = live ? exp2_approx(fmaf(s, mk.scale * LOG2E, -lse2)) : 0.f;
    ds = p * (dp - dl) * mk.scale;
  }
}

// Calls f(cap, mask) with both as compile-time booleans, so that the
// elementwise step's loop tests neither per element: whether the softcap
// applies, and whether the tile holds a dead (query, key) pair.
template <typename F>
__device__ __forceinline__ void dispatch_elementwise(bool cap, bool mask,
                                                     const F& f) {
  if (cap) {
    if (mask)
      f(std::true_type{}, std::true_type{});
    else
      f(std::true_type{}, std::false_type{});
  } else {
    if (mask)
      f(std::false_type{}, std::true_type{});
    else
      f(std::false_type{}, std::false_type{});
  }
}

__device__ __forceinline__ bool live_pair(int qi, int kp, const Masks& mk) {
  const int qp = qi + mk.q_off;
  return qi < mk.Lq && kp < mk.Lk && (!mk.causal || kp <= qp) &&
         (!mk.has_window || kp > qp - mk.window);
}

// 1024-byte aligned start of the dynamic shared memory
__device__ __forceinline__ bf16* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t{1023});
}

// Rows [row0, row0 + ROWS) of a head's slab into a swizzled tile, ROWS a
// multiple of 64: by TMA (lane 0 issues, 64-row boxes) or, without tensor
// maps, by the warp's plain loads (the caller then arrives on `bar`).
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map,
                                          uint64_t* bar, const bf16* slab,
                                          int row0, int L, int D, int h,
                                          int b, int tma, int lane) {
  if (tma) {
    if (lane == 0)
      for (int x = 0; x < DP / 64; ++x)
        for (int r = 0; r < ROWS; r += 64)
          tma_load_4d(dst + x * ROWS * 64 + r * 64, map, bar, x * 64,
                      row0 + r, h, b);
  } else {
    stage_tile<DP, ROWS>(dst, slab, row0, L, D, lane);
  }
}

// One stage's barrier: armed with the stage's TMA bytes (lane 0) before
// the loads, or arrived on after the warp's staging.
__device__ __forceinline__ void arm(uint64_t* bar, uint32_t bytes, int tma,
                                    int lane) {
  if (tma && lane == 0) mbar_expect_tx(bar, bytes);
}

__device__ __forceinline__ void staged(uint64_t* bar, int tma, int lane) {
  if (!tma) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  }
}

// dK and dV: one block per (128-key tile, slice of the group's heads, K/V
// head, batch row); grid (slices * Hkv, B, key tiles). DN <= DP: the
// columns computed (80 for D = 80, else DP).
template <int DP, int DN>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_bwd_dkdv_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ part, int Hq, int Hkv, int D,
    Masks mk, int slices, int tma) {
  constexpr uint32_t OTHER_BYTES = sizeof(bf16) * TC_OTHER * DP;
  // a streamed tile's queries in HALVES passes of QH: at D = 128 the two
  // D-wide sums (128 floats a thread) beside S^T and dP^T of 64 queries
  // (64 more) leave ptxas short of registers (it spills and serializes the
  // wgmmas); S^T and dP^T of 32 queries at a time fit
  constexpr int HALVES = DN > 80 ? 2 : 1, QH = TC_OTHER / HALVES;
  extern __shared__ unsigned char smem_raw[];
  bf16* ks = aligned_smem(smem_raw);            // TC_TILE x DP
  bf16* vs = ks + TC_TILE * DP;                 // TC_TILE x DP
  bf16* qs = vs + TC_TILE * DP;                 // TC_STAGES x TC_OTHER x DP
  bf16* dos = qs + TC_STAGES * TC_OTHER * DP;   // TC_STAGES x TC_OTHER x DP
  float* lse_s = reinterpret_cast<float*>(dos + TC_STAGES * TC_OTHER * DP);
  float* del_s = lse_s + TC_STAGES * TC_OTHER;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(del_s + TC_STAGES * TC_OTHER);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + TC_STAGES;

  const int tid = threadIdx.x, warp = warp_uniform(), lane = tid & 31;
  const int slice = blockIdx.x % slices, hk = blockIdx.x / slices;
  const int b = blockIdx.y, k0 = blockIdx.z * TC_TILE;
  const int group = Hq / Hkv, per = group / slices;
  const int h0 = hk * group + slice * per;
  const int Lq = mk.Lq, Lk = mk.Lk;
  const long long kv_off = (static_cast<long long>(b) * Hkv + hk) * Lk * D;

  // query rows that see a key of this tile
  const int k_last = min(k0 + TC_TILE, Lk) - 1;
  int q_begin = mk.causal ? max(0, k0 - mk.q_off) : 0;
  const int q_end =
      mk.has_window ? min(Lq, k_last + mk.window - mk.q_off) : Lq;
  q_begin = (q_begin / TC_OTHER) * TC_OTHER;
  const int n_qt =
      q_end > q_begin ? (q_end - q_begin + TC_OTHER - 1) / TC_OTHER : 0;
  const int n_items = per * n_qt;  // (head, query tile), heads outermost

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, TC_CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= TC_CONSUMERS / 32) {
    // the producer: K and V once, then (Q, dO, lse, D) tile by tile
    reg_dealloc<PRODUCER_REGS>();
    if (warp != TC_CONSUMERS / 32) return;  // the idle producer warps
    arm(kv_full, 2 * sizeof(bf16) * TC_TILE * DP, tma, lane);
    load_tile<DP, TC_TILE>(ks, &k_map, kv_full, k + kv_off, k0, Lk, D, hk, b,
                           tma, lane);
    load_tile<DP, TC_TILE>(vs, &v_map, kv_full, v + kv_off, k0, Lk, D, hk, b,
                           tma, lane);
    staged(kv_full, tma, lane);
    for (int it = 0; it < n_items; ++it) {
      const int s = it % TC_STAGES, h = h0 + it / n_qt;
      const int q0 = q_begin + (it % n_qt) * TC_OTHER;
      const long long row0 = (static_cast<long long>(b) * Hq + h) * Lq;
      if (it >= TC_STAGES) mbar_wait(empty + s, (it / TC_STAGES - 1) & 1);
      for (int e = lane; e < TC_OTHER; e += 32) {
        const bool in = q0 + e < Lq;
        lse_s[s * TC_OTHER + e] = in ? lse[row0 + q0 + e] * LOG2E : INFINITY;
        del_s[s * TC_OTHER + e] = in ? delta[row0 + q0 + e] : 0.f;
      }
      __syncwarp();  // lane 0's arrival below releases every lane's rows
      arm(full + s, 2 * OTHER_BYTES, tma, lane);
      load_tile<DP, TC_OTHER>(qs + s * TC_OTHER * DP, &q_map, full + s,
                              q + row0 * D, q0, Lq, D, h, b, tma, lane);
      load_tile<DP, TC_OTHER>(dos + s * TC_OTHER * DP, &do_map, full + s,
                              dout + row0 * D, q0, Lq, D, h, b, tma, lane);
      staged(full + s, tma, lane);
    }
  } else {
    // a consumer warpgroup: 64 keys, each warp 16 of them
    reg_alloc<CONSUMER_REGS>();
    const int wg = warp >> 2;
    const int g = lane >> 2, t4 = lane & 3;
    const int wk0 = k0 + wg * WG_ROWS;      // the warpgroup's first key
    const int rr = (warp & 3) * 16 + g;     // this lane's keys wk0 + rr (+8)
    const int wk_last = min(wk0 + WG_ROWS, Lk) - 1;
    const bf16* kw = ks + wg * WG_ROWS * 64;
    const bf16* vw = vs + wg * WG_ROWS * 64;
    float dka[DN / 2], dva[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dka[i] = dva[i] = 0.f;

    mbar_wait(kv_full, 0);
    ping_start(wg);
    for (int it = 0; it < n_items; ++it) {
      const int s = it % TC_STAGES;
      const int q0 = q_begin + (it % n_qt) * TC_OTHER;
      // positions of the tile's first and last query
      const int qa = q0 + mk.q_off, qz = min(q0 + TC_OTHER, Lq) - 1 + mk.q_off;
      const bool live = wk0 < Lk && !(mk.causal && wk0 > qz) &&
                        !(mk.has_window && qa >= wk_last + mk.window);
      const bf16* qc = qs + s * TC_OTHER * DP;
      const bf16* dc = dos + s * TC_OTHER * DP;
      const float* ls = lse_s + s * TC_OTHER;
      const float* dl = del_s + s * TC_OTHER;
      const bool need_mask = q0 + TC_OTHER > Lq || wk0 + WG_ROWS > Lk ||
                             (mk.causal && wk0 + WG_ROWS - 1 > qa) ||
                             (mk.has_window && wk0 <= qz - mk.window);
      mbar_wait(full + s, (it / TC_STAGES) & 1);
#pragma unroll
      for (int half = 0; half < HALVES; ++half) {
        const int h0q = half * QH;  // the pass's first query in the tile
        // S^T = K Q^T and dP^T = V dO^T: QH / 8 groups of 8 queries, 4
        // floats a lane each (keys rr, rr + 8)
        float st[QH / 2], dpt[QH / 2];
        if (half == 0) ping_wait(wg);
        if (live) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DN / 16; ++kk) {
            const int ao = (kk >> 2) * TC_TILE * 64 + (kk & 3) * 16;
            const int bo = (kk >> 2) * TC_OTHER * 64 + h0q * 64 + (kk & 3) * 16;
            Wgmma<QH>::ss(st, desc_sw128(kw + ao, 16, 1024),
                          desc_sw128(qc + bo, 16, 1024), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < DN / 16; ++kk) {
            const int ao = (kk >> 2) * TC_TILE * 64 + (kk & 3) * 16;
            const int bo = (kk >> 2) * TC_OTHER * 64 + h0q * 64 + (kk & 3) * 16;
            Wgmma<QH>::ss(dpt, desc_sw128(vw + ao, 16, 1024),
                          desc_sw128(dc + bo, 16, 1024), kk > 0);
          }
          wgmma_commit();
        }
        if (half == 0) ping_pass(wg);
        if (live) {
          wgmma_wait<0>();
          fence_regs(st);
          fence_regs(dpt);

          // P^T and dS^T in bf16 as A operands: element 4 n + e is key
          // rr (+8 for e >= 2), query h0q + 8 n + 2 t4 (+1 for odd e)
          uint32_t pa[QH / 16][4], sa[QH / 16][4];
          const auto frags = [&](auto cap, auto mask) {
#pragma unroll
            for (int n = 0; n < QH / 8; ++n) {
              float p[4], d[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qc_ = h0q + n * 8 + 2 * t4 + (e & 1);
                const int kp = wk0 + rr + ((e >> 1) << 3);
                p_ds<decltype(cap)::value>(
                    st[4 * n + e], dpt[4 * n + e], ls[qc_], dl[qc_],
                    !decltype(mask)::value || live_pair(q0 + qc_, kp, mk),
                    mk, p[e], d[e]);
              }
              pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
              pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
              sa[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
              sa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
            }
          };
          dispatch_elementwise(mk.has_softcap, need_mask, frags);
          // dV += P^T dO and dK += dS^T Q: the pass's queries are the
          // reduction, dO and Q the MN-major B operands
          fence_regs(dva);
          fence_regs(dka);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < QH / 16; ++kk)
            Wgmma<DN>::rs(dva, pa[kk],
                          desc_sw128(dc + (h0q + kk * 16) * 64,
                                     TC_OTHER * 128, 1024),
                          1);
#pragma unroll
          for (int kk = 0; kk < QH / 16; ++kk)
            Wgmma<DN>::rs(dka, sa[kk],
                          desc_sw128(qc + (h0q + kk * 16) * 64,
                                     TC_OTHER * 128, 1024),
                          1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dva);
          fence_regs(dka);
          fence_regs(pa);
          fence_regs(sa);
        }
      }
      mbar_arrive(empty + s);
    }
    ping_end(wg);

    // bf16 dK and dV, or this slice's float32 partials
    const long long n_all = static_cast<long long>(gridDim.y) * Hkv * Lk * D;
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) {
      const int key = wk0 + rr + 8 * ((i >> 1) & 1);
      const int col = (i >> 2) * 8 + 2 * t4 + (i & 1);
      if (key < Lk && col < D) {
        const long long o = kv_off + static_cast<long long>(key) * D + col;
        if (slices == 1) {
          dk[o] = __float2bfloat16(dka[i]);
          dv[o] = __float2bfloat16(dva[i]);
        } else {
          part[2 * slice * n_all + o] = dka[i];
          part[(2 * slice + 1) * n_all + o] = dva[i];
        }
      }
    }
  }
}

// dQ: one block per (128-query tile, q head, batch row); grid (Hq, B,
// query tiles), the query tiles reversed (longest causal tiles first).
template <int DP, int DN>
__global__ void __launch_bounds__(TC_THREADS, 1) flash_bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap do_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Hq, int Hkv,
    int D, Masks mk, int tma) {
  constexpr int BK = TC_OTHER;
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = aligned_smem(smem_raw);            // TC_TILE x DP
  bf16* dos = qs + TC_TILE * DP;                // TC_TILE x DP
  bf16* ks = dos + TC_TILE * DP;                // TC_STAGES x BK x DP
  bf16* vs = ks + TC_STAGES * BK * DP;          // TC_STAGES x BK x DP
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + TC_STAGES * BK * DP);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + TC_STAGES;

  const int tid = threadIdx.x, warp = warp_uniform(), lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_TILE;
  const int hk = h / (Hq / Hkv), Lq = mk.Lq, Lk = mk.Lk;
  const long long row0 = (static_cast<long long>(b) * Hq + h) * Lq;
  const long long kv_off = (static_cast<long long>(b) * Hkv + hk) * Lk * D;

  // keys that can be live for some row of this tile, as the forward
  const int q_first = q0 + mk.q_off;
  const int q_last = min(q0 + TC_TILE, Lq) - 1 + mk.q_off;
  int k_begin = 0, k_end = Lk;
  if (mk.causal) k_end = min(Lk, q_last + 1);
  if (mk.has_window) k_begin = max(0, q_first - mk.window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, TC_CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= TC_CONSUMERS / 32) {
    // the producer: Q and dO once, then K and V tile by tile
    reg_dealloc<PRODUCER_REGS>();
    if (warp != TC_CONSUMERS / 32) return;  // the idle producer warps
    arm(q_full, 2 * sizeof(bf16) * TC_TILE * DP, tma, lane);
    load_tile<DP, TC_TILE>(qs, &q_map, q_full, q + row0 * D, q0, Lq, D, h, b,
                           tma, lane);
    load_tile<DP, TC_TILE>(dos, &do_map, q_full, dout + row0 * D, q0, Lq, D,
                           h, b, tma, lane);
    staged(q_full, tma, lane);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % TC_STAGES, kt = k_begin + it * BK;
      if (it >= TC_STAGES) mbar_wait(empty + s, (it / TC_STAGES - 1) & 1);
      arm(full + s, 2 * sizeof(bf16) * BK * DP, tma, lane);
      load_tile<DP, BK>(ks + s * BK * DP, &k_map, full + s, k + kv_off, kt,
                        Lk, D, hk, b, tma, lane);
      load_tile<DP, BK>(vs + s * BK * DP, &v_map, full + s, v + kv_off, kt,
                        Lk, D, hk, b, tma, lane);
      staged(full + s, tma, lane);
    }
  } else {
    // a consumer warpgroup: 64 queries, each warp 16 of them
    reg_alloc<CONSUMER_REGS>();
    const int wg = warp >> 2;
    const int g = lane >> 2, t4 = lane & 3;
    const int wq0 = q0 + wg * WG_ROWS;
    const int rr = (warp & 3) * 16 + g;  // this lane's rows wq0 + rr (+8)
    const bool has_rows = wq0 < Lq;
    const int wq_first = wq0 + mk.q_off;
    const int wq_last = min(wq0 + WG_ROWS, Lq) - 1 + mk.q_off;
    float lse_r[2], del_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq0 + rr + 8 * r;
      lse_r[r] = row < Lq ? lse[row0 + row] * LOG2E : INFINITY;
      del_r[r] = row < Lq ? delta[row0 + row] : 0.f;
    }
    const bf16* qw = qs + wg * WG_ROWS * 64;
    const bf16* dw = dos + wg * WG_ROWS * 64;
    float dqa[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dqa[i] = 0.f;

    mbar_wait(q_full, 0);
    ping_start(wg);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % TC_STAGES, kt = k_begin + it * BK;
      const bool live = has_rows && !(mk.causal && kt > wq_last) &&
                        !(mk.has_window && kt + BK - 1 <= wq_first - mk.window);
      const bf16* kc = ks + s * BK * DP;
      const bf16* vc = vs + s * BK * DP;
      // S = Q K^T and dP = dO V^T: 8 groups of 8 keys, 4 floats a lane
      float sc[BK / 2], dp[BK / 2];
      mbar_wait(full + s, (it / TC_STAGES) & 1);
      ping_wait(wg);
      if (live) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DN / 16; ++kk) {
          const int ao = (kk >> 2) * TC_TILE * 64 + (kk & 3) * 16;
          const int bo = (kk >> 2) * BK * 64 + (kk & 3) * 16;
          Wgmma<BK>::ss(sc, desc_sw128(qw + ao, 16, 1024),
                        desc_sw128(kc + bo, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DN / 16; ++kk) {
          const int ao = (kk >> 2) * TC_TILE * 64 + (kk & 3) * 16;
          const int bo = (kk >> 2) * BK * 64 + (kk & 3) * 16;
          Wgmma<BK>::ss(dp, desc_sw128(dw + ao, 16, 1024),
                        desc_sw128(vc + bo, 16, 1024), kk > 0);
        }
        wgmma_commit();
      }
      ping_pass(wg);
      if (live) {
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        const bool need_mask = wq0 + WG_ROWS > Lq || kt + BK > Lk ||
                               (mk.causal && kt + BK - 1 > wq_first) ||
                               (mk.has_window && kt <= wq_last - mk.window);
        uint32_t sa[BK / 16][4];
        const auto frags = [&](auto cap, auto mask) {
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            float d[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const int kp = kt + n * 8 + 2 * t4 + (e & 1);
              float p;
              p_ds<decltype(cap)::value>(
                  sc[4 * n + e], dp[4 * n + e], lse_r[r], del_r[r],
                  !decltype(mask)::value ||
                      live_pair(wq0 + rr + 8 * r, kp, mk),
                  mk, p, d[e]);
            }
            sa[n >> 1][(n & 1) * 2] = pack_bf16(d[0], d[1]);
            sa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d[2], d[3]);
          }
        };
        dispatch_elementwise(mk.has_softcap, need_mask, frags);
        // dQ += dS K: the 64 keys are the reduction, K the MN-major B
        fence_regs(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<DN>::rs(dqa, sa[kk],
                        desc_sw128(kc + kk * 16 * 64, BK * 128, 1024), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
        fence_regs(sa);
      }
      mbar_arrive(empty + s);
    }
    ping_end(wg);

#pragma unroll
    for (int i = 0; i < DN / 2; ++i) {
      const int row = wq0 + rr + 8 * ((i >> 1) & 1);
      const int col = (i >> 2) * 8 + 2 * t4 + (i & 1);
      if (row < Lq && col < D)
        dq[(row0 + row) * D + col] = __float2bfloat16(dqa[i]);
    }
  }
}

// dK and dV in bf16 from the slices' float32 partials, summed in slice
// order: part holds, per slice, n partial dK values then n of dV.
__global__ void flash_bwd_sum_kernel(const float* __restrict__ part,
                                     bf16* __restrict__ dk,
                                     bf16* __restrict__ dv, long long n,
                                     int slices) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < slices; ++s) {
      a += part[2 * s * n + i];
      c += part[(2 * s + 1) * n + i];
    }
    dk[i] = __float2bfloat16(a);
    dv[i] = __float2bfloat16(c);
  }
}

// The slices the dK/dV grid splits each GQA group into: the fewest (a
// divisor of the group) that give at least two blocks a multiprocessor,
// else the whole group (one head a block).
int dkdv_slices(int B, int Hq, int Hkv, int Lk) {
  const int group = Hq / Hkv;
  const long long blocks =
      static_cast<long long>((Lk + TC_TILE - 1) / TC_TILE) * Hkv * B;
  const int want = 2 * multiprocessors();
  for (int s = 1; s < group; ++s)
    if (group % s == 0 && blocks * s >= want) return s;
  return group;
}

// Floats of workspace a call needs: D's rows (rounded up to 64 floats),
// then the dK/dV partials when the bf16 tensor-core path splits the
// group.
long long work_floats(int dtype, int B, int Hq, int Hkv, int Lq, int Lk,
                      int D) {
  const long long rows = (static_cast<long long>(B) * Hq * Lq + 63) / 64 * 64;
  if (dtype != 1 || D > 128) return rows;
  const int slices = dkdv_slices(B, Hq, Hkv, Lk);
  return rows + (slices > 1
                     ? 2LL * slices * B * Hkv * static_cast<long long>(Lk) * D
                     : 0);
}

template <int DP, int DN>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const bf16* dout, const float* lse, const float* delta,
                float* part, bf16* dq, bf16* dk, bf16* dv, int B, int Hq,
                int Hkv, int D, Masks mk, cudaStream_t stream) {
  constexpr size_t smem = BwdTile<DP>::SMEM;
  const int tma = tma_ok(q, D) && tma_ok(k, D) && tma_ok(v, D) &&
                  tma_ok(dout, D);
  CUtensorMap maps[4] = {};  // q, dO, k, v; unused (zero) when staging
  if (tma) {
    int bad = make_map(&maps[0], q, B, Hq, mk.Lq, D, 64);
    bad = bad ? bad : make_map(&maps[1], dout, B, Hq, mk.Lq, D, 64);
    bad = bad ? bad : make_map(&maps[2], k, B, Hkv, mk.Lk, D, 64);
    bad = bad ? bad : make_map(&maps[3], v, B, Hkv, mk.Lk, D, 64);
    if (bad) return bad;
  }
  const int slices = dkdv_slices(B, Hq, Hkv, mk.Lk);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16_kernel<DP, DN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_bf16_kernel<DP, DN>
      <<<dim3(slices * Hkv, B, (mk.Lk + TC_TILE - 1) / TC_TILE), TC_THREADS,
         smem, stream>>>(maps[0], maps[1], maps[2], maps[3], q, k, v, dout,
                         lse, delta, dk, dv, part, Hq, Hkv, D, mk, slices,
                         tma);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slices > 1) {
    const long long n = static_cast<long long>(B) * Hkv * mk.Lk * D;
    const long long blocks = (n + 255) / 256;
    flash_bwd_sum_kernel<<<static_cast<unsigned>(
                               blocks < 8LL * multiprocessors()
                                   ? blocks
                                   : 8LL * multiprocessors()),
                           256, 0, stream>>>(part, dk, dv, n, slices);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DP, DN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_bf16_kernel<DP, DN>
      <<<dim3(Hq, B, (mk.Lq + TC_TILE - 1) / TC_TILE), TC_THREADS, smem,
         stream>>>(maps[0], maps[1], maps[2], maps[3], q, k, v, dout, lse,
                   delta, dq, Hq, Hkv, D, mk, tma);
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

// bf16: the tensor-core kernels up to D = 128 (D padded to whole 64-column
// boxes), the CUDA-core kernels above
int dispatch_bf16(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  float* part, void* dq, void* dk, void* dv, int B, int Hq,
                  int Hkv, int D, Masks mk, cudaStream_t s) {
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  if (D <= 64)
    return launch_bf16<64, 64>(qb, kb, vb, db, lse, delta, part, dqb, dkb,
                               dvb, B, Hq, Hkv, D, mk, s);
  if (D <= 80)
    return launch_bf16<128, 80>(qb, kb, vb, db, lse, delta, part, dqb, dkb,
                                dvb, B, Hq, Hkv, D, mk, s);
  if (D <= 128)
    return launch_bf16<128, 128>(qb, kb, vb, db, lse, delta, part, dqb, dkb,
                                 dvb, B, Hq, Hkv, D, mk, s);
  return launch_cores<bf16, 2, 16>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                   Hq, Hkv, D, mk, s);
}

}  // namespace

// q, o, dout, dq (B, Hq, Lq, D); k, v, dk, dv (B, Hkv, Lk, D); all of one
// dtype (0 float32, 1 bfloat16); lse (B, Hq, Lq) float32 as the forward
// wrote it; work float32 scratch of repro_flash_attention_bwd_work(...)
// floats (D's rows, then any dK/dV partials). Contiguous, on one device;
// 1 <= D <= 256, Hq % Hkv == 0, Lq, Lk >= 1. The masks, softcap and scale
// as the forward took them. `stream` is a cudaStream_t. Returns a
// cudaError_t (0 on success).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* work, void* dq, void* dk,
    void* dv, int dtype, int B, int Hq, int Hkv, int Lq, int Lk, int D,
    int causal, int has_window, int window, int has_softcap, float softcap,
    float scale, void* stream) {
  if (D < 1 || D > 256 || Hkv < 1 || Hq % Hkv || Lq < 1 || Lk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Masks mk{Lq, Lk, Lk - Lq, causal, has_window, window, has_softcap,
                 softcap, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(work);
  const long long rows = static_cast<long long>(B) * Hq * Lq;
  const int err = dtype == 1 ? launch_dot<bf16>(o, dout, d, rows, D, s)
                             : launch_dot<float>(o, dout, d, rows, D, s);
  if (err) return err;
  if (dtype == 1)
    return dispatch_bf16(q, k, v, dout, l, d, d + (rows + 63) / 64 * 64, dq,
                         dk, dv, B, Hq, Hkv, D, mk, s);
  return dispatch_f32(q, k, v, dout, l, d, dq, dk, dv, B, Hq, Hkv, D, mk, s);
}

// The float32 workspace `repro_flash_attention_bwd` needs at this shape,
// in floats.
extern "C" long long repro_flash_attention_bwd_work(int dtype, int B, int Hq,
                                                    int Hkv, int Lq, int Lk,
                                                    int D) {
  return work_floats(dtype, B, Hq, Hkv, Lq, Lk, D);
}
