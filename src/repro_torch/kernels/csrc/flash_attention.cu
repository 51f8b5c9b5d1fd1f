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
// cores); at llama-3.2-vision's cross attention (B 4, H 32 over 8, 512
// queries, 4096 keys, D 128) ~137 GFLOP against ~50 MB, so the longer
// prefills are bound by the tensor cores. Two kernels:
//
// bf16 (`flash_bf16_kernel`): FlashAttention-3's structure on wgmma and
// TMA (csrc/hopper.cuh), without its last two tricks.
//   * work tiles of (128 queries, q head, batch row), longest causal
//     tiles first; persistent blocks, one a multiprocessor, walk them in
//     rounds (left to right, then right to left, so long and short tiles
//     pair up). A block is a producer warpgroup, of which one warp issues
//     every load, and two consumer warpgroups of 64 query rows each;
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232). The producer is a whole warpgroup: ptxas sizes the block's
//     registers as for whole warpgroups (168 a thread), and the
//     consumers' increase waits for registers that the producer hands
//     back, which a lone warp's cannot cover, so the block would hang;
//   * the producer loads each tile's Q into one of two buffers (one at
//     D > 128) and keeps K and V tiles of BK keys (128, or 64 at D > 128
//     so that O's 128 floats a thread fit beside S) in flight through TMA,
//     in a ring of 3 stages at D <= 64 and 2 above, guarded by full
//     barriers (one for K, one for V, so S can start before V lands) and
//     an empty barrier per stage that all 256 consumer threads arrive on
//     when their products have read it. Ring and Q buffers run on across
//     a block's tiles, so the next tile's loads overlap this tile's last
//     products and its output store (a block per tile left each tile's
//     first loads and last store exposed: persistence was 7-16% faster at
//     the causal 512-token shapes and 2-4% slower at a few others, in one
//     call of tools/kernel_ab.py);
//   * q, k, v and o are (D, L, H, B) tensor maps with boxes of 64 columns
//     and 128-byte swizzle: a box past L reads zeros (not the next head's
//     rows) and columns past D read zeros, so D = 80 is two boxes whose
//     columns 80-127 are zero (the products skip them: S takes 5 k-steps
//     and P . V is m64n80), and D = 256 four; a ragged tile needs no
//     code. D % 8 != 0 or a base that is not 16-byte aligned fails TMA's
//     16-byte rule: the producer warp then stages the same swizzled tiles
//     with plain loads (stage_tile), and the consumers store O directly;
//   * S = Q . K^T is wgmma.m64nBKk16 with both operands read from shared
//     memory through descriptors (K-major); scale, softcap and the masks
//     (only on tiles that cross the diagonal, the window edge or the end of
//     the keys) and the exp2 online softmax act on the accumulator
//     fragments, a row's 32 values over the 4 lanes of a quad; a
//     warpgroup skips the products of a tile none of its rows can see;
//   * O += P . V is wgmma.m64nDPk16 with P from registers (the m64nN
//     accumulator rounded to bf16 in pairs is the A-register layout) and V
//     the MN-major B operand (the transpose bit), its 64-column boxes LBO
//     apart;
//   * the softcap's tanh is one special-function instruction in the
//     serving instance (tanh.approx, ~2^-11 relative: the exp2 of P and
//     the softcap then cost two where tanhf's sequence cost many) and two
//     in the training instance (tanh_fast, ~1e-7 absolute), whose
//     log-sum-exp the backward reads back against its own logits;
//   * the output is divided by l (0 -> 1), rounded to bf16, written into
//     the warpgroup's own rows of the Q tile in the swizzled layout, and
//     stored by TMA (rows past Lq and columns past D are not written).
//   * ping-pong of the two warpgroups (csrc/hopper.cuh): each issues its S
//     only on its turn and then hands the turn over, so one warpgroup's
//     softmax runs under the other's products; without it both wait on
//     the same barrier, issue together and do their softmax together with
//     the tensor cores idle (with and without it in one call of
//     tools/kernel_ab.py, it was a few percent faster on most shapes);
//   Not done, for later: inside a warpgroup, issuing the next tile's S
//   before this tile's softmax (FlashAttention-3's intra-warpgroup
//   overlap), which needs a second S accumulator; not tried.
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

#include <chrono>

#include "hopper.cuh"

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
// bf16: tensor cores (wgmma), TMA, warp specialisation
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int WG_ROWS = 64;                   // query rows per warpgroup
constexpr int TC_BQ = 2 * WG_ROWS;            // query rows per block
constexpr int TC_CONSUMERS = 256;             // two consumer warpgroups
// and a producer warpgroup, of which one warp loads: the block's registers
// (168 a thread at 384 threads) rebalance exactly, the producer giving
// back 128 a thread (40 left) and the consumers taking 64 more (232)
constexpr int TC_THREADS = TC_CONSUMERS + 128;
constexpr float LOG2E = 1.4426950408889634f;

// DP: D padded to whole 64-column boxes (64, 128 or 256)
template <int DP>
struct FwdTile {
  static constexpr int BK = DP <= 128 ? 128 : 64;  // keys per tile
  // two Q buffers where they fit beside the ring, so that the next work
  // tile's Q lands while this one runs (one at D > 128)
  static constexpr int QBUF = DP <= 128 ? 2 : 1;
  static constexpr int STAGES = DP <= 64 ? 3 : 2;
  // QBUF Q tiles, then STAGES K tiles, then STAGES V tiles, then the
  // barriers; 1024 bytes of slack to align the tiles
  static constexpr size_t SMEM =
      1024 + sizeof(bf16) * (QBUF * TC_BQ * DP + 2 * STAGES * BK * DP) +
      sizeof(uint64_t) * (2 * QBUF + 3 * STAGES);
};

// One work tile: (128-query tile, q head, batch row) and the key tiles of
// BK that can be live for some row of it. Work w runs q head fastest, then
// batch row, then the q tiles from the last: the causal triangle's long
// tiles first, the short ones in the tail.

// The work tile of a block's round r: rounds of gridDim.x tiles, taken
// left to right in even rounds and right to left in odd ones, so that a
// block with a long tile in one round gets a short one in the next (the
// tiles run from long to short); -1 past the last.
__device__ __forceinline__ int fwd_round(int r, int n_work) {
  const int w = r * gridDim.x +
                ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return w < n_work ? w : -1;
}
struct FwdWork {
  int h, b, q0, k_begin, n_tiles;
};

__device__ __forceinline__ FwdWork fwd_work(int w, int Hq, int B, int n_qt,
                                            int Lq, int Lk, int causal,
                                            int has_window, int window,
                                            int BK) {
  FwdWork r;
  r.h = w % Hq;
  r.b = (w / Hq) % B;
  r.q0 = (n_qt - 1 - w / (Hq * B)) * TC_BQ;
  const int q_off = Lk - Lq;
  const int q_first = r.q0 + q_off;
  const int q_last = min(r.q0 + TC_BQ, Lq) - 1 + q_off;
  int k_begin = 0, k_end = Lk;
  if (causal) k_end = min(Lk, q_last + 1);
  if (has_window) k_begin = max(0, q_first - window + 1);
  r.k_begin = (k_begin / BK) * BK;
  r.n_tiles = k_end > r.k_begin ? (k_end - r.k_begin + BK - 1) / BK : 0;
  return r;
}

// DN <= DP: the columns computed, D rounded up to 16 (80) or to DP: S
// takes DN / 16 k-steps and P . V is m64nDN. Persistent: gridDim.x blocks
// (one a multiprocessor) walk the work tiles round by round (fwd_round);
// the producer's K/V ring and the Q buffers run on across them, so a
// tile's Q and first K/V tiles load while the last one computes and
// stores its output.
template <int DP, int DN, bool LSE>
__global__ void __launch_bounds__(TC_THREADS, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap o_map,
                      const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      int B, int Hq, int Hkv, int Lq, int Lk, int D,
                      int causal, int has_window, int window,
                      int has_softcap, float softcap, float scale, int tma,
                      float* __restrict__ lse) {
  constexpr int BK = FwdTile<DP>::BK, STAGES = FwdTile<DP>::STAGES;
  constexpr int QBUF = FwdTile<DP>::QBUF, BOXES = DP / 64;
  extern __shared__ unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  bf16* ks = qs + QBUF * TC_BQ * DP;  // STAGES tiles of BK x DP
  bf16* vs = ks + STAGES * BK * DP;   // STAGES tiles of BK x DP
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * BK * DP);
  uint64_t* q_empty = q_full + QBUF;
  uint64_t* k_full = q_empty + QBUF;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int tid = threadIdx.x, warp = warp_uniform(), lane = tid & 31;
  const int n_qt = (Lq + TC_BQ - 1) / TC_BQ, n_work = n_qt * Hq * B;
  const int q_off = Lk - Lq;

  if (tid == 0) {
    for (int i = 0; i < QBUF; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, 2);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, TC_CONSUMERS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= TC_CONSUMERS / 32) {
    // the producer: per work tile its Q, then its K and V tiles into the
    // ring; one lane issues TMA, or the warp stages
    reg_dealloc<40>();
    if (warp != TC_CONSUMERS / 32) return;  // the idle producer warps
    if (tma && lane != 0) return;
    int g = 0;  // key tiles loaded so far: the ring's position
    for (int ti = 0, w; (w = fwd_round(ti, n_work)) >= 0; ++ti) {
      const FwdWork t = fwd_work(w, Hq, B, n_qt, Lq, Lk, causal, has_window,
                                 window, BK);
      const int qb = ti % QBUF, hk = t.h / (Hq / Hkv);
      bf16* qd = qs + qb * TC_BQ * DP;
      if (ti >= QBUF) mbar_wait(q_empty + qb, (ti / QBUF - 1) & 1);
      if (tma) {
        mbar_expect_tx(q_full + qb, sizeof(bf16) * TC_BQ * DP);
        for (int x = 0; x < BOXES; ++x)
          tma_load_4d(qd + x * TC_BQ * 64, &q_map, q_full + qb, x * 64, t.q0,
                      t.h, t.b);
      } else {
        stage_tile<DP, TC_BQ>(
            qd, q + (static_cast<long long>(t.b) * Hq + t.h) * Lq * D, t.q0,
            Lq, D, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(q_full + qb);
      }
      const long long kv = (static_cast<long long>(t.b) * Hkv + hk) * Lk * D;
      for (int it = 0; it < t.n_tiles; ++it, ++g) {
        const int s = g % STAGES, kt = t.k_begin + it * BK;
        if (g >= STAGES) mbar_wait(empty + s, (g / STAGES - 1) & 1);
        if (tma) {
          mbar_expect_tx(k_full + s, sizeof(bf16) * BK * DP);
          for (int x = 0; x < BOXES; ++x)
            tma_load_4d(ks + (s * BOXES + x) * BK * 64, &k_map, k_full + s,
                        x * 64, kt, hk, t.b);
          mbar_expect_tx(v_full + s, sizeof(bf16) * BK * DP);
          for (int x = 0; x < BOXES; ++x)
            tma_load_4d(vs + (s * BOXES + x) * BK * 64, &v_map, v_full + s,
                        x * 64, kt, hk, t.b);
        } else {
          stage_tile<DP, BK>(ks + s * BK * DP, k + kv, kt, Lk, D, lane);
          __syncwarp();
          if (lane == 0) mbar_arrive(k_full + s);
          stage_tile<DP, BK>(vs + s * BK * DP, v + kv, kt, Lk, D, lane);
          __syncwarp();
          if (lane == 0) mbar_arrive(v_full + s);
        }
      }
    }
  } else {
    // a consumer warpgroup: 64 query rows of each work tile, each warp 16
    reg_alloc<232>();
    const int wg = warp >> 2;
    const int g4 = lane >> 2, t4 = lane & 3;
    const int rr = (warp & 3) * 16 + g4;  // this lane's rows rr, rr + 8
    // Without softcap (and with scale > 0) the max commutes with the
    // scale: S stays raw and exp2 takes s * sl - m * sl in one FMA. Else S
    // is mapped to log2 units first and sl = 1.
    const bool raw = !has_softcap && scale > 0.f;
    const float sl = raw ? scale * LOG2E : 1.f;
    const float inv_cap = has_softcap ? 1.f / softcap : 0.f;
    int g = 0;  // key tiles consumed so far: the ring's position
    ping_start(wg);
    for (int ti = 0, w; (w = fwd_round(ti, n_work)) >= 0; ++ti) {
      const FwdWork t = fwd_work(w, Hq, B, n_qt, Lq, Lk, causal, has_window,
                                 window, BK);
      const int qb = ti % QBUF;
      bf16* qt = qs + qb * TC_BQ * DP;  // the tile's Q, at its end its O
      const int wq0 = t.q0 + wg * WG_ROWS;  // the warpgroup's first row
      const int qp0 = wq0 + rr + q_off, qp1 = qp0 + 8;
      const bool has_rows = wq0 < Lq;
      const int wq_first = wq0 + q_off;
      const int wq_last = min(wq0 + WG_ROWS, Lq) - 1 + q_off;

      float oacc[DN / 2];
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) oacc[i] = 0.f;
      float m_r[2] = {-INFINITY, -INFINITY};  // running max of S
      float l_r[2] = {0.f, 0.f};  // this lane's part of the running sum

      mbar_wait(q_full + qb, (ti / QBUF) & 1);
      for (int it = 0; it < t.n_tiles; ++it, ++g) {
        const int s = g % STAGES, kt = t.k_begin + it * BK;
        const uint32_t phase = (g / STAGES) & 1;
        // whether any row of this warpgroup sees a key of the tile
        const bool live = has_rows && !(causal && kt > wq_last) &&
                          !(has_window && kt + BK - 1 <= wq_first - window);
        uint32_t pa[BK / 16][4];
        // S = Q . K^T: BK / 8 groups of 8 keys, 4 floats a lane each
        float sacc[BK / 2];
        mbar_wait(k_full + s, phase);
        ping_wait(wg);
        if (live) {
          const bf16* kc = ks + s * BK * DP;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DN / 16; ++kk)
            Wgmma<BK>::ss(
                sacc,
                desc_sw128(qt + (kk >> 2) * TC_BQ * 64 + wg * WG_ROWS * 64 +
                               (kk & 3) * 16,
                           16, 1024),
                desc_sw128(kc + (kk >> 2) * BK * 64 + (kk & 3) * 16, 16,
                           1024),
                kk > 0);
          wgmma_commit();
        }
        ping_pass(wg);
        if (live) {
          wgmma_wait<0>();
          fence_regs(sacc);

          if (!raw) {  // scale and softcap, in log2 units
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
              const float x = sacc[i] * scale;
              const float c = LSE ? tanh_fast(x * inv_cap)
                                  : tanh_approx(x * inv_cap);
              sacc[i] = (has_softcap ? softcap * c : x) * LOG2E;
            }
          }
          // masks, only on tiles that hold a dead (row, key) pair
          const bool need_mask = kt + BK > Lk ||
                                 (causal && kt + BK - 1 > wq_first) ||
                                 (has_window && kt <= wq_last - window);
          if (need_mask) {
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
              const int kp = kt + (i >> 2) * 8 + 2 * t4 + (i & 1);
              const int qp = (i & 2) ? qp1 : qp0;
              const bool ok = kp < Lk && (!causal || kp <= qp) &&
                              (!has_window || kp > qp - window);
              if (!ok) sacc[i] = -INFINITY;
            }
          }

          // online softmax; a quad's 4 lanes hold one row
          float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * n], sacc[4 * n + 1]));
            mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
          }
          float mu[2], alpha[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            // a row with no live key so far keeps -inf; subtract 0 there
            // so its p and alpha come out 0, not NaN
            mu[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl;
            alpha[r] = exp2_approx(m_r[r] * sl - mu[r]);
            m_r[r] = mx[r];
          }
          // P in bf16 as the A operand of P . V: k-step j covers key
          // groups 2j (a0 row g, a1 row g + 8) and 2j + 1 (a2, a3)
          float rs[2] = {0.f, 0.f};
#pragma unroll
          for (int n = 0; n < BK / 8; ++n) {
            const float p0 = exp2_approx(fmaf(sacc[4 * n], sl, -mu[0]));
            const float p1 = exp2_approx(fmaf(sacc[4 * n + 1], sl, -mu[0]));
            const float p2 = exp2_approx(fmaf(sacc[4 * n + 2], sl, -mu[1]));
            const float p3 = exp2_approx(fmaf(sacc[4 * n + 3], sl, -mu[1]));
            rs[0] += p0 + p1;
            rs[1] += p2 + p3;
            pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
            pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
          for (int n = 0; n < DN / 8; ++n) {
            oacc[4 * n] *= alpha[0];
            oacc[4 * n + 1] *= alpha[0];
            oacc[4 * n + 2] *= alpha[1];
            oacc[4 * n + 3] *= alpha[1];
          }
        }
        mbar_wait(v_full + s, phase);
        if (live) {
          // O += P . V, V MN-major: a k-step is 16 key rows, 2048 bytes
          const bf16* vc = vs + s * BK * DP;
          fence_regs(oacc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            Wgmma<DN>::rs(oacc, pa[kk],
                          desc_sw128(vc + kk * 16 * 64, BK * 128, 1024), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(oacc);
          fence_regs(pa);
        }
        mbar_arrive(empty + s);
      }

      // finalize: O / l (0 -> 1)
      float den[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = l_r[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        den[r] = l == 0.f ? 1.f : l;
        // the row's log-sum-exp of the scaled (softcapped) logits: m_r is
        // in raw units (times scale) or in log2 units (times ln 2)
        const int qr = wq0 + rr + 8 * r;
        if (LSE && t4 == 0 && qr < Lq)
          lse[(static_cast<long long>(t.b) * Hq + t.h) * Lq + qr] =
              l == 0.f ? LSE_DEAD
                       : m_r[r] * (raw ? scale : 1.f / LOG2E) + logf(l);
      }
      if (tma) {
        // bf16 into the warpgroup's own rows of the tile's Q buffer (its
        // last reads of them are done), swizzled as TMA stores them: row
        // rr's 16-byte chunk c at c ^ (rr % 8)
        bf16* os = qt + wg * WG_ROWS * 64;
#pragma unroll
        for (int n = 0; n < DN / 8; ++n) {
          bf16* box = os + (n >> 3) * TC_BQ * 64;
          const int c = (((n & 7) ^ (rr & 7)) << 3) + 2 * t4;
          *reinterpret_cast<__nv_bfloat162*>(box + rr * 64 + c) =
              __floats2bfloat162_rn(oacc[4 * n] / den[0],
                                    oacc[4 * n + 1] / den[0]);
          *reinterpret_cast<__nv_bfloat162*>(box + (rr + 8) * 64 + c) =
              __floats2bfloat162_rn(oacc[4 * n + 2] / den[1],
                                    oacc[4 * n + 3] / den[1]);
        }
        fence_proxy_async();
        named_sync(1 + wg, 128);
        if ((tid & 127) == 0) {
          if (has_rows) {
            for (int x = 0; x < BOXES; ++x)
              tma_store_4d(&o_map, os + x * TC_BQ * 64, x * 64, wq0, t.h,
                           t.b);
            tma_store_wait();
          }
          mbar_arrive(q_empty + qb);  // the store has read the buffer
        }
      } else {
        bf16* ob = o + (static_cast<long long>(t.b) * Hq + t.h) * Lq * D;
#pragma unroll
        for (int i = 0; i < DN / 2; ++i) {
          const int row = wq0 + rr + 8 * ((i >> 1) & 1);
          const int col = (i >> 2) * 8 + 2 * t4 + (i & 1);
          if (row < Lq && col < D)
            ob[static_cast<long long>(row) * D + col] =
                __float2bfloat16(oacc[i] / den[(i >> 1) & 1]);
        }
        named_sync(1 + wg, 128);  // every thread's reads of Q are done
        if ((tid & 127) == 0) mbar_arrive(q_empty + qb);
      }
    }
    ping_end(wg);
  }
}

template <int DP, int DN>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hkv, int Lq, int Lk, int D,
                int causal, int has_window, int window, int has_softcap,
                float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = FwdTile<DP>::SMEM;
  const auto kernel = lse != nullptr ? flash_bf16_kernel<DP, DN, true>
                                     : flash_bf16_kernel<DP, DN, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tma = tma_ok(q, D) && tma_ok(k, D) && tma_ok(v, D) &&
                  tma_ok(o, D);
  CUtensorMap maps[4] = {};  // unused (zero) on the staging path
  if (tma) {
    int bad = make_map(&maps[0], q, B, Hq, Lq, D, TC_BQ);
    bad = bad ? bad : make_map(&maps[1], k, B, Hkv, Lk, D, FwdTile<DP>::BK);
    bad = bad ? bad : make_map(&maps[2], v, B, Hkv, Lk, D, FwdTile<DP>::BK);
    bad = bad ? bad : make_map(&maps[3], o, B, Hq, Lq, D, WG_ROWS);
    if (bad) return bad;
  }
  // persistent: at most one block a multiprocessor
  const long long work =
      static_cast<long long>((Lq + TC_BQ - 1) / TC_BQ) * Hq * B;
  const int blocks = static_cast<int>(
      work < multiprocessors() ? work : multiprocessors());
  kernel<<<blocks, TC_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), B, Hq, Hkv, Lq, Lk, D, causal, has_window,
      window, has_softcap, softcap, scale, tma, lse);
  return static_cast<int>(cudaGetLastError());
}

// D goes to the first (boxes, computed columns) that holds it: zamba2's
// D = 80 loads two boxes and computes 80 columns, not 128
int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int Hq, int Hkv, int Lq, int Lk, int D,
                  int causal, int has_window, int window, int has_softcap,
                  float softcap, float scale, cudaStream_t s) {
#define REPRO_FLASH_BF16(DP, DN)                                            \
  if (D <= DN)                                                              \
    return launch_bf16<DP, DN>(q, k, v, o, lse, B, Hq, Hkv, Lq, Lk, D,      \
                               causal, has_window, window, has_softcap,     \
                               softcap, scale, s);
  REPRO_FLASH_BF16(64, 64)
  REPRO_FLASH_BF16(128, 80)
  REPRO_FLASH_BF16(128, 128)
  REPRO_FLASH_BF16(256, 256)
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

// The host time of encoding one tensor map of a bf16 (B, H, L, D) tensor
// at `p`, in microseconds, the mean of `iters` encodings (a bf16 forward
// call encodes four). Negative if an encoding failed.
extern "C" double repro_flash_tensor_map_us(const void* p, int B, int H,
                                            int L, int D, int iters) {
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i)
    if (make_map(&map, p, B, H, L, D, 64)) return -1.0;
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::micro>(t1 - t0).count() / iters;
}
