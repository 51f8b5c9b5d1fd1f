// Mamba2 selective-state-space scan (one B/C group), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssm_kernel`, launched by `ssm_scan` in
// src/repro/kernels/ssm_scan.py. Same function: per batch row and head, a
// float32 state h (P, N) starts at zero and for t = 0 .. L-1
//   h <- exp(dt_t a) h + (dt_t x_t) (x) B_t,     y_t = h C_t + D x_t;
// y is returned in x's dtype and the final h in float32.
//
// What bounds it on an H100: at zamba2's prefill shape (B 4, L 512, H 80,
// P 64, N 64, x/B/C bf16) one call moves ~48 MB (a 14 us byte bound).
// Two kernels:
//
// bf16 (`ssm_bf16_kernel`, serving): the chunked SSD form of the Pallas
// kernel on the tensor cores, `mma.sync.m16n8k16` (bf16 in, f32 sums). Per
// chunk of T = 64 steps and head, with s = cumsum(dt a) (inclusive):
//   G  = C B^T                                   (T x T, exact products)
//   M  = G exp(s_t - s_u) dt_u [u <= t]
//   y  = M x + exp(s_t) C h_in^T + D x
//   h  = exp(s_T) h_in + W^T B,   W_u = dt_u x_u exp(s_T - s_u).
// x, B and C are bf16 as given, so G's and every x/B/C operand are exact.
// M, h_in and W are float32 values; each goes to the tensor cores as two
// bf16 operands, hi = bf16(v) and lo = bf16(v - hi), in two products, which
// keeps ~16 bits: rounded once, M and h_in miss y's bar of 2e-2 (G's
// entries reach ~25 at N = 64 and y cancels) and W misses the float32
// state's 3e-4 (tests/test_torch_ssm.py models this arithmetic against a
// float64 oracle).
//   * one block of 4 warps per (head, 64 columns of P, batch row) walks the
//     chunks in order, the Pallas grid's sequential chunk axis; the state
//     stays in the accumulator fragments of the state product, warp w
//     holding rows p 16w .. 16w+15 by all of N;
//   * x, B and C are double-buffered in shared memory by chunk: the next
//     chunk's 16-byte cp.async copies are in flight while this one
//     computes (rows padded by 16 bytes so ldmatrix's 8 rows fall in
//     distinct bank quads); warp 0 scans dt a in registers, fetched a
//     chunk ahead;
//   * for y, warp w owns steps 16w .. 16w+15: its G tiles left of the
//     diagonal only, M split and re-packed in registers as the A operand
//     of M x (as flash re-packs P), the C h_in^T term from h_in's hi/lo
//     copies in shared memory, y stored from the accumulators;
//   * for h, W's A operand comes from x's tile by ldmatrix.trans and is
//     scaled and split in registers;
//   * N and P are padded with zeros to the instantiated widths (N to 16,
//     32, 64 or 128; P to 64 per block), and a ragged last chunk gets
//     dt = 0 and x = B = C = 0, which leaves the state as it was.
// At zamba2's shape: 320 blocks, ~1.5 M multiply-adds per (b, h, chunk)
// after the causal skip, ~6 GFLOP in all.
//
// float32 (`ssm_f32_kernel`): the CUDA-core kernel. Split bf16 operands
// would still round x, B and C, so it keeps full float32 FMAs on the
// sequential form: each (head, p) row is split over 4 neighbouring threads
// of a warp, each holding N/4 of its state values in registers (N padded to
// 16/32/64/128 with zero B and C); y_t's partial sums meet by two warp
// shuffles. A block covers 64 consecutive (head, p) rows of one batch row
// and stages 32 steps of its inputs in shared memory at a time.
//
// Plain C entry point, loaded with ctypes. It returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores, sequential form
// ---------------------------------------------------------------------------

constexpr int TCH = 32;  // steps staged at a time
constexpr int RB = 64;   // (head, p) rows per block
constexpr int S = 4;     // threads per row
constexpr int THREADS = RB * S;

// padded floats per staged step of B or C: 4 quarters of NS / 4 + 4
__host__ __device__ constexpr int ldb(int ns) { return S * (ns / S + 4); }

size_t f32_smem_bytes(int ns) {
  return sizeof(float) * static_cast<size_t>(TCH) * (2 * ldb(ns) + 2 * RB);
}

// x, y (B, L, H, P); dt (B, L, H); a, d (H,); bm, cm (B, L, N);
// hout (B, H, P, N). Block (64 rows j = h * P + p, batch row); thread
// (row, quarter s), holding state values n = s * NS/4 .. (s+1) * NS/4 - 1.
template <int NS>
__global__ void __launch_bounds__(THREADS)
    ssm_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const float* __restrict__ bm,
                   const float* __restrict__ cm,
                   const float* __restrict__ dskip, float* __restrict__ y,
                   float* __restrict__ hout, int L, int H, int P, int N) {
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
        bs[dst] = in ? bm[g] : 0.f;
        cs[dst] = in ? cm[g] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < TCH * RB / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int tt = e / RB, rr = e % RB;
      const long long t = static_cast<long long>(t0 + tt);
      xs[e] = tt < tn && rr < rows_in ? x[xbase + t * hp + rr] : 0.f;
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
        y[xbase + static_cast<long long>(t0 + tt) * hp + r] = part + xv * dh;
    }
  }

  if (!active) return;
  float* ho = hout + (static_cast<long long>(b) * hp + j) * N + s * NPT;
#pragma unroll
  for (int i = 0; i < NPT; ++i)
    if (s * NPT + i < N) ho[i] = st[i];
}

template <int NS>
int launch_f32(const void* x, const void* dt, const void* a, const void* bm,
               const void* cm, const void* d, void* y, void* hout, int B,
               int L, int H, int P, int N, cudaStream_t stream) {
  const long long rows = static_cast<long long>(H) * P;
  const dim3 grid(static_cast<unsigned>((rows + RB - 1) / RB), B);
  const size_t smem = f32_smem_bytes(NS);
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_f32_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_f32_kernel<NS><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(d),
      static_cast<float*>(y), static_cast<float*>(hout), L, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, chunked SSD form
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC = 64;                // steps per chunk
constexpr int PB = 64;                // columns of P per block
constexpr int TC_WARPS = 4;           // 16 steps (y) / 16 rows of P (h) each
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int PAD = 8;                // bf16 of padding per staged row
constexpr int LDP = PB + PAD;         // row stride of the [t][p] tiles
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int ldn(int np) { return np + PAD; }

// bf16 tiles: x (T x LDP), B and C (T x LDN), each double-buffered by
// chunk; h_in hi and lo (PB x LDN); then s (log2 units) and dt, T floats
// each
size_t bf16_smem_bytes(int np) {
  return sizeof(bf16) * (2 * static_cast<size_t>(TC) * LDP +
                         4 * static_cast<size_t>(TC) * ldn(np) +
                         2 * static_cast<size_t>(PB) * ldn(np)) +
         sizeof(float) * 2 * TC;
}

// Stage ROWS rows of WIDTH columns into `dst` (row stride `ld`): the
// first `valid` rows and `cols` columns from `src` (row stride `stride`
// elements), the rest zero. With `vec` by 16-byte cp.async copies, else by
// plain loads and stores.
template <int ROWS, int WIDTH>
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src,
                                      long long stride, int valid, int cols,
                                      bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CH = WIDTH / 8;
#pragma unroll
    for (int i = 0; i < (ROWS * CH + TC_THREADS - 1) / TC_THREADS; ++i) {
      const int slot = tid + i * TC_THREADS;
      const int r = slot / CH, c = (slot - r * CH) * 8;
      if (slot < ROWS * CH) {
        const bool in = r < valid && c < cols;
        cp_async16(dst + r * ld + c, in ? src + r * stride + c : src, in);
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < ROWS * WIDTH; e += TC_THREADS) {
      const int r = e / WIDTH, c = e - r * WIDTH;
      dst[r * ld + c] = r < valid && c < cols ? src[r * stride + c] : zero;
    }
  }
}

// NP: N padded with zeros to 16, 32, 64 or 128. Block (head, 64 columns of
// P, batch row).
template <int NP>
__global__ void __launch_bounds__(TC_THREADS)
    ssm_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a, const bf16* __restrict__ bm,
                    const bf16* __restrict__ cm,
                    const float* __restrict__ dskip, bf16* __restrict__ y,
                    float* __restrict__ hout, int L, int H, int P, int N,
                    int vec_x, int vec_bc) {
  constexpr int LDN = ldn(NP);
  constexpr int NT = NP / 8;    // 8-column tiles of the state
  constexpr int NK = NP / 16;   // k-steps over N
  constexpr int PT = PB / 8;    // 8-column tiles of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs0 = reinterpret_cast<bf16*>(smem_raw);  // 2 x [t][p]
  bf16* bs0 = xs0 + 2 * TC * LDP;                  // 2 x [t][n]
  bf16* cs0 = bs0 + 2 * TC * LDN;                  // 2 x [t][n]
  bf16* hhs = cs0 + 2 * TC * LDN;                  // [p][n] h_in hi
  bf16* hls = hhs + PB * LDN;                      // [p][n] h_in lo
  float* s2s = reinterpret_cast<float*>(hls + PB * LDN);  // s log2 units
  float* dts = s2s + TC;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  const int h = blockIdx.x, p0 = blockIdx.y * PB, b = blockIdx.z;
  const int pn = min(PB, P - p0);          // live columns of P
  const float a2 = a[h] * LOG2E;
  const float dh = dskip[h];
  const long long hp = static_cast<long long>(H) * P;
  const bf16* xb = x + static_cast<long long>(b) * L * hp +
                   static_cast<long long>(h) * P + p0;
  bf16* yb = y + static_cast<long long>(b) * L * hp +
             static_cast<long long>(h) * P + p0;
  const bf16* bb = bm + static_cast<long long>(b) * L * N;
  const bf16* cb = cm + static_cast<long long>(b) * L * N;
  const float* db = dt + static_cast<long long>(b) * L * H + h;

  // ldmatrix addresses: lane l gives row (l & 7) of matrix (l >> 3)
  const int lrow = lane & 7, lmat = lane >> 3;
  // A from a [m][k] tile: (m 0-7 | 8-15) x (k 0-7 | 8-15), m first
  const int a_row = ((lmat & 1) << 3) + lrow, a_col = (lmat >> 1) << 3;
  // B from a [n][k] tile, two n-tiles: (n 0-7, k 0-7), (n 0-7, k 8-15),
  // (n 8-15, k 0-7), (n 8-15, k 8-15)
  const int k_row = ((lmat >> 1) << 3) + lrow, k_col = (lmat & 1) << 3;
  // B from a [k][n] tile (.trans), two n-tiles: (k 0-7, n 0-7),
  // (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15); and A from a
  // [k][m] tile (.trans): (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
  // (k 8-15, m 8-15)
  const int v_row = ((lmat & 1) << 3) + lrow, v_col = (lmat >> 1) << 3;
  const int at_row = ((lmat >> 1) << 3) + lrow, at_col = (lmat & 1) << 3;

  const int wrow = warp * 16;  // the warp's steps (y) and rows of P (h)
  float st[NT][4];             // the state, rows p wrow + g, wrow + g + 8
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[n][e] = 0.f;

  // stage chunk `c`'s x, B and C into buffer c & 1
  const auto stage_chunk = [&](int c) {
    const int c0 = c * TC, cn = min(TC, L - c0);
    stage<TC, PB>(xs0 + (c & 1) * TC * LDP, LDP,
                  xb + static_cast<long long>(c0) * hp, hp, cn, pn, vec_x);
    stage<TC, NP>(bs0 + (c & 1) * TC * LDN, LDN,
                  bb + static_cast<long long>(c0) * N, N, cn, N, vec_bc);
    stage<TC, NP>(cs0 + (c & 1) * TC * LDN, LDN,
                  cb + static_cast<long long>(c0) * N, N, cn, N, vec_bc);
  };
  stage_chunk(0);
  // warp 0 holds the next chunk's dt (steps 2 lane, 2 lane + 1)
  const auto load_dt = [&](int c0, float& da, float& dbv) {
    const int ta = 2 * lane, cn = min(TC, L - c0);
    da = ta < cn ? db[static_cast<long long>(c0 + ta) * H] : 0.f;
    dbv = ta + 1 < cn ? db[static_cast<long long>(c0 + ta + 1) * H] : 0.f;
  };
  float dnext[2] = {0.f, 0.f};
  if (warp == 0) load_dt(0, dnext[0], dnext[1]);

  for (int t0 = 0; t0 < L; t0 += TC) {
    const int tn = min(TC, L - t0);
    const int buf = (t0 / TC) & 1;
    const bf16* xs = xs0 + buf * TC * LDP;
    const bf16* bs = bs0 + buf * TC * LDN;
    const bf16* cs = cs0 + buf * TC * LDN;
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // this chunk has landed; the last chunk's readers
                      // are done
    // 1. prefetch the next chunk; warp 0 scans dt a; h_in's hi and lo parts
    if (t0 + TC < L) stage_chunk(t0 / TC + 1);
    if (warp == 0) {
      const int ta = 2 * lane, tb = ta + 1;
      const float da = dnext[0], dbv = dnext[1];
      if (t0 + TC < L) load_dt(t0 + TC, dnext[0], dnext[1]);
      const float la = da * a2, lb = dbv * a2;
      float sum = la + lb;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, sum, off);
        if (lane >= off) sum += o;
      }
      s2s[ta] = sum - lb;
      s2s[tb] = sum;
      dts[ta] = da;
      dts[tb] = dbv;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t4;
      uint32_t hi, lo;
      split_pair(st[n][0], st[n][1], hi, lo);
      *reinterpret_cast<uint32_t*>(hhs + (wrow + g) * LDN + col) = hi;
      *reinterpret_cast<uint32_t*>(hls + (wrow + g) * LDN + col) = lo;
      split_pair(st[n][2], st[n][3], hi, lo);
      *reinterpret_cast<uint32_t*>(hhs + (wrow + g + 8) * LDN + col) = hi;
      *reinterpret_cast<uint32_t*>(hls + (wrow + g + 8) * LDN + col) = lo;
    }
    __syncthreads();
    const float s2_last = s2s[TC - 1];

    // 2. y for steps wrow .. wrow + 15
    {
      uint32_t cf[NK][4];  // C's rows of these steps, the A operand
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        ldmatrix_x4(cf[kk], smem_u32(cs + (wrow + a_row) * LDN + kk * 16 +
                                     a_col));
      // exp(s_t) C h_in^T
      float yacc[PT][4];
#pragma unroll
      for (int n = 0; n < PT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int np = 0; np < PT / 2; ++np) {
          uint32_t bh[4], bl[4];
          const int off = (np * 16 + k_row) * LDN + kk * 16 + k_col;
          ldmatrix_x4(bh, smem_u32(hhs + off));
          ldmatrix_x4(bl, smem_u32(hls + off));
          mma_bf16(yacc[2 * np], cf[kk], bh[0], bh[1]);
          mma_bf16(yacc[2 * np + 1], cf[kk], bh[2], bh[3]);
          mma_bf16(yacc[2 * np], cf[kk], bl[0], bl[1]);
          mma_bf16(yacc[2 * np + 1], cf[kk], bl[2], bl[3]);
        }
      const int t_a = wrow + g, t_b = t_a + 8;  // this lane's two steps
      const float s2a = s2s[t_a], s2b = s2s[t_b];
      const float ea = exp2_approx(s2a), eb = exp2_approx(s2b);
#pragma unroll
      for (int n = 0; n < PT; ++n) {
        yacc[n][0] *= ea;
        yacc[n][1] *= ea;
        yacc[n][2] *= eb;
        yacc[n][3] *= eb;
      }
      // G = C B^T on the tiles left of the diagonal (u-pairs np <= warp),
      // then M = G exp(s_t - s_u) dt_u [u <= t], split into the A operands
      // of M x (k-step np covers u 16 np .. 16 np + 15)
      uint32_t mh[TC_WARPS][4], ml[TC_WARPS][4];
#pragma unroll
      for (int np = 0; np < TC_WARPS; ++np) {
        if (np > warp) continue;
        float gacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_u32(bs + (np * 16 + k_row) * LDN + kk * 16 +
                                   k_col));
          mma_bf16(gacc[0], cf[kk], bk[0], bk[1]);
          mma_bf16(gacc[1], cf[kk], bk[2], bk[3]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int u0 = np * 16 + half * 8 + 2 * t4, u1 = u0 + 1;
          const float f0 = dts[u0], f1 = dts[u1];
          const float s0 = s2s[u0], s1 = s2s[u1];
          const float* gv = gacc[half];
          const float m00 =
              u0 <= t_a ? gv[0] * f0 * exp2_approx(s2a - s0) : 0.f;
          const float m01 =
              u1 <= t_a ? gv[1] * f1 * exp2_approx(s2a - s1) : 0.f;
          const float m10 =
              u0 <= t_b ? gv[2] * f0 * exp2_approx(s2b - s0) : 0.f;
          const float m11 =
              u1 <= t_b ? gv[3] * f1 * exp2_approx(s2b - s1) : 0.f;
          // a0/a1 (rows g, g + 8) for keys 0-7 of the k-step, a2/a3 for 8-15
          split_pair(m00, m01, mh[np][half * 2], ml[np][half * 2]);
          split_pair(m10, m11, mh[np][half * 2 + 1], ml[np][half * 2 + 1]);
        }
      }
      // + M x
#pragma unroll
      for (int kk = 0; kk < TC_WARPS; ++kk) {
        if (kk > warp) continue;
#pragma unroll
        for (int np = 0; np < PT / 2; ++np) {
          uint32_t bx[4];
          ldmatrix_x4_trans(bx, smem_u32(xs + (kk * 16 + v_row) * LDP +
                                         np * 16 + v_col));
          mma_bf16(yacc[2 * np], mh[kk], bx[0], bx[1]);
          mma_bf16(yacc[2 * np + 1], mh[kk], bx[2], bx[3]);
          mma_bf16(yacc[2 * np], ml[kk], bx[0], bx[1]);
          mma_bf16(yacc[2 * np + 1], ml[kk], bx[2], bx[3]);
        }
      }
      // + D x, rounded to bf16 and stored, rows t < tn, columns p < pn
#pragma unroll
      for (int n = 0; n < PT; ++n) {
        const int col = n * 8 + 2 * t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = r ? t_b : t_a;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + t * LDP + col));
          const __nv_bfloat162 yv =
              __floats2bfloat162_rn(fmaf(dh, xv.x, yacc[n][2 * r]),
                                    fmaf(dh, xv.y, yacc[n][2 * r + 1]));
          bf16* yr = yb + static_cast<long long>(t0 + t) * hp + col;
          if (t < tn && vec_x) {
            if (col < pn) *reinterpret_cast<__nv_bfloat162*>(yr) = yv;
          } else if (t < tn) {
            if (col < pn) yr[0] = yv.x;
            if (col + 1 < pn) yr[1] = yv.y;
          }
        }
      }
    }

    // 3. h <- exp(s_T) h + W^T B for rows p wrow .. wrow + 15, with
    // W = dt x exp(s_T - s) split into hi and lo A operands in registers
    {
      const float decay = exp2_approx(s2_last);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] *= decay;
#pragma unroll
      for (int kk = 0; kk < TC / 16; ++kk) {
        if (kk * 16 >= tn) break;  // zero rows of a ragged chunk
        uint32_t xf[4], ah[4], al[4];
        ldmatrix_x4_trans(xf, smem_u32(xs + (kk * 16 + at_row) * LDP + wrow +
                                       at_col));
        // xf[0], xf[1]: steps 16 kk + 2 t4 (+1); xf[2], xf[3]: 8 more
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int u = kk * 16 + 2 * t4 + (r >> 1) * 8;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&xf[r]));
          split_pair(xv.x * dts[u] * exp2_approx(s2_last - s2s[u]),
                     xv.y * dts[u + 1] * exp2_approx(s2_last - s2s[u + 1]),
                     ah[r], al[r]);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_u32(bs + (kk * 16 + v_row) * LDN +
                                         np * 16 + v_col));
          mma_bf16(st[2 * np], ah, bv[0], bv[1]);
          mma_bf16(st[2 * np + 1], ah, bv[2], bv[3]);
          mma_bf16(st[2 * np], al, bv[0], bv[1]);
          mma_bf16(st[2 * np + 1], al, bv[2], bv[3]);
        }
      }
    }
  }

  // the final state, rows p < P and columns n < N
  float* ho = hout + (static_cast<long long>(b) * H + h) * P * N;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + wrow + g + (e >> 1) * 8;
      const int col = n * 8 + 2 * t4 + (e & 1);
      if (p < P && col < N) ho[static_cast<long long>(p) * N + col] = st[n][e];
    }
  }
}

template <int NP>
int launch_bf16(const void* x, const void* dt, const void* a, const void* bm,
                const void* cm, const void* d, void* y, void* hout, int B,
                int L, int H, int P, int N, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes(NP);
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_bf16_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec_x = P % 8 == 0 && aligned(x) && aligned(y);
  const int vec_bc = N % 8 == 0 && aligned(bm) && aligned(cm);
  const dim3 grid(H, (P + PB - 1) / PB, B);
  ssm_bf16_kernel<NP><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<const float*>(d),
      static_cast<bf16*>(y), static_cast<float*>(hout), L, H, P, N, vec_x,
      vec_bc);
  return static_cast<int>(cudaGetLastError());
}

// N goes to the first instantiated width that holds it
#define REPRO_SSM_DISPATCH(LAUNCH)                                         \
  if (N <= 16) return LAUNCH<16>(x, dt, a, bm, cm, d, y, hout, B, L, H, P, \
                                 N, s);                                     \
  if (N <= 32) return LAUNCH<32>(x, dt, a, bm, cm, d, y, hout, B, L, H, P, \
                                 N, s);                                     \
  if (N <= 64) return LAUNCH<64>(x, dt, a, bm, cm, d, y, hout, B, L, H, P, \
                                 N, s);                                     \
  return LAUNCH<128>(x, dt, a, bm, cm, d, y, hout, B, L, H, P, N, s);

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
  if (dtype == 1) {
    REPRO_SSM_DISPATCH(launch_bf16)
  }
  REPRO_SSM_DISPATCH(launch_f32)
}
