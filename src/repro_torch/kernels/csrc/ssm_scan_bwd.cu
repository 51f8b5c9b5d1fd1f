// The gradient of the Mamba2 selective-state-space scan (one B/C group),
// for Hopper (sm_90a).
//
// Replaces the gradient of the Pallas TPU kernel `_ssm_kernel`, launched by
// `ssm_scan` in src/repro/kernels/ssm_scan.py (the reference has no Pallas
// backward: JAX differentiates its scan). The forward, per batch row and
// head, from h_{-1} = 0:
//   h_t = e_t h_{t-1} + dt_t x_t (x) B_t,  e_t = exp(dt_t a),
//   y_t = h_t C_t + D x_t.
// Given dy and the final state's cotangent G (null: zero), the reverse scan
//   dh_t = dy_t (x) C_t + e_{t+1} dh_{t+1}    (dh_{L-1} = G + dy (x) C)
// gives
//   dx_t  = D dy_t + dt_t dh_t B_t
//   ddt_t = sum_{p,n} dh_t (a e_t h_{t-1} + x_t (x) B_t)
//   da    = sum_t dt_t e_t sum dh_t h_{t-1}
//   dB_t  = sum_{h,p} dt_t x_t dh_t,   dC_t = sum_{h,p} dy_t h_t
//   dD    = sum dy x.
//
// What bounds it on an H100: at zamba2's training shape (B 4, L 1024,
// H 80, P 64, N 64, bf16) the inputs and gradients are ~0.2 GB (a ~0.06 ms
// byte bound); the step-by-step reverse scan is ~17 FLOPs per state
// element and step (~23 GFLOP), which even the CUDA cores' float32 peak
// takes ~0.34 ms for. Two designs, selected by dtype:
//
// bf16: the chunked (SSD) form on the tensor cores, `mma.sync.m16n8k16`
// (bf16 operands, float32 sums), the forward's notation (csrc/ssm_scan.cu).
// Per chunk of T = 64 steps and head, s = cumsum(dt a), S = s_{T-1},
// G = C B^T (shared by all heads), K = G exp(s_t - s_u) [u <= t],
// M = K dt_u and W_u = dt_u x_u exp(S - s_u):
//   h_out  = exp(S) h_in + W^T B;      dh_in = exp(S) dh_out + Z,
//   Z      = (exp(s) dy)^T C;
//   dM     = dy x^T,  dG = sum_heads dM exp(s_t - s_u) dt_u [u <= t];
//   dx     = M^T dy + dt_u exp(S - s_u) (B dh_out^T)_u + D dy;
//   dC     = dG B + sum_heads exp(s_t) dy_t h_in;
//   dB     = dG^T C + sum_heads W dh_out;
//   ds_t   = exp(s_t) dy_t . (C h_in^T)_t + sum_u (dM K)_tu dt_u
//            - dt_t (colK_t + q_t),   colK_u = sum_t (dM K)_tu,
//            q_u = exp(S - s_u) x_u . (B dh_out^T)_u,
//   ds_{T-1} += exp(S) sum dh_out h_in + sum_u dt_u q_u;
//   ddt_t  = colK_t + q_t + a sum_{t' >= t} ds_t',
//   da     = sum dt_t sum_{t' >= t} ds_t'.
// (tests/test_torch_scan_backward.py models this arithmetic on the CPU
// against jax.grad of the reference's sequential scan.) Four launches:
//   1. states: grid (chunk, group of 4 heads, batch row), every chunk at
//      once: each chunk's local W^T B and Z into the workspace (float32),
//      and exp(S); the next head's x and dy staged while one computes;
//   2. pass: grid (batch row x head, 64-row slab of P): the chunks in
//      order turn the local W^T B into each chunk's h_in, then in reverse
//      the local Z into each chunk's dh_out (from the final state's
//      cotangent), each rewritten in place as bf16 hi and lo operands (a
//      chunk's loads issued while the last one is written); 16 P x N
//      AXPYs per pass at L = 1024;
//   3. main: grid (chunk, group of 4 heads, batch row), every chunk at
//      once: per head the products above (and exp(S) sum dh_out h_in on
//      the CUDA cores), dG summed over the block's heads; dx and ddt
//      written, dB, dC, da, dD as per-block partials;
//   4. reduce: the partials summed in a fixed order.
// No atomics anywhere, so two runs give the same bits. x, B, C and dy are
// bf16 as given, so every product of two of them (G, dM) is exact; a
// float32 operand (W, exp(s) dy, M, h_in, dh_out, dG) goes in as bf16
// hi = bf16(v) and lo = bf16(v - hi) in two products (~16 bits): rounded
// once, each misses a bar of the card's check (the float32 ddt and da at
// 1e-4 of their largest entry, or the bf16 dx, dB, dC rows at 1e-2), as
// the CPU model shows. The states are recomputed, not stored by the
// forward; the workspace holds two float32 (B, chunks, H, P, N) state
// arrays (84 MB each at zamba2's shape) and the (B, L, H/4, N) partials.
// Tiles are staged by 16-byte cp.async (rows padded by 16 bytes so
// ldmatrix's 8 rows fall in distinct bank quads). The main kernel's block
// (4 warps, ~95 KB of shared memory at N = 64) leaves room for a second
// on its SM, whose products run while the first waits for its copies
// (measured faster than staging the next head a head ahead in one block
// of twice the memory, and than 8 or 16 heads a block). A
// ragged last chunk stages dt = 0 and x = B = C = dy = 0 past L; P and N
// are padded with zeros to slabs of 64 and to 16, 32, 64 or 128.
//
// float32: the sequential form on the CUDA cores, float32 throughout
// (split bf16 operands would round x, B and C):
//   * one block of 256 threads per (16 rows of P, head, batch row); a row
//     is split over 16 threads, each holding NP/16 state values of it in
//     registers (N padded with zeros to NP = 16, 32, 64 or 128);
//   * the states are recomputed, not stored by the forward: the block
//     first runs the forward recurrence and writes its state at the start
//     of every segment of K steps (K * NP/16 = 64 values of history a
//     thread) to a workspace; then it walks the segments backwards, each
//     time replaying its K steps from the checkpoint into registers and
//     running the reverse scan over them;
//   * dx sums over the 16 threads of a row (warp shuffles); dB, dC and ddt
//     sum over rows and heads, which lie in other threads and blocks: each
//     block sums its rows (shuffles, then its 8 warps in shared memory, in
//     a fixed order) and writes per-block partials, and a second kernel
//     sums those in a fixed order. No atomics anywhere, so two runs give
//     the same bits; da and dd the same way;
//   * a ragged last segment stages dt = 0 and x = B = C = dy = 0 past L:
//     its steps change no state and are neither scanned nor written.
//
// Plain C entry points, loaded with ctypes. The launcher returns
// cudaGetLastError() after the launches, so a refused launch is reported
// to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int RP = 16;               // rows of P per block
constexpr int LANES = 16;            // threads per row
constexpr int THREADS = RP * LANES;  // 256
constexpr int WARPS = THREADS / 32;
constexpr int HIST = 64;             // values of state history a thread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// the state values a thread holds and the steps of a segment
__host__ __device__ constexpr int npt(int np) { return np / LANES; }
__host__ __device__ constexpr int seg_len(int np) { return HIST / npt(np); }

// shared memory (floats): x, dy, dx [K][RP]; B, C [K][NP]; dt, e [K]; the
// warps' dB and dC partials [K][WARPS][NP]; their ddt partials [K][WARPS];
// 2 x WARPS for the block's da and dd
__host__ __device__ constexpr int smem_floats(int np) {
  return 3 * seg_len(np) * RP + 2 * seg_len(np) * np + 2 * seg_len(np) +
         2 * seg_len(np) * WARPS * np + seg_len(np) * WARPS + 2 * WARPS;
}

int pad_n(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128; }

// workspace (floats): checkpoints, then the partial sums of dB, dC, ddt,
// da and dd
struct Work {
  long long ckpt, pdb, pdc, pddt, pda, pdd, total;
  Work(int B, int L, int H, int P, int N) {
    const int np = pad_n(N), pt = (P + RP - 1) / RP;
    const long long blocks = static_cast<long long>(B) * H * pt;
    const long long nseg = (L + seg_len(np) - 1) / seg_len(np);
    ckpt = 0;
    pdb = ckpt + blocks * nseg * THREADS * npt(np);
    pdc = pdb + static_cast<long long>(B) * L * H * pt * N;
    pddt = pdc + static_cast<long long>(B) * L * H * pt * N;
    pda = pddt + static_cast<long long>(B) * L * H * pt;
    pdd = pda + blocks;
    total = pdd + blocks;
  }
};

// Block (16 rows of P, head, batch row); thread (row r, lane q of the
// row), holding state values n = q * NPT .. q * NPT + NPT - 1.
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS)
    ssm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const T* __restrict__ bm,
                   const T* __restrict__ cm, const float* __restrict__ dskip,
                   const T* __restrict__ dy,
                   const float* __restrict__ dstate, T* __restrict__ dx,
                   float* __restrict__ ckpt, float* __restrict__ pdb,
                   float* __restrict__ pdc, float* __restrict__ pddt,
                   float* __restrict__ pda, float* __restrict__ pdd, int L,
                   int H, int P, int N) {
  constexpr int NPT = npt(NP);
  constexpr int K = seg_len(NP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);  // [K][RP]
  float* dys = xs + K * RP;                         // [K][RP]
  float* dxs = dys + K * RP;                        // [K][RP]
  float* bs = dxs + K * RP;                         // [K][NP]
  float* cs = bs + K * NP;                          // [K][NP]
  float* dts = cs + K * NP;                         // [K]
  float* es = dts + K;                              // [K]
  float* pbs = es + K;                              // [K][WARPS][NP]
  float* pcs = pbs + K * WARPS * NP;                // [K][WARPS][NP]
  float* pts = pcs + K * WARPS * NP;                // [K][WARPS]
  float* red = pts + K * WARPS;                     // [2][WARPS]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid / LANES, q = tid % LANES;
  const int pt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int npts = gridDim.x;
  const int p0 = pt * RP, p = p0 + r;
  const float ah = a[h], dh_skip = dskip[h];
  const long long hp = static_cast<long long>(H) * P;
  const long long xoff = static_cast<long long>(b) * L * hp +
                         static_cast<long long>(h) * P + p0;
  const T* bb = bm + static_cast<long long>(b) * L * N;
  const T* cb = cm + static_cast<long long>(b) * L * N;
  const float* dtb = dt + static_cast<long long>(b) * L * H + h;
  const int nseg = (L + K - 1) / K;
  const long long blk = (static_cast<long long>(b) * H + h) * npts + pt;
  float* ck = ckpt + blk * nseg * THREADS * NPT + tid * NPT;

  // stage steps t0 .. t0 + kn - 1 (zeros past them and past P and N);
  // dy and C only for the reverse scan
  const auto stage = [&](int t0, int kn, bool back) {
    for (int e = tid; e < K * RP; e += THREADS) {
      const int i = e / RP, rr = e - i * RP;
      const bool in = i < kn && p0 + rr < P;
      const long long off = xoff + static_cast<long long>(t0 + i) * hp + rr;
      xs[e] = in ? to_f(x[off]) : 0.f;
      if (back) dys[e] = in ? to_f(dy[off]) : 0.f;
    }
    for (int e = tid; e < K * NP; e += THREADS) {
      const int i = e / NP, n = e - i * NP;
      const bool in = i < kn && n < N;
      const long long off = static_cast<long long>(t0 + i) * N + n;
      bs[e] = in ? to_f(bb[off]) : 0.f;
      if (back) cs[e] = in ? to_f(cb[off]) : 0.f;
    }
    for (int i = tid; i < K; i += THREADS) {
      const float d = i < kn ? dtb[static_cast<long long>(t0 + i) * H] : 0.f;
      dts[i] = d;
      es[i] = expf(d * ah);
    }
  };
  // one forward step of this thread's state values
  const auto advance = [&](float (&st)[NPT], int i) {
    const float e = es[i], u = dts[i] * xs[i * RP + r];
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      st[j] = fmaf(st[j], e, u * bs[i * NP + q * NPT + j]);
  };

  // 1. the forward recurrence, checkpointed at the start of each segment
  float st[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) st[j] = 0.f;
  for (int s = 0; s < nseg; ++s) {
    const int t0 = s * K, kn = min(K, L - t0);
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      ck[static_cast<long long>(s) * THREADS * NPT + j] = st[j];
    __syncthreads();  // the last segment's readers are done
    stage(t0, kn, false);
    __syncthreads();
    for (int i = 0; i < kn; ++i) advance(st, i);
  }

  // 2. the reverse scan, one segment at a time from its checkpoint
  float dh[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int n = q * NPT + j;
    dh[j] = dstate != nullptr && p < P && n < N
                ? dstate[((static_cast<long long>(b) * H + h) * P + p) * N +
                         n]
                : 0.f;
  }
  float da_acc = 0.f, dd_acc = 0.f;
  const int hb = h * npts + pt, nhb = H * npts;
  for (int s = nseg - 1; s >= 0; --s) {
    const int t0 = s * K, kn = min(K, L - t0);
    __syncthreads();  // the last segment's readers are done
    stage(t0, kn, true);
    __syncthreads();
    float hist[K][NPT];  // h_{t-1} of each step of the segment
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      st[j] = ck[static_cast<long long>(s) * THREADS * NPT + j];
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int j = 0; j < NPT; ++j) hist[i][j] = st[j];
      advance(st, i);
    }
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      if (i >= kn) continue;  // past L (the same for the whole block)
      const float e = es[i], dtv = dts[i];
      const float xv = xs[i * RP + r], dyv = dys[i * RP + r];
      const float u = dtv * xv;
      float dxp = 0.f, ddtp = 0.f, dap = 0.f, pb[NPT], pc[NPT];
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        const int n = q * NPT + j;
        const float bv = bs[i * NP + n], cv = cs[i * NP + n];
        const float hprev = hist[i][j];
        dh[j] = fmaf(dyv, cv, dh[j]);
        pc[j] = dyv * fmaf(hprev, e, u * bv);
        pb[j] = u * dh[j];
        dxp = fmaf(dh[j], bv, dxp);
        dap = fmaf(dh[j], hprev, dap);
        ddtp = fmaf(dh[j], xv * bv, ddtp);
        dh[j] *= e;
      }
      ddtp = fmaf(ah * e, dap, ddtp);
      da_acc = fmaf(dtv * e, dap, da_acc);
      if (q == 0) dd_acc = fmaf(dyv, xv, dd_acc);
      // dx: the row's 16 threads
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1)
        dxp += __shfl_xor_sync(FULL, dxp, off);
      if (q == 0) dxs[i * RP + r] = fmaf(dh_skip, dyv, dtv * dxp);
      // dB, dC: the warp's two rows, then the block's warps below
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        pb[j] += __shfl_xor_sync(FULL, pb[j], 16);
        pc[j] += __shfl_xor_sync(FULL, pc[j], 16);
      }
      if (lane < LANES) {
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          pbs[(i * WARPS + warp) * NP + q * NPT + j] = pb[j];
          pcs[(i * WARPS + warp) * NP + q * NPT + j] = pc[j];
        }
      }
      // ddt: the warp's 32 threads
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        ddtp += __shfl_xor_sync(FULL, ddtp, off);
      if (lane == 0) pts[i * WARPS + warp] = ddtp;
    }
    __syncthreads();
    // the segment's dx rows and the block's partial sums, warps in order
    for (int e = tid; e < kn * RP; e += THREADS) {
      const int i = e / RP, rr = e - i * RP;
      if (p0 + rr < P)
        dx[xoff + static_cast<long long>(t0 + i) * hp + rr] =
            from_f<T>(dxs[e]);
    }
    for (int e = tid; e < kn * N; e += THREADS) {
      const int i = e / N, n = e - i * N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        sb += pbs[(i * WARPS + w) * NP + n];
        sc += pcs[(i * WARPS + w) * NP + n];
      }
      const long long o =
          ((static_cast<long long>(b) * L + t0 + i) * nhb + hb) * N + n;
      pdb[o] = sb;
      pdc[o] = sc;
    }
    for (int i = tid; i < kn; i += THREADS) {
      float sdt = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sdt += pts[i * WARPS + w];
      pddt[(static_cast<long long>(b) * L + t0 + i) * nhb + hb] = sdt;
    }
  }

  // the block's da and dd
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    da_acc += __shfl_xor_sync(FULL, da_acc, off);
    dd_acc += __shfl_xor_sync(FULL, dd_acc, off);
  }
  if (lane == 0) {
    red[warp] = da_acc;
    red[WARPS + warp] = dd_acc;
  }
  __syncthreads();
  if (tid == 0) {
    float sa = 0.f, sd = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      sa += red[w];
      sd += red[WARPS + w];
    }
    pda[blk] = sa;
    pdd[blk] = sd;
  }
}

// The partial sums in a fixed order: one thread per element of dB and dC
// (over the H x PT blocks of a batch row), of ddt (over a head's PT
// blocks), then of da and dd (over B x PT).
template <typename T>
__global__ void ssm_bwd_reduce_kernel(
    const float* __restrict__ pdb, const float* __restrict__ pdc,
    const float* __restrict__ pddt, const float* __restrict__ pda,
    const float* __restrict__ pdd, T* __restrict__ db, T* __restrict__ dc,
    float* __restrict__ ddt, float* __restrict__ da, float* __restrict__ dd,
    int B, int L, int H, int N, int npts) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nbc = static_cast<long long>(B) * L * N;
  const long long nt = static_cast<long long>(B) * L * H;
  const int nhb = H * npts;
  if (i < nbc) {
    const long long bt = i / N;
    const int n = static_cast<int>(i - bt * N);
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < nhb; ++j) {
      sb += pdb[(bt * nhb + j) * N + n];
      sc += pdc[(bt * nhb + j) * N + n];
    }
    db[i] = from_f<T>(sb);
    dc[i] = from_f<T>(sc);
    return;
  }
  i -= nbc;
  if (i < nt) {
    float s = 0.f;
    for (int j = 0; j < npts; ++j) s += pddt[i * npts + j];
    ddt[i] = s;
    return;
  }
  i -= nt;
  if (i < H) {
    float sa = 0.f, sd = 0.f;
    for (int b = 0; b < B; ++b)
      for (int j = 0; j < npts; ++j) {
        sa += pda[(static_cast<long long>(b) * H + i) * npts + j];
        sd += pdd[(static_cast<long long>(b) * H + i) * npts + j];
      }
    da[i] = sa;
    dd[i] = sd;
  }
}

template <typename T, int NP>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* d, const void* dy, const void* dstate,
           void* dx, void* ddt, void* da, void* db, void* dc, void* dd,
           float* work, int B, int L, int H, int P, int N,
           cudaStream_t stream) {
  const Work w(B, L, H, P, N);
  const int npts = (P + RP - 1) / RP;
  const size_t smem = sizeof(float) * smem_floats(NP);
  const cudaError_t err = cudaFuncSetAttribute(
      ssm_bwd_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssm_bwd_kernel<T, NP><<<dim3(npts, H, B), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<const float*>(d),
      static_cast<const T*>(dy), static_cast<const float*>(dstate),
      static_cast<T*>(dx), work + w.ckpt, work + w.pdb, work + w.pdc,
      work + w.pddt, work + w.pda, work + w.pdd, L, H, P, N);
  const long long outs = static_cast<long long>(B) * L * N +
                         static_cast<long long>(B) * L * H + H;
  ssm_bwd_reduce_kernel<T><<<static_cast<unsigned>((outs + 255) / 256), 256,
                             0, stream>>>(
      work + w.pdb, work + w.pdc, work + w.pddt, work + w.pda, work + w.pdd,
      static_cast<T*>(db), static_cast<T*>(dc), static_cast<float*>(ddt),
      static_cast<float*>(da), static_cast<float*>(dd), B, L, H, N, npts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* a, const void* bm,
             const void* cm, const void* d, const void* dy,
             const void* dstate, void* dx, void* ddt, void* da, void* db,
             void* dc, void* dd, float* work, int B, int L, int H, int P,
             int N, cudaStream_t s) {
  switch (pad_n(N)) {
    case 16:
      return launch<T, 16>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db,
                           dc, dd, work, B, L, H, P, N, s);
    case 32:
      return launch<T, 32>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db,
                           dc, dd, work, B, L, H, P, N, s);
    case 64:
      return launch<T, 64>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db,
                           dc, dd, work, B, L, H, P, N, s);
    default:
      return launch<T, 128>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da,
                            db, dc, dd, work, B, L, H, P, N, s);
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores, chunked (SSD) form
// ---------------------------------------------------------------------------

constexpr int TC = 64;               // steps per chunk
constexpr int PS = 64;               // rows of P per slab
constexpr int HG = 4;                // heads per block (states, main)
constexpr int TCW = 4;               // warps per block
constexpr int TCT = 32 * TCW;
constexpr int PADB = 8;              // bf16 of padding per staged row
constexpr int LDP = PS + PADB;       // row stride of the [t][p] tiles
constexpr int LDT = TC + PADB;       // row stride of dG^T's [u][t] tile
constexpr int EPT = 16;              // state values per thread (pass)
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int ldn(int np) { return np + PADB; }

// workspace (floats): the chunk states (B, chunks, H, slabs of P, 64, NP)
// (the local W^T B and Z in float32, rewritten as h_in and dh_out, each
// slab's bf16 hi rows then its lo rows in the same bytes), exp(S) and the
// partials
struct TcWork {
  long long hst, zst, es, pda, pdd, pdb, pdc, total;
  TcWork(int B, int L, int H, int P, int N) {
    const int nc = (L + TC - 1) / TC, nslab = (P + PS - 1) / PS;
    const int ng = (H + HG - 1) / HG;
    const long long tiles = static_cast<long long>(B) * nc * H;
    const long long tile = static_cast<long long>(nslab) * PS * pad_n(N);
    hst = 0;
    zst = hst + tiles * tile;
    es = zst + tiles * tile;
    pda = es + tiles;
    pdd = pda + tiles;
    pdb = pdd + tiles;
    pdc = pdb + static_cast<long long>(B) * L * ng * N;
    total = pdc + static_cast<long long>(B) * L * ng * N;
  }
};

// Stage ROWS rows of WIDTH columns into `dst` (row stride `ld`): the
// first `valid` rows and `cols` columns from `src` (row stride `stride`
// elements), the rest zero. With `vec` by 16-byte cp.async copies, else by
// plain loads and stores.
template <int ROWS, int WIDTH>
__device__ __forceinline__ void tc_stage(bf16* dst, int ld, const bf16* src,
                                         long long stride, int valid,
                                         int cols, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CH = WIDTH / 8;
#pragma unroll
    for (int i = 0; i < (ROWS * CH + TCT - 1) / TCT; ++i) {
      const int slot = tid + i * TCT;
      const int r = slot / CH, c = (slot - r * CH) * 8;
      if (slot < ROWS * CH) {
        const bool in = r < valid && c < cols;
        cp_async16(dst + r * ld + c, in ? src + r * stride + c : src, in);
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < ROWS * WIDTH; e += TCT) {
      const int r = e / WIDTH, c = e - r * WIDTH;
      dst[r * ld + c] = r < valid && c < cols ? src[r * stride + c] : zero;
    }
  }
}

// warp 0: s = cumsum(dt a) in log2 units (s2) and dt of one head's chunk,
// steps 2 lane and 2 lane + 1; dt = 0 past the chunk's `tn` steps
__device__ __forceinline__ void tc_scan(const float* dtp, long long stride,
                                        int tn, float a2, float* s2s,
                                        float* dts) {
  const int lane = threadIdx.x & 31, ta = 2 * lane, tb = ta + 1;
  const float da = ta < tn ? dtp[ta * stride] : 0.f;
  const float dbv = tb < tn ? dtp[tb * stride] : 0.f;
  const float lb = dbv * a2;
  float sum = da * a2 + lb;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, sum, off);
    if (lane >= off) sum += o;
  }
  s2s[ta] = sum - lb;
  s2s[tb] = sum;
  dts[ta] = da;
  dts[tb] = dbv;
}

// A operands (rows m, k 16 wide) of a float32 16 x 16 block held as two
// 8-column accumulator tiles (rows g, g + 8), split into bf16 hi and lo
__device__ __forceinline__ void split_block(const float (&c0)[4],
                                            const float (&c1)[4],
                                            uint32_t (&hi)[4],
                                            uint32_t (&lo)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

// d[2 j], d[2 j + 1] += a . (hi + lo) over two n-tiles
__device__ __forceinline__ void mma_pair(float (&d0)[4], float (&d1)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&bh)[4],
                                         const uint32_t (&bl)[4]) {
  mma_bf16(d0, a, bh[0], bh[1]);
  mma_bf16(d1, a, bh[2], bh[3]);
  mma_bf16(d0, a, bl[0], bl[1]);
  mma_bf16(d1, a, bl[2], bl[3]);
}

// The lanes' ldmatrix row and column offsets (lane l gives row l & 7 of
// matrix l >> 3): A from a [m][k] tile; B from an [n][k] tile (two
// n-tiles); B from a [k][n] tile (.trans, two n-tiles); A from a [k][m]
// tile (.trans)
struct Lanes {
  int g, t4, a_row, a_col, k_row, k_col, v_row, v_col, at_row, at_col;
  __device__ Lanes() {
    const int lane = threadIdx.x & 31, lrow = lane & 7, lmat = lane >> 3;
    g = lane >> 2;
    t4 = lane & 3;
    a_row = ((lmat & 1) << 3) + lrow;
    a_col = (lmat >> 1) << 3;
    k_row = ((lmat >> 1) << 3) + lrow;
    k_col = (lmat & 1) << 3;
    v_row = a_row;
    v_col = a_col;
    at_row = k_row;
    at_col = k_col;
  }
};

// 1. Every chunk's local states. Block (chunk, group of HG heads, batch
// row); warp w owns rows p 16 w .. 16 w + 15 of a slab. Writes W^T B to
// hst and (exp(s) dy)^T C to zst (float32 [slab rows][NP]) and exp(S).
template <int NP>
__global__ void __launch_bounds__(TCT)
    ssd_bwd_states_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const bf16* __restrict__ bm,
                          const bf16* __restrict__ cm,
                          const bf16* __restrict__ dy,
                          float* __restrict__ hst, float* __restrict__ zst,
                          float* __restrict__ es, int L, int H, int P, int N,
                          int vec_x, int vec_bc) {
  constexpr int LDN = ldn(NP), NT = NP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);  // [u][n]
  bf16* cs = bs + TC * LDN;                       // [t][n]
  bf16* xs0 = cs + TC * LDN;                      // 2 x {x [u][p], dy [t][p]}
  float* s2s = reinterpret_cast<float*>(xs0 + 4 * TC * LDP);
  float* dts = s2s + TC;

  const Lanes ln;
  const int warp = threadIdx.x >> 5, wrow = warp * 16;
  const int c = blockIdx.x, nc = gridDim.x, b = blockIdx.z;
  const int c0 = c * TC, tn = min(TC, L - c0);
  const int h0 = blockIdx.y * HG, nh = min(HG, H - h0);
  const int nslab = (P + PS - 1) / PS, items = nh * nslab;
  const long long hp = static_cast<long long>(H) * P;
  // item i: head h0 + i / nslab, slab i % nslab, into buffer i & 1
  const auto stage_item = [&](int i) {
    const int hh = h0 + i / nslab, p0 = (i % nslab) * PS;
    bf16* xb = xs0 + (i & 1) * 2 * TC * LDP;
    const long long xoff = (static_cast<long long>(b) * L + c0) * hp +
                           static_cast<long long>(hh) * P + p0;
    tc_stage<TC, PS>(xb, LDP, x + xoff, hp, tn, min(PS, P - p0), vec_x);
    tc_stage<TC, PS>(xb + TC * LDP, LDP, dy + xoff, hp, tn, min(PS, P - p0),
                     vec_x);
  };
  tc_stage<TC, NP>(bs, LDN, bm + (static_cast<long long>(b) * L + c0) * N, N,
                   tn, N, vec_bc);
  tc_stage<TC, NP>(cs, LDN, cm + (static_cast<long long>(b) * L + c0) * N, N,
                   tn, N, vec_bc);
  stage_item(0);
  cp_async_commit();

  for (int i = 0; i < items; ++i) {
    const int j = i / nslab, ps = i - j * nslab, hh = h0 + j;
    const long long ti = (static_cast<long long>(b) * nc + c) * H + hh;
    __syncthreads();  // the last item's readers are done
    if (i + 1 < items) stage_item(i + 1);
    cp_async_commit();
    if (warp == 0 && ps == 0)
      tc_scan(dt + (static_cast<long long>(b) * L + c0) * H + hh, H, tn,
              a[hh] * LOG2E, s2s, dts);
    cp_async_wait<1>();
    __syncthreads();
    {
      const bf16* xs = xs0 + (i & 1) * 2 * TC * LDP;
      const bf16* dys = xs + TC * LDP;
      const float s2T = s2s[TC - 1];
      if (threadIdx.x == 0 && ps == 0) es[ti] = exp2_approx(s2T);
      // which 0: W^T B (A = x^T scaled by dt_u exp(S - s_u)); which 1:
      // (exp(s) dy)^T C
#pragma unroll 1
      for (int which = 0; which < 2; ++which) {
        const bf16* src = which ? dys : xs;
        const bf16* rhs = which ? cs : bs;
        float acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < TC / 16; ++kk) {
          if (kk * 16 >= tn) break;  // zero rows of a ragged chunk
          uint32_t xf[4], ah[4], al[4];
          ldmatrix_x4_trans(xf, smem_u32(src + (kk * 16 + ln.at_row) * LDP +
                                         wrow + ln.at_col));
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int u = kk * 16 + 2 * ln.t4 + (r >> 1) * 8;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&xf[r]));
            const float f0 = which ? exp2_approx(s2s[u])
                                   : dts[u] * exp2_approx(s2T - s2s[u]);
            const float f1 = which ? exp2_approx(s2s[u + 1])
                                   : dts[u + 1] *
                                         exp2_approx(s2T - s2s[u + 1]);
            split_pair(xv.x * f0, xv.y * f1, ah[r], al[r]);
          }
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, smem_u32(rhs + (kk * 16 + ln.v_row) * LDN +
                                           np * 16 + ln.v_col));
            mma_bf16(acc[2 * np], ah, bv[0], bv[1]);
            mma_bf16(acc[2 * np + 1], ah, bv[2], bv[3]);
            mma_bf16(acc[2 * np], al, bv[0], bv[1]);
            mma_bf16(acc[2 * np + 1], al, bv[2], bv[3]);
          }
        }
        float* out = (which ? zst : hst) +
                     (ti * nslab + ps) * static_cast<long long>(PS) * NP;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = n * 8 + 2 * ln.t4;
          *reinterpret_cast<float2*>(out + (wrow + ln.g) * NP + col) =
              make_float2(acc[n][0], acc[n][1]);
          *reinterpret_cast<float2*>(out + (wrow + ln.g + 8) * NP + col) =
              make_float2(acc[n][2], acc[n][3]);
        }
      }
    }
  }
}

// 2. The state passes. Block (batch row x head, slab of P), 4 NP threads,
// EPT state values each. Forward: h_in of chunk 0 is 0 and h_in of c + 1
// = exp(S_c) h_in + (W^T B)_c; reverse: dh_out of the last chunk is the
// final state's cotangent and dh_out of c - 1 = exp(S_c) dh_out + Z_c.
// Each chunk's float32 local state is read whole (a chunk ahead, so the
// loads of the next are in flight) before its slot is rewritten as bf16
// hi rows then lo rows (the same bytes).
__device__ __forceinline__ void pass_walk(float* __restrict__ st_base,
                                          const float* __restrict__ es,
                                          float (&st)[EPT], int nc, int H,
                                          int b, int h, int ps, int nslab,
                                          int tile, bool reverse) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const auto slot = [&](int c) {
    return st_base + ((((static_cast<long long>(b) * nc + c) * H + h) *
                       nslab + ps) * tile);
  };
  const auto esv = [&](int c) {
    return es[(static_cast<long long>(b) * nc + c) * H + h];
  };
  int c = reverse ? nc - 1 : 0;
  const int step = reverse ? -1 : 1;
  float nxt[EPT];
  float e_nxt = esv(c);
#pragma unroll
  for (int j = 0; j < EPT; ++j) nxt[j] = slot(c)[tid + j * nthr];
  for (int i = 0; i < nc; ++i, c += step) {
    float loc[EPT];
#pragma unroll
    for (int j = 0; j < EPT; ++j) loc[j] = nxt[j];
    const float e = e_nxt;
    if (i + 1 < nc) {
      e_nxt = esv(c + step);
#pragma unroll
      for (int j = 0; j < EPT; ++j) nxt[j] = slot(c + step)[tid + j * nthr];
    }
    __syncthreads();  // every thread has read slot c
    bf16* hb = reinterpret_cast<bf16*>(slot(c));
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int k = tid + j * nthr;
      const bf16 hi = __float2bfloat16(st[j]);
      hb[k] = hi;
      hb[tile + k] = __float2bfloat16(st[j] - __bfloat162float(hi));
      st[j] = fmaf(e, st[j], loc[j]);
    }
  }
}

__global__ void ssd_bwd_pass_kernel(float* __restrict__ hst,
                                    float* __restrict__ zst,
                                    const float* __restrict__ es,
                                    const float* __restrict__ dstate, int nc,
                                    int H, int P, int N, int np) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int bh = blockIdx.x, ps = blockIdx.y, nslab = gridDim.y;
  const int b = bh / H, h = bh - b * H;
  const int tile = PS * np;
  float st[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) st[j] = 0.f;
  pass_walk(hst, es, st, nc, H, b, h, ps, nslab, tile, false);
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int i = tid + j * nthr, p = ps * PS + i / np, n = i % np;
    st[j] = dstate != nullptr && p < P && n < N
                ? dstate[(static_cast<long long>(bh) * P + p) * N + n]
                : 0.f;
  }
  pass_walk(zst, es, st, nc, H, b, h, ps, nslab, tile, true);
}

// 3. The gradients of every chunk at once. Block (chunk, group of HG
// heads, batch row); warp w owns rows 16 w .. 16 w + 15 of each product
// (steps u of the [u][t] and [u][p] products, steps t of the others).
template <int NP>
__global__ void __launch_bounds__(TCT)
    ssd_bwd_main_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ a,
                        const bf16* __restrict__ bm,
                        const bf16* __restrict__ cm,
                        const float* __restrict__ dskip,
                        const bf16* __restrict__ dy,
                        const float* __restrict__ hst,
                        const float* __restrict__ zst,
                        bf16* __restrict__ dx,
                        float* __restrict__ ddt, float* __restrict__ pdb,
                        float* __restrict__ pdc, float* __restrict__ pda,
                        float* __restrict__ pdd, int L, int H, int P, int N,
                        int vec_x, int vec_bc) {
  constexpr int LDN = ldn(NP), NT = NP / 8, NK = NP / 16;
  constexpr int SLAB = TC * LDP, STT = PS * LDN;
  constexpr int BUF = 2 * SLAB + 4 * STT;  // x, dy, h_in hi/lo, dh_out hi/lo
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);  // [u][n]
  bf16* cs = bs + TC * LDN;                       // [t][n]
  bf16* buf0 = cs + TC * LDN;                     // BUF
  float* s2s = reinterpret_cast<float*>(buf0 + BUF);
  float* dts = s2s + TC;
  float* y0s = dts + TC;    // exp(s_t) dy_t . (C h_in^T)_t
  float* cks = y0s + TC;    // colK
  float* qs = cks + TC;     // q
  float* rowa = qs + TC;    // [TCW][TC] the warps' shares of rowA
  float* red = rowa + TCW * TC;  // [2][TCW]
  float* dgs = red + 2 * TCW;    // [u][LDT] dG^T, summed over the heads

  const Lanes ln;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wrow = warp * 16, ua = wrow + ln.g, ub = ua + 8;
  const int c = blockIdx.x, nc = gridDim.x, grp = blockIdx.y,
            ng = gridDim.y, b = blockIdx.z;
  const int c0 = c * TC, tn = min(TC, L - c0);
  const int h0 = grp * HG, nh = min(HG, H - h0);
  const int nslab = (P + PS - 1) / PS;
  const long long hp = static_cast<long long>(H) * P;

  const auto stage_slab = [&](int j, int ps) {
    const int hh = h0 + j, p0 = ps * PS, pn = min(PS, P - p0);
    bf16* bb = buf0;
    const long long xoff = (static_cast<long long>(b) * L + c0) * hp +
                           static_cast<long long>(hh) * P + p0;
    tc_stage<TC, PS>(bb, LDP, x + xoff, hp, tn, pn, vec_x);
    tc_stage<TC, PS>(bb + SLAB, LDP, dy + xoff, hp, tn, pn, vec_x);
    const long long so = (((static_cast<long long>(b) * nc + c) * H + hh) *
                              nslab + ps) * PS * NP;
    const bf16* hsl = reinterpret_cast<const bf16*>(hst + so);
    const bf16* zsl = reinterpret_cast<const bf16*>(zst + so);
    tc_stage<PS, NP>(bb + 2 * SLAB, LDN, hsl, NP, PS, NP, true);
    tc_stage<PS, NP>(bb + 2 * SLAB + STT, LDN, hsl + PS * NP, NP, PS, NP,
                     true);
    tc_stage<PS, NP>(bb + 2 * SLAB + 2 * STT, LDN, zsl, NP, PS, NP, true);
    tc_stage<PS, NP>(bb + 2 * SLAB + 3 * STT, LDN, zsl + PS * NP, NP, PS,
                     NP, true);
  };
  const auto zero = [](auto& acc) {
#pragma unroll
    for (int n = 0; n < static_cast<int>(sizeof(acc) / sizeof(acc[0])); ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  };

  tc_stage<TC, NP>(bs, LDN, bm + (static_cast<long long>(b) * L + c0) * N, N,
                   tn, N, vec_bc);
  tc_stage<TC, NP>(cs, LDN, cm + (static_cast<long long>(b) * L + c0) * N, N,
                   tn, N, vec_bc);

  float dbs[NT][4];       // sum_heads W dh_out, rows u
  float dcs[NT][4];       // sum_heads exp(s_t) dy_t h_in, rows t
  zero(dbs);
  zero(dcs);
  for (int i = tid; i < TC * LDT; i += TCT) dgs[i] = 0.f;  // each thread
  // updates only its own fragment's entries

  for (int j = 0; j < nh; ++j) {
    const int hh = h0 + j;
    const long long ti = (static_cast<long long>(b) * nc + c) * H + hh;
    stage_slab(j, 0);
    cp_async_commit();
    if (warp == 0)
      tc_scan(dt + (static_cast<long long>(b) * L + c0) * H + hh, H, tn,
              a[hh] * LOG2E, s2s, dts);
    cp_async_wait<0>();
    __syncthreads();
    const float s2T = s2s[TC - 1];
    const float s2a = s2s[ua], s2b = s2s[ub];
    const float dta = dts[ua], dtb = dts[ub];
    const float wa = exp2_approx(s2T - s2a), wb = exp2_approx(s2T - s2b);
    const float eta = exp2_approx(s2a), etb = exp2_approx(s2b);
    float ddp = 0.f;  // this thread's share of sum dy x
    float e0p = 0.f;  // and of sum dh_out h_in

    // phase 1, slab by slab: dM^T = x dy^T (rows u; pairs of t-tiles at
    // or right of the diagonal) and sum_heads W dh_out
    float dmt[TC / 8][4];
    zero(dmt);
    for (int ps = 0; ps < nslab; ++ps) {
      if (ps > 0) {
        __syncthreads();
        stage_slab(j, ps);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      const bf16* xs = buf0;
      const bf16* dys = xs + SLAB;
      const bf16* hih = xs + 2 * SLAB;
      const bf16* dhh = hih + 2 * STT;
      const bf16* dhl = dhh + STT;
      for (int e = tid; e < PS * NP / 2; e += TCT) {
        const int r = e / (NP / 2), col = 2 * (e - r * (NP / 2));
        const int o = r * LDN + col;
        const float2 hh2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(hih + o));
        const float2 hl2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(hih + STT + o));
        const float2 dh2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dhh + o));
        const float2 dl2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dhl + o));
        e0p = fmaf(dh2.x + dl2.x, hh2.x + hl2.x,
                   fmaf(dh2.y + dl2.y, hh2.y + hl2.y, e0p));
      }
      for (int e = tid; e < TC * PS / 2; e += TCT) {
        const int r = e / (PS / 2), col = 2 * (e - r * (PS / 2));
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + r * LDP + col));
        const float2 yv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dys + r * LDP + col));
        ddp = fmaf(xv.x, yv.x, fmaf(xv.y, yv.y, ddp));
      }
      uint32_t xa[PS / 16][4];
#pragma unroll
      for (int kk = 0; kk < PS / 16; ++kk)
        ldmatrix_x4(xa[kk], smem_u32(xs + (wrow + ln.a_row) * LDP + kk * 16 +
                                     ln.a_col));
#pragma unroll
      for (int np = 0; np < TC / 16; ++np) {
        if (np < warp) continue;
#pragma unroll
        for (int kk = 0; kk < PS / 16; ++kk) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_u32(dys + (np * 16 + ln.k_row) * LDP +
                                   kk * 16 + ln.k_col));
          mma_bf16(dmt[2 * np], xa[kk], bk[0], bk[1]);
          mma_bf16(dmt[2 * np + 1], xa[kk], bk[2], bk[3]);
        }
      }
      float tmp[NT][4];
      zero(tmp);
#pragma unroll
      for (int kk = 0; kk < PS / 16; ++kk)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bh[4], bl[4];
          const int off = (kk * 16 + ln.v_row) * LDN + np * 16 + ln.v_col;
          ldmatrix_x4_trans(bh, smem_u32(dhh + off));
          ldmatrix_x4_trans(bl, smem_u32(dhl + off));
          mma_pair(tmp[2 * np], tmp[2 * np + 1], xa[kk], bh, bl);
        }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        dbs[n][0] = fmaf(dta * wa, tmp[n][0], dbs[n][0]);
        dbs[n][1] = fmaf(dta * wa, tmp[n][1], dbs[n][1]);
        dbs[n][2] = fmaf(dtb * wb, tmp[n][2], dbs[n][2]);
        dbs[n][3] = fmaf(dtb * wb, tmp[n][3], dbs[n][3]);
      }
    }

    // phase 2: G^T (rows u) and, per element (u, t <= ...), K, dM K, the
    // sums colK (over t) and rowA (over u), dG^T, and M^T as the split A
    // operands of M^T dy (k-step kk covers t 16 kk .. 16 kk + 15)
    uint32_t ba[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      ldmatrix_x4(ba[kk], smem_u32(bs + (wrow + ln.a_row) * LDN + kk * 16 +
                                   ln.a_col));
    uint32_t mh[TC / 16][4], ml[TC / 16][4];
    float cka = 0.f, ckb = 0.f;
#pragma unroll
    for (int np = 0; np < TC / 16; ++np) {
      if (np < warp) {
        if (ln.g == 0)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t0 = np * 16 + half * 8 + 2 * ln.t4;
            rowa[warp * TC + t0] = 0.f;
            rowa[warp * TC + t0 + 1] = 0.f;
          }
        continue;
      }
      float gt[2][4];
      zero(gt);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_u32(cs + (np * 16 + ln.k_row) * LDN + kk * 16 +
                                 ln.k_col));
        mma_bf16(gt[0], ba[kk], bk[0], bk[1]);
        mma_bf16(gt[1], ba[kk], bk[2], bk[3]);
      }
      float mv[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t0 = np * 16 + half * 8 + 2 * ln.t4, t1 = t0 + 1;
        const float s0 = s2s[t0], s1 = s2s[t1];
        const float dec[4] = {t0 >= ua ? exp2_approx(s0 - s2a) : 0.f,
                              t1 >= ua ? exp2_approx(s1 - s2a) : 0.f,
                              t0 >= ub ? exp2_approx(s0 - s2b) : 0.f,
                              t1 >= ub ? exp2_approx(s1 - s2b) : 0.f};
        const float dtu[4] = {dta, dta, dtb, dtb};
        float* dm = dmt[2 * np + half];
        float col[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kv = gt[half][e] * dec[e];
          const float dk = dm[e] * kv;
          if (e < 2)
            cka += dk;
          else
            ckb += dk;
          col[e & 1] = fmaf(dk, dtu[e], col[e & 1]);
          float* gp = dgs + (e < 2 ? ua : ub) * LDT + (e & 1 ? t1 : t0);
          *gp = fmaf(dm[e] * dec[e], dtu[e], *gp);
          mv[half][e] = kv * dtu[e];
        }
        // rowA's share of the warp's 16 rows u, by columns t0, t1
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          col[0] += __shfl_xor_sync(FULL, col[0], off);
          col[1] += __shfl_xor_sync(FULL, col[1], off);
        }
        if (ln.g == 0) {
          rowa[warp * TC + t0] = col[0];
          rowa[warp * TC + t1] = col[1];
        }
      }
      split_block(mv[0], mv[1], mh[np], ml[np]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      cka += __shfl_xor_sync(FULL, cka, off);
      ckb += __shfl_xor_sync(FULL, ckb, off);
    }
    if (ln.t4 == 0) {
      cks[ua] = cka;
      cks[ub] = ckb;
    }

    // phase 3, slab by slab: dx = dt_u exp(S - s_u) B dh_out^T + M^T dy
    // + D dy (rows u) with q; exp(s_t) dy_t . (C h_in^T)_t and
    // sum_heads exp(s_t) dy_t h_in (rows t)
    const float dsk = dskip[hh];
    float qa = 0.f, qb = 0.f, ya = 0.f, yb = 0.f;
    for (int ps = 0; ps < nslab; ++ps) {
      if (nslab > 1) {
        __syncthreads();
        stage_slab(j, ps);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      const int p0 = ps * PS;
      const bf16* xs = buf0;
      const bf16* dys = xs + SLAB;
      const bf16* hih = xs + 2 * SLAB;
      const bf16* hil = hih + STT;
      const bf16* dhh = hih + 2 * STT;
      const bf16* dhl = hih + 3 * STT;
      float acc[PS / 8][4];
      zero(acc);
      // B dh_out^T (k over n)
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
#pragma unroll
        for (int np = 0; np < PS / 16; ++np) {
          uint32_t bh[4], bl[4];
          const int off = (np * 16 + ln.k_row) * LDN + kk * 16 + ln.k_col;
          ldmatrix_x4(bh, smem_u32(dhh + off));
          ldmatrix_x4(bl, smem_u32(dhl + off));
          mma_pair(acc[2 * np], acc[2 * np + 1], ba[kk], bh, bl);
        }
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int n = 0; n < PS / 8; ++n) {
        const int col = n * 8 + 2 * ln.t4;
        const float2 xa2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + ua * LDP + col));
        const float2 xb2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + ub * LDP + col));
        pa = fmaf(xa2.x, acc[n][0], fmaf(xa2.y, acc[n][1], pa));
        pb = fmaf(xb2.x, acc[n][2], fmaf(xb2.y, acc[n][3], pb));
        acc[n][0] *= dta * wa;
        acc[n][1] *= dta * wa;
        acc[n][2] *= dtb * wb;
        acc[n][3] *= dtb * wb;
      }
      qa = fmaf(wa, pa, qa);
      qb = fmaf(wb, pb, qb);
      // + M^T dy (k over t, tiles at or right of the diagonal)
#pragma unroll
      for (int kk = 0; kk < TC / 16; ++kk) {
        if (kk < warp) continue;
#pragma unroll
        for (int np = 0; np < PS / 16; ++np) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_u32(dys + (kk * 16 + ln.v_row) * LDP +
                                         np * 16 + ln.v_col));
          mma_bf16(acc[2 * np], mh[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * np + 1], mh[kk], bv[2], bv[3]);
          mma_bf16(acc[2 * np], ml[kk], bv[0], bv[1]);
          mma_bf16(acc[2 * np + 1], ml[kk], bv[2], bv[3]);
        }
      }
      // + D dy, rounded to bf16 and stored, rows u < tn, columns p < P
#pragma unroll
      for (int n = 0; n < PS / 8; ++n) {
        const int col = n * 8 + 2 * ln.t4;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int u = r ? ub : ua;
          const float2 yv = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dys + u * LDP + col));
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(fmaf(dsk, yv.x, acc[n][2 * r]),
                                    fmaf(dsk, yv.y, acc[n][2 * r + 1]));
          bf16* dr = dx + (static_cast<long long>(b) * L + c0 + u) * hp +
                     static_cast<long long>(hh) * P + p0 + col;
          if (u < tn && vec_x) {
            if (p0 + col < P) *reinterpret_cast<__nv_bfloat162*>(dr) = v;
          } else if (u < tn) {
            if (p0 + col < P) dr[0] = v.x;
            if (p0 + col + 1 < P) dr[1] = v.y;
          }
        }
      }
      // C h_in^T (rows t, k over n), dotted with dy's rows
      {
        uint32_t ca[NK][4];
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          ldmatrix_x4(ca[kk], smem_u32(cs + (wrow + ln.a_row) * LDN +
                                       kk * 16 + ln.a_col));
        zero(acc);
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
#pragma unroll
          for (int np = 0; np < PS / 16; ++np) {
            uint32_t bh[4], bl[4];
            const int off = (np * 16 + ln.k_row) * LDN + kk * 16 + ln.k_col;
            ldmatrix_x4(bh, smem_u32(hih + off));
            ldmatrix_x4(bl, smem_u32(hil + off));
            mma_pair(acc[2 * np], acc[2 * np + 1], ca[kk], bh, bl);
          }
#pragma unroll
        for (int n = 0; n < PS / 8; ++n) {
          const int col = n * 8 + 2 * ln.t4;
          const float2 va = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dys + ua * LDP + col));
          const float2 vb = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dys + ub * LDP + col));
          ya = fmaf(va.x, acc[n][0], fmaf(va.y, acc[n][1], ya));
          yb = fmaf(vb.x, acc[n][2], fmaf(vb.y, acc[n][3], yb));
        }
      }
      // dy h_in (rows t, k over p)
      {
        uint32_t ya4[PS / 16][4];
#pragma unroll
        for (int kk = 0; kk < PS / 16; ++kk)
          ldmatrix_x4(ya4[kk], smem_u32(dys + (wrow + ln.a_row) * LDP +
                                        kk * 16 + ln.a_col));
        float tmp[NT][4];
        zero(tmp);
#pragma unroll
        for (int kk = 0; kk < PS / 16; ++kk)
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bh[4], bl[4];
            const int off = (kk * 16 + ln.v_row) * LDN + np * 16 + ln.v_col;
            ldmatrix_x4_trans(bh, smem_u32(hih + off));
            ldmatrix_x4_trans(bl, smem_u32(hil + off));
            mma_pair(tmp[2 * np], tmp[2 * np + 1], ya4[kk], bh, bl);
          }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          dcs[n][0] = fmaf(eta, tmp[n][0], dcs[n][0]);
          dcs[n][1] = fmaf(eta, tmp[n][1], dcs[n][1]);
          dcs[n][2] = fmaf(etb, tmp[n][2], dcs[n][2]);
          dcs[n][3] = fmaf(etb, tmp[n][3], dcs[n][3]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      qa += __shfl_xor_sync(FULL, qa, off);
      qb += __shfl_xor_sync(FULL, qb, off);
      ya += __shfl_xor_sync(FULL, ya, off);
      yb += __shfl_xor_sync(FULL, yb, off);
    }
    if (ln.t4 == 0) {
      qs[ua] = qa;
      qs[ub] = qb;
      y0s[ua] = eta * ya;
      y0s[ub] = etb * yb;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      ddp += __shfl_xor_sync(FULL, ddp, off);
      e0p += __shfl_xor_sync(FULL, e0p, off);
    }
    if (lane == 0) {
      red[warp] = ddp;
      red[TCW + warp] = e0p;
    }
    __syncthreads();

    // phase 4 (warp 0): ds, its reverse cumsum dl, ddt, and the head's
    // shares of da and dD
    if (warp == 0) {
      const int ta = 2 * lane, tb = ta + 1;
      const float da_ = dts[ta], db_ = dts[tb];
      float rsa = 0.f, rsb = 0.f;
#pragma unroll
      for (int w = 0; w < TCW; ++w) {
        rsa += rowa[w * TC + ta];
        rsb += rowa[w * TC + tb];
      }
      float dsa = y0s[ta] + rsa - da_ * (cks[ta] + qs[ta]);
      float dsb = y0s[tb] + rsb - db_ * (cks[tb] + qs[tb]);
      float dq = fmaf(da_, qs[ta], db_ * qs[tb]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        dq += __shfl_xor_sync(FULL, dq, off);
      if (lane == 31) {
        float e0 = 0.f;  // exp(S) sum dh_out h_in
        for (int w = 0; w < TCW; ++w) e0 += red[TCW + w];
        dsb += exp2_approx(s2T) * e0 + dq;
      }
      float suf = dsa + dsb;  // sum of ds over steps >= ta
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(FULL, suf, off);
        if (lane + off < 32) suf += o;
      }
      const float dla = suf, dlb = suf - dsa;
      const float ah = a[hh];
      float* dtr = ddt + (static_cast<long long>(b) * L + c0) * H + hh;
      if (ta < tn)
        dtr[static_cast<long long>(ta) * H] =
            cks[ta] + qs[ta] + ah * dla;
      if (tb < tn)
        dtr[static_cast<long long>(tb) * H] =
            cks[tb] + qs[tb] + ah * dlb;
      float dap = fmaf(da_, dla, db_ * dlb);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        dap += __shfl_xor_sync(FULL, dap, off);
      if (lane == 0) {
        pda[ti] = dap;
        float sd = 0.f;
        for (int w = 0; w < TCW; ++w) sd += red[w];
        pdd[ti] = sd;
      }
    }
    __syncthreads();  // the head's buffers and records are free
  }

  // dB = dG^T C + sum_heads W dh_out (rows u, k over t at or right of the
  // diagonal), as per-block partials
  float dgt[TC / 8][4];  // dG^T's fragment of this thread (its own entries)
#pragma unroll
  for (int n = 0; n < TC / 8; ++n) {
    const int col = n * 8 + 2 * ln.t4;
    dgt[n][0] = dgs[ua * LDT + col];
    dgt[n][1] = dgs[ua * LDT + col + 1];
    dgt[n][2] = dgs[ub * LDT + col];
    dgt[n][3] = dgs[ub * LDT + col + 1];
  }
#pragma unroll
  for (int kk = 0; kk < TC / 16; ++kk) {
    if (kk < warp) continue;
    uint32_t gh[4], gl[4];
    split_block(dgt[2 * kk], dgt[2 * kk + 1], gh, gl);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, smem_u32(cs + (kk * 16 + ln.v_row) * LDN +
                                     np * 16 + ln.v_col));
      mma_bf16(dbs[2 * np], gh, bv[0], bv[1]);
      mma_bf16(dbs[2 * np + 1], gh, bv[2], bv[3]);
      mma_bf16(dbs[2 * np], gl, bv[0], bv[1]);
      mma_bf16(dbs[2 * np + 1], gl, bv[2], bv[3]);
    }
  }
  // dG^T's hi and lo parts to shared memory [u][t], for dC's A operand
  bf16* gsh = buf0;
  bf16* gsl = gsh + TC * LDT;
#pragma unroll
  for (int n = 0; n < TC / 8; ++n) {
    const int col = n * 8 + 2 * ln.t4;
    uint32_t hi, lo;
    split_pair(dgt[n][0], dgt[n][1], hi, lo);
    *reinterpret_cast<uint32_t*>(gsh + ua * LDT + col) = hi;
    *reinterpret_cast<uint32_t*>(gsl + ua * LDT + col) = lo;
    split_pair(dgt[n][2], dgt[n][3], hi, lo);
    *reinterpret_cast<uint32_t*>(gsh + ub * LDT + col) = hi;
    *reinterpret_cast<uint32_t*>(gsl + ub * LDT + col) = lo;
  }
  __syncthreads();
  // dC = dG B + sum_heads exp(s_t) dy_t h_in (rows t, k over u at or left
  // of the diagonal)
#pragma unroll
  for (int kk = 0; kk < TC / 16; ++kk) {
    if (kk > warp) continue;
    uint32_t gh[4], gl[4];
    const int off = (kk * 16 + ln.at_row) * LDT + wrow + ln.at_col;
    ldmatrix_x4_trans(gh, smem_u32(gsh + off));
    ldmatrix_x4_trans(gl, smem_u32(gsl + off));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, smem_u32(bs + (kk * 16 + ln.v_row) * LDN +
                                     np * 16 + ln.v_col));
      mma_bf16(dcs[2 * np], gh, bv[0], bv[1]);
      mma_bf16(dcs[2 * np + 1], gh, bv[2], bv[3]);
      mma_bf16(dcs[2 * np], gl, bv[0], bv[1]);
      mma_bf16(dcs[2 * np + 1], gl, bv[2], bv[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? ua : ub, col = n * 8 + 2 * ln.t4 + (e & 1);
      if (r < tn && col < N) {
        const long long o =
            ((static_cast<long long>(b) * L + c0 + r) * ng + grp) * N + col;
        pdb[o] = dbs[n][e];
        pdc[o] = dcs[n][e];
      }
    }
  }
}

// 4. The partials in a fixed order: dB and dC over the head groups, da
// and dD over (batch row, chunk).
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ pdb,
                                      const float* __restrict__ pdc,
                                      const float* __restrict__ pda,
                                      const float* __restrict__ pdd,
                                      bf16* __restrict__ db,
                                      bf16* __restrict__ dc,
                                      float* __restrict__ da,
                                      float* __restrict__ dd, int B, int L,
                                      int H, int N, int nc, int ng) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nbc = static_cast<long long>(B) * L * N;
  if (i < nbc) {
    const long long bt = i / N;
    const int n = static_cast<int>(i - bt * N);
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < ng; ++g) {
      sb += pdb[(bt * ng + g) * N + n];
      sc += pdc[(bt * ng + g) * N + n];
    }
    db[i] = __float2bfloat16(sb);
    dc[i] = __float2bfloat16(sc);
    return;
  }
  i -= nbc;
  if (i < H) {
    float sa = 0.f, sd = 0.f;
    for (int bc = 0; bc < B * nc; ++bc) {
      sa += pda[static_cast<long long>(bc) * H + i];
      sd += pdd[static_cast<long long>(bc) * H + i];
    }
    da[i] = sa;
    dd[i] = sd;
  }
}

template <int NP>
size_t tc_states_smem() {
  return sizeof(bf16) * (2 * TC * ldn(NP) + 4 * TC * LDP) +
         sizeof(float) * 2 * TC;
}

template <int NP>
size_t tc_main_smem() {
  return sizeof(bf16) * (2 * TC * ldn(NP) + 2 * TC * LDP +
                         4 * PS * ldn(NP)) +
         sizeof(float) * (5 * TC + TCW * TC + 2 * TCW + TC * LDT);
}

template <int NP>
int launch_tc(const void* x, const void* dt, const void* a, const void* bm,
              const void* cm, const void* d, const void* dy,
              const void* dstate, void* dx, void* ddt, void* da, void* db,
              void* dc, void* dd, float* work, int B, int L, int H, int P,
              int N, cudaStream_t stream) {
  const TcWork w(B, L, H, P, N);
  const int nc = (L + TC - 1) / TC, nslab = (P + PS - 1) / PS;
  const int ng = (H + HG - 1) / HG;
  const size_t s1 = tc_states_smem<NP>(), s3 = tc_main_smem<NP>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_main_kernel<NP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s3));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec_x = P % 8 == 0 && aligned(x) && aligned(dy) && aligned(dx);
  const int vec_bc = N % 8 == 0 && aligned(bm) && aligned(cm);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(bm);
  const bf16* cb = static_cast<const bf16*>(cm);
  const bf16* yb = static_cast<const bf16*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const dim3 grid(nc, ng, B);
  ssd_bwd_states_kernel<NP><<<grid, TCT, s1, stream>>>(
      xb, dtf, af, bb, cb, yb, work + w.hst, work + w.zst, work + w.es, L, H,
      P, N, vec_x, vec_bc);
  ssd_bwd_pass_kernel<<<dim3(B * H, nslab), PS * NP / EPT, 0, stream>>>(
      work + w.hst, work + w.zst, work + w.es,
      static_cast<const float*>(dstate), nc, H, P, N, NP);
  ssd_bwd_main_kernel<NP><<<grid, TCT, s3, stream>>>(
      xb, dtf, af, bb, cb, static_cast<const float*>(d), yb, work + w.hst,
      work + w.zst, static_cast<bf16*>(dx),
      static_cast<float*>(ddt), work + w.pdb, work + w.pdc, work + w.pda,
      work + w.pdd, L, H, P, N, vec_x, vec_bc);
  const long long outs = static_cast<long long>(B) * L * N + H;
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>((outs + 255) / 256), 256, 0,
                          stream>>>(
      work + w.pdb, work + w.pdc, work + w.pda, work + w.pdd,
      static_cast<bf16*>(db), static_cast<bf16*>(dc), static_cast<float*>(da),
      static_cast<float*>(dd), B, L, H, N, nc, ng);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(const void* x, const void* dt, const void* a, const void* bm,
                const void* cm, const void* d, const void* dy,
                const void* dstate, void* dx, void* ddt, void* da, void* db,
                void* dc, void* dd, float* work, int B, int L, int H, int P,
                int N, cudaStream_t s) {
  switch (pad_n(N)) {
    case 16:
      return launch_tc<16>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db,
                           dc, dd, work, B, L, H, P, N, s);
    case 32:
      return launch_tc<32>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db,
                           dc, dd, work, B, L, H, P, N, s);
    case 64:
      return launch_tc<64>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db,
                           dc, dd, work, B, L, H, P, N, s);
    default:
      return launch_tc<128>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db,
                            dc, dd, work, B, L, H, P, N, s);
  }
}

}  // namespace

// The float32 workspace `repro_ssm_scan_bwd` needs for `dtype` (0 float32,
// 1 bfloat16), in elements.
extern "C" long long repro_ssm_scan_bwd_workspace(int dtype, int B, int L,
                                                  int H, int P, int N) {
  return dtype == 1 ? TcWork(B, L, H, P, N).total
                    : Work(B, L, H, P, N).total;
}

// x, dy, dx (B, L, H, P) and bm, cm, db, dc (B, L, N) of one dtype
// (0 float32, 1 bfloat16); dt, ddt (B, L, H), a, d, da, dd (H,) and
// dstate (B, H, P, N; may be null) float32; `work` float32 of
// repro_ssm_scan_bwd_workspace(dtype, ...) elements; all contiguous, on
// one device; L >= 1, 1 <= N <= 128. `stream` is a cudaStream_t. Returns
// a cudaError_t (0 on success).
extern "C" int repro_ssm_scan_bwd(const void* x, const void* dt,
                                  const void* a, const void* bm,
                                  const void* cm, const void* d,
                                  const void* dy, const void* dstate,
                                  void* dx, void* ddt, void* da, void* db,
                                  void* dc, void* dd, void* work, int dtype,
                                  int B, int L, int H, int P, int N,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  if (dtype == 1)
    return dispatch_tc(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db, dc,
                       dd, wk, B, L, H, P, N, s);
  return dispatch<float>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db,
                         dc, dd, wk, B, L, H, P, N, s);
}
