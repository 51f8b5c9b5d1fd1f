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
// byte bound), and the reverse scan is ~12 FLOPs per state element and
// step, ~16 GFLOP. This first kernel is the simple sequential form on the
// CUDA cores, float32 throughout (the SSD tensor-core form is later work):
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
// bf16 x, B, C, dy are read as bf16 and dx, dB, dC written in bf16; every
// sum is float32.
//
// Plain C entry points, loaded with ctypes. The launcher returns
// cudaGetLastError() after the launches, so a refused launch is reported
// to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// The float32 workspace `repro_ssm_scan_bwd` needs, in elements.
extern "C" long long repro_ssm_scan_bwd_workspace(int B, int L, int H, int P,
                                                  int N) {
  return Work(B, L, H, P, N).total;
}

// x, dy, dx (B, L, H, P) and bm, cm, db, dc (B, L, N) of one dtype
// (0 float32, 1 bfloat16); dt, ddt (B, L, H), a, d, da, dd (H,) and
// dstate (B, H, P, N; may be null) float32; `work` float32 of
// repro_ssm_scan_bwd_workspace elements; all contiguous, on one device;
// L >= 1, 1 <= N <= 128. `stream` is a cudaStream_t. Returns a
// cudaError_t (0 on success).
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
    return dispatch<bf16>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db,
                          dc, dd, wk, B, L, H, P, N, s);
  return dispatch<float>(x, dt, a, bm, cm, d, dy, dstate, dx, ddt, da, db,
                         dc, dd, wk, B, L, H, P, N, s);
}
