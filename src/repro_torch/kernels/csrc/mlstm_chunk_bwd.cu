// The gradient of the chunkwise mLSTM (xLSTM matrix memory), for Hopper
// (sm_90a).
//
// Replaces the gradient of the Pallas TPU kernel `_mlstm_kernel`, launched
// by `mlstm_chunk` in src/repro/kernels/mlstm_chunk.py (the reference has no
// Pallas backward: JAX differentiates `mlstm_chunk_jnp`). It is the exact
// gradient of the chunkwise function of csrc/mlstm_chunk.cu's header, the
// stabiliser included. Per chunk of T = 64 steps, with k~ = k / sqrt(D),
// the weights w_tu = exp(g_u - cm_t) [u <= t], inter_t = exp(m_in - cm_t),
// wout_u = exp(g_u - cm_T), carry = exp(m_in - cm_T), S = (q k~^T) w,
// num = S v + inter q C_in, qn = rowsum S + inter q.n_in and
// den = max(|qn|, exp(-m)):
//   dnum = dy / den; dden = -(dy . num) / den^2, to qn (times sign qn)
//     where |qn| wins, to m (times -exp(-m)) where exp(-m) wins, half
//     each on a tie;
//   dS = dnum v^T + dqn;  dq = (dS w) k~ + inter (C_in dnum + dqn n_in);
//   dk~ = (dS w)^T q + wout (dC v + dn);  dv = S^T dnum + wout dC^T k~;
//   dC_in = carry dC + (inter q)^T dnum;  dn_in = carry dn + (inter dqn)^T q;
// and the gates: each weight exp(z - cm) sends d(weight) weight to z and,
// negated, to cm; m_t = b_t + cm_t; cm = max(m_in, cummax g) routes to
// m_in or to the cummax's argmax (its last index on a tie); g = i - b;
// b = cumsum logsigmoid f; m_in is the last chunk's last m.
//
// What bounds it on an H100: at xlstm-350m's training shape (B 8, L 1024,
// H 4, D 512, bf16) the inputs and gradients are ~0.3 GB, and the
// products are ~2.5x the forward's ~40 GFLOP: 0.09 ms on the bf16 tensor
// cores, ~1.5 ms on the float32 CUDA cores. The forward keeps one head's
// D x D memory in shared memory only as 64-column slices, one per block;
// so does the backward for the memory and its cotangent dC, and every
// product that sums over value columns (dnum v^T, C_in dnum, dC v) is
// split into per-block partials that a later kernel sums in a fixed
// order, never with atomics (two runs give the same bits). The states are
// recomputed, not stored by the forward. Six launches:
//   1. gates: one warp per (batch row, head) walks the chunks, the cumsum
//      of log-sigmoid and the running max as warp scans: g, cm and m per
//      step, m_in per chunk;
//   2. forward: grid (D/64, H, B), the forward's walk over the chunks with
//      a 512 x 64 slice of C in shared memory; it writes C_in and n_in of
//      every chunk, q k~^T and qn (first block), and its columns' share
//      of dy . num;
//   3. steps: one thread per step: 1/den, dqn and the gradient of m
//      through den, from the summed shares;
//   4. reverse: grid (D/64, H, B), the chunks in reverse with a 512 x 64
//      slice of dC (and dn, first block) in shared memory: writes dv, the
//      dC and dn each chunk receives, and its columns' share of dnum v^T;
//   5. chunks: grid (D/64 rows, chunks, B x H), every chunk at once: dS,
//      then C_in dnum and dC v for 64 rows of D, dq and dk, and the
//      shares of the gates' sums (d inter, d wout, d carry, dS S);
//   6. gate chain: one warp per (batch row, head) walks the chunks in
//      reverse with the stabiliser's gradient (the one value carried
//      between chunks); within a chunk every sum over steps, and the
//      routing of cm's gradient to the running max's argmax, is a warp
//      scan: writes di and df.
// Every product is a 64 x 64 x 64 tile product. bf16: on the tensor
// cores, `mma.sync.m16n8k16` from bf16 tiles in shared memory (ldmatrix;
// rows padded by 16 bytes), 8 warps of 16 x 32 outputs each. q, k, v and
// dy are exact bf16 operands (1/sqrt(D) and 1/den are applied to the
// float32 results where they scale an output row); every float32 operand
// (C_in, dC, S, dS w, dnum, inter q, k w_out) goes in as bf16 hi and lo
// tiles in two products (hi.hi + hi.lo + lo.hi), ~16 bits, and C and dC
// are carried in shared memory as such pairs (re-split after each
// update, as csrc/mlstm_chunk.cu carries C): rounded once, each misses a
// bar of the card's check (the float32 di and df at 1e-4 of their
// largest entry, or the bf16 dq, dk, dv rows at 1e-2), as the CPU model
// in tests/test_torch_scan_backward.py shows. The workspace holds C_in
// and dC of every chunk as those hi and lo matrices, in the bytes of the
// float32 ones (2 x 537 MB at xlstm's shape, as before: the pairs need
// them). float32: the CUDA cores, each thread a 4 x 4 output tile fed by
// two float4 reads (every tile stored with its contracted index as the
// row). Every sum is float32. A ragged last chunk stages zeros past L.
//
// Plain C entry points, loaded with ctypes. The launcher returns
// cudaGetLastError() after the launches, so a refused launch is reported
// to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int T = 64;           // chunk length, and every tile's side
constexpr int LD = T + 4;       // padded row of a tile (float4-aligned)
constexpr int TILE = T * LD;
constexpr int THREADS = 256;    // 16 x 16 threads, each a 4 x 4 tile
constexpr float NEG_INF_M = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename X>
__device__ __forceinline__ X from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// acc[i][j] += sum_k at[k][4 ty + i] * bt[k][4 tx + j] over a tile's 64 k
__device__ __forceinline__ void mm(float (&acc)[4][4],
                                   const float* __restrict__ at,
                                   const float* __restrict__ bt) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
  for (int k = 0; k < T; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(at + k * LD + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(bt + k * LD + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// the sum of v over the 16 threads of a row of the thread grid (a warp
// holds two such rows)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// Stage a 64 x 64 tile from a (rows, D)-major tensor x (row r at
// base + r * rstride, column c at + c): rows r0 .. r0 + 63 (live below
// rlim), columns c0 .. c0 + 63 (live below clim), each times scale[r] (or
// 1); into dst[r][c], or dst[c][r] if `trans`. Zeros elsewhere.
template <typename X>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const X* __restrict__ base,
                                      long long rstride, int rlim, int c0,
                                      int clim, bool trans,
                                      const float* __restrict__ scale,
                                      float mul) {
  for (int e = threadIdx.x; e < T * T; e += THREADS) {
    const int r = e >> 6, c = e & 63;
    float v = 0.f;
    if (r < rlim && c0 + c < clim) {
      v = to_f(base[r * rstride + c0 + c]) * mul;
      if (scale != nullptr) v *= scale[r];
    }
    dst[trans ? c * LD + r : r * LD + c] = v;
  }
}

struct Dims {
  int B, L, H, D, NC, NE, DP;
  __host__ __device__ Dims(int b, int l, int h, int d)
      : B(b), L(l), H(h), D(d), NC((l + T - 1) / T), NE((d + T - 1) / T),
        DP(((d + T - 1) / T) * T) {}
};

// workspace (floats), each array [b][h][...], each starting on 16 bytes
struct Work {
  long long gw, cmw, mw, minw, qnw, rden, dqn, dmden, roww, colw;  // per step
  long long ynp, pdi, pdw;                 // per step and column block
  long long pdc;                           // per chunk and row block
  long long qkw, pdnv;                     // T x T per chunk (and block)
  long long nst, dno;                      // D per chunk
  long long cst, dco;                      // D x D per chunk
  long long total;
  __host__ __device__ Work(const Dims& m) {
    const long long bh = static_cast<long long>(m.B) * m.H;
    const long long steps = (bh * m.L + 3) / 4 * 4;
    const long long chunks = (bh * m.NC + 3) / 4 * 4;
    long long o = 0;
    gw = o; o += steps; cmw = o; o += steps; mw = o; o += steps;
    minw = o; o += chunks;
    qnw = o; o += steps; rden = o; o += steps; dqn = o; o += steps;
    dmden = o; o += steps; roww = o; o += steps; colw = o; o += steps;
    ynp = o; o += steps * m.NE; pdi = o; o += steps * m.NE;
    pdw = o; o += steps * m.NE; pdc = o; o += chunks * m.NE;
    qkw = o; o += chunks * T * T; pdnv = o; o += chunks * m.NE * T * T;
    nst = o; o += chunks * m.D; dno = o; o += chunks * m.D;
    cst = o; o += chunks * m.D * m.D; dco = o; o += chunks * m.D * m.D;
    total = o;
  }
};

// 1. the gates' scans: one warp per (b, h) walks the chunks in order, lane
// l taking steps 2l and 2l + 1 of each (the cumsum of log-sigmoid and the
// running max by warp scans): g, cm and m per step, m_in per chunk
__global__ void mlstm_bwd_gates_kernel(const float* __restrict__ ig,
                                       const float* __restrict__ fg,
                                       float* __restrict__ work, Dims m) {
  const Work w(m);
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (bh >= m.B * m.H) return;  // whole warps
  const int b = bh / m.H, h = bh % m.H;
  const int ta = 2 * lane, tb = ta + 1;
  float m_in = NEG_INF_M;
  for (int c = 0; c < m.NC; ++c) {
    const int c0 = c * T, tn = min(T, m.L - c0);
    if (lane == 0) work[w.minw + static_cast<long long>(bh) * m.NC + c] = m_in;
    const long long gi = (static_cast<long long>(b) * m.L + c0 + ta) * m.H + h;
    const bool ina = ta < tn, inb = tb < tn;
    const float la = ina ? log_sigmoid(fg[gi]) : 0.f;
    const float lb = inb ? log_sigmoid(fg[gi + m.H]) : 0.f;
    float s = la + lb;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += o;
    }
    const float ba = s - lb, bb = s;
    const float ga = ina ? ig[gi] - ba : -INFINITY;
    const float gb = inb ? ig[gi + m.H] - bb : -INFINITY;
    float mx = fmaxf(ga, gb);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, mx, off);
      if (lane >= off) mx = fmaxf(mx, o);
    }
    float prev = __shfl_up_sync(FULL, mx, 1);
    if (lane == 0) prev = -INFINITY;
    const float cma = fmaxf(fmaxf(prev, ga), m_in);
    const float cmb = fmaxf(mx, m_in);
    const long long si = static_cast<long long>(bh) * m.L + c0 + ta;
    if (ina) {
      work[w.gw + si] = ga;
      work[w.cmw + si] = cma;
      work[w.mw + si] = ba + cma;
    }
    if (inb) {
      work[w.gw + si + 1] = gb;
      work[w.cmw + si + 1] = cmb;
      work[w.mw + si + 1] = bb + cmb;
    }
    // the last live step's m (steps past the end keep b and cm as they
    // were)
    m_in = __shfl_sync(FULL, bb + cmb, 31);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// the inclusive sum of v over lanes >= this lane
__device__ __forceinline__ float suffix_sum(float v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_down_sync(FULL, v, off);
    if (lane + off < 32) v += o;
  }
  return v;
}

// and writes m_in.
__device__ __forceinline__ float load_chunk(const float* __restrict__ work,
                                            const Work& w, const Dims& m,
                                            int bh, int c, int tn, float* gs,
                                            float* cms, float* ints,
                                            float* wos) {
  const long long s0 = static_cast<long long>(bh) * m.L + c * T;
  const float m_in = work[w.minw + static_cast<long long>(bh) * m.NC + c];
  const float cm_last = work[w.cmw + s0 + tn - 1];
  for (int t = threadIdx.x; t < T; t += THREADS) {
    const bool live = t < tn;
    const float g = live ? work[w.gw + s0 + t] : -INFINITY;
    const float cm = live ? work[w.cmw + s0 + t] : 0.f;
    gs[t] = g;
    cms[t] = cm;
    ints[t] = live ? expf(m_in - cm) : 0.f;
    wos[t] = live ? expf(g - cm_last) : 0.f;
  }
  return expf(m_in - cm_last);
}

__device__ __forceinline__ float weight(const float* gs, const float* cms,
                                        int t, int u, int tn) {
  return u <= t && t < tn ? expf(gs[u] - cms[t]) : 0.f;
}

// 2. the forward's walk, recording the chunk states. Block (64 value
// columns e0 .., head, batch row). Shared memory: C's slice [D][64]
// (rows padded to DP), n (first block), tiles A, Bt, V, ST, the record.
template <typename X>
__global__ void __launch_bounds__(THREADS)
    mlstm_bwd_forward_kernel(const X* __restrict__ q, const X* __restrict__ k,
                             const X* __restrict__ v,
                             const X* __restrict__ dy,
                             float* __restrict__ work, Dims m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cs = reinterpret_cast<float*>(smem_raw);  // [DP][LD]
  float* ns = cs + m.DP * LD;                       // [DP]
  float* ta = ns + m.DP;                            // tiles
  float* tb = ta + TILE;
  float* tv = tb + TILE;
  float* ts = tv + TILE;
  float* gs = ts + TILE;                            // the record, [T] each
  float* cms = gs + T;
  float* ints = cms + T;
  float* wos = ints + T;
  float* qnin = wos + T;

  const Work w(m);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int eb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int e0 = eb * T, bh = b * m.H + h;
  const float scale = rsqrtf(static_cast<float>(m.D));
  const long long rs = static_cast<long long>(m.H) * m.D;  // step stride
  for (int e = tid; e < m.DP * LD; e += THREADS) cs[e] = 0.f;
  for (int e = tid; e < m.DP; e += THREADS) ns[e] = 0.f;

  for (int c = 0; c < m.NC; ++c) {
    const int c0 = c * T, tn = min(T, m.L - c0);
    const long long base = (static_cast<long long>(b) * m.L + c0) * rs +
                           static_cast<long long>(h) * m.D;
    __syncthreads();  // the last chunk's update is done
    const float carry = load_chunk(work, w, m, bh, c, tn, gs, cms, ints, wos);
    // C_in and n_in of this chunk
    float* cst = work + w.cst +
                 (static_cast<long long>(bh) * m.NC + c) * m.D * m.D;
    for (int e = tid; e < m.D * T; e += THREADS) {
      const int d = e >> 6, col = e & 63;
      if (e0 + col < m.D) cst[static_cast<long long>(d) * m.D + e0 + col] =
          cs[d * LD + col];
    }
    if (eb == 0)
      for (int d = tid; d < m.D; d += THREADS)
        work[w.nst + (static_cast<long long>(bh) * m.NC + c) * m.D + d] =
            ns[d];
    if (tid < T) qnin[tid] = 0.f;
    // q k~^T and q C_in, slab by slab of D
    float qk[4][4], qc[4][4];
    zero(qk);
    zero(qc);
    for (int d0 = 0; d0 < m.DP; d0 += T) {
      __syncthreads();
      stage(ta, q + base, rs, tn, d0, m.D, true, nullptr, 1.f);
      stage(tb, k + base, rs, tn, d0, m.D, true, nullptr, scale);
      __syncthreads();
      mm(qk, ta, tb);
      mm(qc, ta, cs + d0 * LD);
      if (eb == 0 && tid < T) {
        float acc = qnin[tid];
        for (int dd = 0; dd < T; ++dd)
          acc = fmaf(ta[dd * LD + tid], ns[d0 + dd], acc);
        qnin[tid] = acc;
      }
    }
    // S = q k~^T w, stored as S^T; qk and qn recorded by the first block
    float* qkw = work + w.qkw + (static_cast<long long>(bh) * m.NC + c) * T * T;
    float srow[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = 4 * ty + i, u = 4 * tx + j;
        const float sv = qk[i][j] * weight(gs, cms, t, u, tn);
        ts[u * LD + t] = sv;
        srow[i] += sv;
        if (eb == 0) qkw[t * T + u] = qk[i][j];
      }
    __syncthreads();  // qnin complete
    if (eb == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qn = row_sum(srow[i]);
        const int t = 4 * ty + i;
        if (tx == 0 && t < tn)
          work[w.qnw + static_cast<long long>(bh) * m.L + c0 + t] =
              fmaf(ints[t], qnin[t], qn);
      }
    }
    stage(tv, v + base, rs, tn, e0, m.D, false, nullptr, 1.f);
    __syncthreads();
    // num = S v + inter q C_in; this block's share of dy . num
    float num[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) num[i][j] = qc[i][j] * ints[4 * ty + i];
    mm(num, ts, tv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = e0 + 4 * tx + j;
        if (t < tn && col < m.D)
          part = fmaf(to_f(dy[base + t * rs + col]), num[i][j], part);
      }
      part = row_sum(part);
      if (tx == 0 && t < tn)
        work[w.ynp + (static_cast<long long>(bh) * m.NE + eb) * m.L + c0 + t] =
            part;
    }
    // C <- carry C + (k~ wout)^T v, slab by slab; n likewise
    for (int d0 = 0; d0 < m.DP; d0 += T) {
      __syncthreads();
      stage(tb, k + base, rs, tn, d0, m.D, false, wos, scale);
      __syncthreads();
      float up[4][4];
      zero(up);
      mm(up, tb, tv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* cp = cs + (d0 + 4 * ty + i) * LD + 4 * tx + j;
          *cp = fmaf(carry, *cp, up[i][j]);
        }
      if (eb == 0 && tid < T) {
        float acc = 0.f;
        for (int u = 0; u < T; ++u) acc += tb[u * LD + tid];
        ns[d0 + tid] = fmaf(carry, ns[d0 + tid], acc);
      }
    }
  }
}

// 3. per step: 1/den, dqn, and the gradient of m through den
__global__ void mlstm_bwd_steps_kernel(float* __restrict__ work, Dims m) {
  const Work w(m);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long steps = static_cast<long long>(m.B) * m.H * m.L;
  if (i >= steps) return;
  const long long bh = i / m.L, t = i - bh * m.L;
  float ynum = 0.f;
  for (int eb = 0; eb < m.NE; ++eb)
    ynum += work[w.ynp + (bh * m.NE + eb) * m.L + t];
  const float qn = work[w.qnw + i];
  const float em = expf(-work[w.mw + i]);
  const float den = fmaxf(fabsf(qn), em);
  const float rden = 1.f / den;
  const float dden = -ynum * rden * rden;
  const float aq = fabsf(qn);
  const float to_qn = aq > em ? 1.f : aq < em ? 0.f : 0.5f;
  const float sgn = qn > 0.f ? 1.f : qn < 0.f ? -1.f : 0.f;
  work[w.rden + i] = rden;
  work[w.dqn + i] = dden * sgn * to_qn;
  work[w.dmden + i] = -dden * em * (1.f - to_qn);
}

// 4. the chunks in reverse with dC's slice. Block (64 value columns,
// head, batch row). Shared memory: dC [DP][LD], dn (first block), tiles S
// [t][u], dN [t][e], X1, X2, the record.
template <typename X>
__global__ void __launch_bounds__(THREADS)
    mlstm_bwd_reverse_kernel(const X* __restrict__ q, const X* __restrict__ k,
                             const X* __restrict__ v,
                             const X* __restrict__ dy,
                             const float* __restrict__ dcf,
                             const float* __restrict__ dnf,
                             X* __restrict__ dv, float* __restrict__ work,
                             Dims m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dcs = reinterpret_cast<float*>(smem_raw);  // [DP][LD]
  float* dns = dcs + m.DP * LD;                      // [DP]
  float* tsm = dns + m.DP;                           // S [t][u]
  float* tdn = tsm + TILE;                           // dN [t][e]
  float* x1 = tdn + TILE;
  float* x2 = x1 + TILE;
  float* gs = x2 + TILE;
  float* cms = gs + T;
  float* ints = cms + T;
  float* wos = ints + T;
  float* rdn = wos + T;
  float* dqs = rdn + T;

  const Work w(m);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int eb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int e0 = eb * T, bh = b * m.H + h;
  const float scale = rsqrtf(static_cast<float>(m.D));
  const long long rs = static_cast<long long>(m.H) * m.D;
  for (int e = tid; e < m.DP * LD; e += THREADS) {
    const int d = e / LD, col = e - d * LD;
    dcs[e] = dcf != nullptr && d < m.D && col < T && e0 + col < m.D
                 ? dcf[(static_cast<long long>(bh) * m.D + d) * m.D + e0 +
                       col]
                 : 0.f;
  }
  for (int d = tid; d < m.DP; d += THREADS)
    dns[d] = dnf != nullptr && d < m.D
                 ? dnf[static_cast<long long>(bh) * m.D + d]
                 : 0.f;

  for (int c = m.NC - 1; c >= 0; --c) {
    const int c0 = c * T, tn = min(T, m.L - c0);
    const long long base = (static_cast<long long>(b) * m.L + c0) * rs +
                           static_cast<long long>(h) * m.D;
    const long long s0 = static_cast<long long>(bh) * m.L + c0;
    __syncthreads();  // the last chunk's update is done
    const float carry = load_chunk(work, w, m, bh, c, tn, gs, cms, ints, wos);
    for (int t = tid; t < T; t += THREADS) {
      rdn[t] = t < tn ? work[w.rden + s0 + t] : 0.f;
      dqs[t] = t < tn ? work[w.dqn + s0 + t] : 0.f;
    }
    // the cotangent this chunk's output state receives
    float* dco = work + w.dco +
                 (static_cast<long long>(bh) * m.NC + c) * m.D * m.D;
    for (int e = tid; e < m.D * T; e += THREADS) {
      const int d = e >> 6, col = e & 63;
      if (e0 + col < m.D) dco[static_cast<long long>(d) * m.D + e0 + col] =
          dcs[d * LD + col];
    }
    if (eb == 0)
      for (int d = tid; d < m.D; d += THREADS)
        work[w.dno + (static_cast<long long>(bh) * m.NC + c) * m.D + d] =
            dns[d];
    __syncthreads();  // the record
    const float* qkw =
        work + w.qkw + (static_cast<long long>(bh) * m.NC + c) * T * T;
    for (int e = tid; e < T * T; e += THREADS) {
      const int t = e >> 6, u = e & 63;
      tsm[t * LD + u] = qkw[e] * weight(gs, cms, t, u, tn);
    }
    stage(tdn, dy + base, rs, tn, e0, m.D, false, rdn, 1.f);
    stage(x1, dy + base, rs, tn, e0, m.D, true, rdn, 1.f);
    stage(x2, v + base, rs, tn, e0, m.D, true, nullptr, 1.f);
    __syncthreads();
    // this block's share of dnum v^T
    {
      float part[4][4];
      zero(part);
      mm(part, x1, x2);
      float* pd = work + w.pdnv +
                  ((static_cast<long long>(bh) * m.NC + c) * m.NE + eb) * T *
                      T;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pd[(4 * ty + i) * T + 4 * tx + j] = part[i][j];
    }
    // dv = S^T dnum + wout dC^T k~
    float dva[4][4], dvk[4][4];
    zero(dva);
    zero(dvk);
    mm(dva, tsm, tdn);
    for (int d0 = 0; d0 < m.DP; d0 += T) {
      __syncthreads();
      stage(x1, q + base, rs, tn, d0, m.D, false, ints, 1.f);
      stage(x2, k + base, rs, tn, d0, m.D, true, nullptr, scale);
      __syncthreads();
      mm(dvk, x2, dcs + d0 * LD);
      float up[4][4];
      zero(up);
      mm(up, x1, tdn);
      __syncthreads();  // every thread has read this slab of dC
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* cp = dcs + (d0 + 4 * ty + i) * LD + 4 * tx + j;
          *cp = fmaf(carry, *cp, up[i][j]);
        }
      if (eb == 0 && tid < T) {
        float acc = 0.f;
        for (int t = 0; t < T; ++t) acc = fmaf(x1[t * LD + tid], dqs[t], acc);
        dns[d0 + tid] = fmaf(carry, dns[d0 + tid], acc);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = 4 * ty + i;
      if (u >= tn) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = e0 + 4 * tx + j;
        if (col < m.D)
          dv[base + u * rs + col] =
              from_f<X>(fmaf(wos[u], dvk[i][j], dva[i][j]));
      }
    }
  }
}

// 5. every chunk at once, 64 rows of D a block: grid (D/64, chunks, B x
// H). Shared memory: dqk [t][u] and [u][t], four tiles, the record.
template <typename X>
__global__ void __launch_bounds__(THREADS)
    mlstm_bwd_chunks_kernel(const X* __restrict__ q, const X* __restrict__ k,
                            const X* __restrict__ v,
                            const X* __restrict__ dy, X* __restrict__ dq,
                            X* __restrict__ dk, float* __restrict__ work,
                            Dims m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* dqk = reinterpret_cast<float*>(smem_raw);  // [t][u]
  float* dqkt = dqk + TILE;                          // [u][t]
  float* t1 = dqkt + TILE;
  float* t2 = t1 + TILE;
  float* t3 = t2 + TILE;
  float* t4 = t3 + TILE;
  float* gs = t4 + TILE;
  float* cms = gs + T;
  float* ints = cms + T;
  float* wos = ints + T;
  float* rdn = wos + T;
  float* dqs = rdn + T;
  float* nin = dqs + T;   // n_in and dn_out of the block's rows
  float* dno = nin + T;
  float* red = dno + T;   // [THREADS / 32]

  const Work w(m);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int db = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / m.H, h = bh % m.H;
  const int d0 = db * T, c0 = c * T, tn = min(T, m.L - c0);
  const float scale = rsqrtf(static_cast<float>(m.D));
  const long long rs = static_cast<long long>(m.H) * m.D;
  const long long base = (static_cast<long long>(b) * m.L + c0) * rs +
                         static_cast<long long>(h) * m.D;
  const long long s0 = static_cast<long long>(bh) * m.L + c0;
  const long long ci = static_cast<long long>(bh) * m.NC + c;
  load_chunk(work, w, m, bh, c, tn, gs, cms, ints, wos);
  for (int t = tid; t < T; t += THREADS) {
    rdn[t] = t < tn ? work[w.rden + s0 + t] : 0.f;
    dqs[t] = t < tn ? work[w.dqn + s0 + t] : 0.f;
    const bool dl = d0 + t < m.D;
    nin[t] = dl ? work[w.nst + ci * m.D + d0 + t] : 0.f;
    dno[t] = dl ? work[w.dno + ci * m.D + d0 + t] : 0.f;
  }
  __syncthreads();
  // dS = sum of the column blocks' dnum v^T + dqn; dqk = dS w
  const float* qkw = work + w.qkw + ci * T * T;
  for (int e = tid; e < T * T; e += THREADS) {
    const int t = e >> 6, u = e & 63;
    const float wt = weight(gs, cms, t, u, tn);
    float ds = 0.f;
    if (u <= t && t < tn) {
      ds = dqs[t];
      for (int eb = 0; eb < m.NE; ++eb)
        ds += work[w.pdnv + (ci * m.NE + eb) * T * T + e];
    }
    const float g = ds * wt;
    dqk[t * LD + u] = g;
    dqkt[u * LD + t] = g;
  }
  __syncthreads();
  if (db == 0 && tid < 2 * T) {
    // dS S = dqk qk: its row sums (over u) and column sums (over t)
    const int r = tid & 63;
    float acc = 0.f;
    if (tid < T) {
      for (int u = 0; u < T; ++u) acc = fmaf(dqk[r * LD + u], qkw[r * T + u], acc);
      if (r < tn) work[w.roww + s0 + r] = acc;
    } else {
      for (int t = 0; t < T; ++t) acc = fmaf(dqk[t * LD + r], qkw[t * T + r], acc);
      if (r < tn) work[w.colw + s0 + r] = acc;
    }
  }
  // C_in dnum and dC v for the block's rows d, summed over value columns
  float cdn[4][4], dcv[4][4];
  zero(cdn);
  zero(dcv);
  float dcar = 0.f;
  const float* cst = work + w.cst + ci * m.D * m.D;
  const float* dco = work + w.dco + ci * m.D * m.D;
  for (int e0 = 0; e0 < m.DP; e0 += T) {
    __syncthreads();
    stage(t1, dy + base, rs, tn, e0, m.D, true, rdn, 1.f);
    stage(t2, cst + static_cast<long long>(d0) * m.D, m.D, m.D - d0, e0,
          m.D, true, nullptr, 1.f);
    stage(t3, v + base, rs, tn, e0, m.D, true, nullptr, 1.f);
    stage(t4, dco + static_cast<long long>(d0) * m.D, m.D, m.D - d0, e0,
          m.D, true, nullptr, 1.f);
    __syncthreads();
    mm(cdn, t1, t2);
    mm(dcv, t3, t4);
    for (int e = tid; e < T * T; e += THREADS) {
      const int r = e >> 6, cc = e & 63;
      dcar = fmaf(t2[r * LD + cc], t4[r * LD + cc], dcar);
    }
  }
  __syncthreads();
  stage(t1, q + base, rs, tn, d0, m.D, false, nullptr, 1.f);
  stage(t2, k + base, rs, tn, d0, m.D, false, nullptr, scale);
  __syncthreads();
  float dqa[4][4], dka[4][4];
  zero(dqa);
  zero(dka);
  mm(dqa, dqkt, t2);   // sum_u dqk_tu k~_u
  mm(dka, dqk, t1);    // sum_t dqk_tu q_t
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * ty + i;
    float pin = 0.f, pout = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int dd = 4 * tx + j, d = d0 + dd;
      const float cd = fmaf(dqs[t], nin[dd], cdn[i][j]);
      const float cv = dcv[i][j] + dno[dd];
      pin = fmaf(t1[t * LD + dd], cd, pin);
      pout = fmaf(t2[t * LD + dd], cv, pout);
      if (t < tn && d < m.D) {
        dq[base + t * rs + d] = from_f<X>(fmaf(ints[t], cd, dqa[i][j]));
        dk[base + t * rs + d] =
            from_f<X>(fmaf(wos[t], cv, dka[i][j]) * scale);
      }
    }
    pin = row_sum(pin);
    pout = row_sum(pout);
    if (tx == 0 && t < tn) {
      work[w.pdi + (static_cast<long long>(bh) * m.NE + db) * m.L + c0 + t] =
          pin;
      work[w.pdw + (static_cast<long long>(bh) * m.NE + db) * m.L + c0 + t] =
          pout;
    }
  }
  // d carry's share: C_in . dC over the block's rows, and n_in . dn
  if (tid < T) dcar = fmaf(nin[tid], dno[tid], dcar);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    dcar += __shfl_xor_sync(FULL, dcar, off);
  if ((tid & 31) == 0) red[tid >> 5] = dcar;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
    work[w.pdc + ci * m.NE + db] = s;
  }
}

// 6. the gate chain: one warp per (b, h) walks the chunks in reverse (the
// stabiliser's gradient dm_in is the one value carried from chunk to
// chunk); inside a chunk, lane l takes steps 2l and 2l + 1 and every sum
// over steps is a warp scan. cm = max(m_in, cummax g) sends dcm_t to m_in
// or to the argmax of g's running max (its last index on a tie): with the
// records a (steps whose g is at least every earlier g) and P_t the sum
// of to_g dcm over steps >= t, a record a receives P_a - P_next(a).
__global__ void mlstm_bwd_chain_kernel(const float* __restrict__ fg,
                                       const float* __restrict__ dmf,
                                       float* __restrict__ di,
                                       float* __restrict__ df,
                                       const float* __restrict__ work,
                                       Dims m) {
  const Work w(m);
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (bh >= m.B * m.H) return;  // whole warps
  const int b = bh / m.H, h = bh % m.H;
  const int ta = 2 * lane;
  float dm_out = dmf != nullptr ? dmf[bh] : 0.f;
  for (int c = m.NC - 1; c >= 0; --c) {
    const int c0 = c * T, tn = min(T, m.L - c0);
    const long long s0 = static_cast<long long>(bh) * m.L + c0;
    const long long ci = static_cast<long long>(bh) * m.NC + c;
    const float m_in = work[w.minw + ci];
    const float cm_last = work[w.cmw + s0 + tn - 1];
    const float carry = expf(m_in - cm_last);
    float dcarry = 0.f;
    for (int db = 0; db < m.NE; ++db) dcarry += work[w.pdc + ci * m.NE + db];
    const float d_carry = dcarry * carry;
    float dg[2], dcm[2], dmt[2], gv[2], sint = 0.f, swo = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = ta + r;
      dg[r] = dcm[r] = dmt[r] = 0.f;
      gv[r] = -INFINITY;
      if (t >= tn) continue;
      const float g = work[w.gw + s0 + t], cm = work[w.cmw + s0 + t];
      float dint = 0.f, dwo = 0.f;
      for (int db = 0; db < m.NE; ++db) {
        const long long pi =
            (static_cast<long long>(bh) * m.NE + db) * m.L + c0 + t;
        dint += work[w.pdi + pi];
        dwo += work[w.pdw + pi];
      }
      const float d_inter = dint * expf(m_in - cm);
      const float d_wout = dwo * expf(g - cm_last);
      dg[r] = work[w.colw + s0 + t] + d_wout;
      dmt[r] = work[w.dmden + s0 + t] + (t == tn - 1 ? dm_out : 0.f);
      dcm[r] = dmt[r] - work[w.roww + s0 + t] - d_inter;
      gv[r] = g;
      sint += d_inter;
      swo += d_wout;
    }
    sint = warp_sum(sint);
    swo = warp_sum(swo);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (ta + r == tn - 1) dcm[r] -= swo + d_carry;
    // g's running max and its argmax: (value, index) pairs, a later pair
    // taking over on a tie
    float mx = gv[0];
    int ix = ta;
    if (gv[1] >= mx) {
      mx = gv[1];
      ix = ta + 1;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float om = __shfl_up_sync(FULL, mx, off);
      const int oi = __shfl_up_sync(FULL, ix, off);
      if (lane >= off && !(mx >= om)) {
        mx = om;
        ix = oi;
      }
    }
    float pm = __shfl_up_sync(FULL, mx, 1);
    int pi = __shfl_up_sync(FULL, ix, 1);
    if (lane == 0) {
      pm = -INFINITY;
      pi = -1;
    }
    const float rmx[2] = {gv[0] >= pm ? gv[0] : pm, mx};
    const int rix[2] = {gv[0] >= pm ? ta : pi, ix};
    float cv[2], rest = 0.f;
    bool rec[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool live = ta + r < tn;
      const float to_g = rmx[r] > m_in ? 1.f : rmx[r] < m_in ? 0.f : 0.5f;
      cv[r] = live ? to_g * dcm[r] : 0.f;
      rest += live ? (1.f - to_g) * dcm[r] : 0.f;
      rec[r] = live && rix[r] == ta + r;
    }
    // P_t (sums of cv over steps >= t) and each record's next record
    const float sl = suffix_sum(cv[0] + cv[1]);
    int rl = rec[0] ? ta : rec[1] ? ta + 1 : T;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_down_sync(FULL, rl, off);
      if (lane + off < 32) rl = min(rl, o);
    }
    int after = __shfl_down_sync(FULL, rl, 1);
    if (lane == 31) after = T;
    const int nxt[2] = {rec[1] ? ta + 1 : after, after};
    const float p_own[2] = {sl, sl - cv[0]};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = nxt[r], src = min(j, T - 1) >> 1;
      const float sj = __shfl_sync(FULL, sl, src);
      const float cj = __shfl_sync(FULL, cv[0], src);
      const float pj = j >= T ? 0.f : (j & 1) ? sj - cj : sj;
      if (rec[r]) dg[r] += p_own[r] - pj;
    }
    const float dm_in = d_carry + sint + warp_sum(rest);
    // df: the reverse cumsum of dmt - dg, through sigmoid(-f)
    const float x0 = dmt[0] - dg[0], x1 = dmt[1] - dg[1];
    const float run = suffix_sum(x0 + x1);
    const float runs[2] = {run, run - x0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = ta + r;
      if (t >= tn) continue;
      const long long gi = (static_cast<long long>(b) * m.L + c0 + t) * m.H + h;
      di[gi] = dg[r];
      df[gi] = runs[r] / (1.f + expf(fg[gi]));
    }
    dm_out = dm_in;
  }
}

// ---------------------------------------------------------------------------
// bf16: the product kernels on the tensor cores
// ---------------------------------------------------------------------------

constexpr int LDK = T + 8;      // padded row of a bf16 tile (16 bytes)
constexpr int BTILE = T * LDK;  // bf16 elements of a tile

// The lanes' fragment positions: warp w = (wi, wj) = (w & 3, w >> 2) owns
// rows 16 wi .. 16 wi + 15 and columns 32 wj .. 32 wj + 31 of a 64 x 64
// product; acc[n][e] is row 16 wi + g + 8 (e >> 1), column
// 32 wj + 8 n + 2 t4 + (e & 1). And the ldmatrix row and column offsets
// (lane l gives row l & 7 of matrix l >> 3): A from a [m][k] tile; B from
// an [n][k] tile (two n-tiles); B from a [k][n] tile (.trans, two
// n-tiles); A from a [k][m] tile (.trans).
struct Frag {
  int g, t4, wi, wj, a_row, a_col, k_row, k_col;
  __device__ Frag() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int lrow = lane & 7, lmat = lane >> 3;
    g = lane >> 2;
    t4 = lane & 3;
    wi = warp & 3;
    wj = warp >> 2;
    a_row = ((lmat & 1) << 3) + lrow;
    a_col = (lmat >> 1) << 3;
    k_row = ((lmat >> 1) << 3) + lrow;
    k_col = (lmat & 1) << 3;
  }
  __device__ int row(int e) const { return 16 * wi + g + 8 * (e >> 1); }
  __device__ int col(int n, int e) const {
    return 32 * wj + 8 * n + 2 * t4 + (e & 1);
  }
};

__device__ __forceinline__ void tc_zero(float (&acc)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// acc += A B over k-steps kk < klim (16 of K each, K = 64), from bf16
// tiles of row stride LDK: A [m][k], or [k][m] if AT; B [n][k], or [k][n]
// if BT. A float32 operand comes as hi and lo tiles (AS, BS): hi.hi +
// hi.lo + lo.hi. With `causal`, the warp skips the n-tile pairs right of
// its rows' diagonal block (output [t][u], u <= t).
template <bool AT, bool BT, bool AS, bool BS>
__device__ __forceinline__ void tc_mma(float (&acc)[4][4], const Frag& f,
                                       const bf16* ah, const bf16* al,
                                       const bf16* bh, const bf16* bl,
                                       int klim = T / 16,
                                       bool causal = false) {
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) {
    if (kk >= klim) break;
    uint32_t a[4], a2[4];
    const int aoff = AT ? (kk * 16 + f.k_row) * LDK + 16 * f.wi + f.k_col
                        : (16 * f.wi + f.a_row) * LDK + kk * 16 + f.a_col;
    if (AT) {
      ldmatrix_x4_trans(a, smem_u32(ah + aoff));
      if (AS) ldmatrix_x4_trans(a2, smem_u32(al + aoff));
    } else {
      ldmatrix_x4(a, smem_u32(ah + aoff));
      if (AS) ldmatrix_x4(a2, smem_u32(al + aoff));
    }
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (causal && 2 * f.wj + np > f.wi) continue;
      uint32_t b[4], b2[4];
      const int boff =
          BT ? (kk * 16 + f.a_row) * LDK + 32 * f.wj + 16 * np + f.a_col
             : (32 * f.wj + 16 * np + f.k_row) * LDK + kk * 16 + f.k_col;
      if (BT) {
        ldmatrix_x4_trans(b, smem_u32(bh + boff));
        if (BS) ldmatrix_x4_trans(b2, smem_u32(bl + boff));
      } else {
        ldmatrix_x4(b, smem_u32(bh + boff));
        if (BS) ldmatrix_x4(b2, smem_u32(bl + boff));
      }
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      if (BS) {
        mma_bf16(acc[2 * np], a, b2[0], b2[1]);
        mma_bf16(acc[2 * np + 1], a, b2[2], b2[3]);
      }
      if (AS) {
        mma_bf16(acc[2 * np], a2, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a2, b[2], b[3]);
      }
    }
  }
}

// Stage a 64 x 64 bf16 tile into dst (row stride LDK): rows r < rlim of
// base + r * rstride, columns c0 .. c0 + 63 live below clim; zeros
// elsewhere. With `vec` by 16-byte cp.async copies (commit and wait
// separately), else by plain loads and stores.
__device__ __forceinline__ void tc_stage(bf16* dst, const bf16* base,
                                         long long rstride, int rlim, int c0,
                                         int clim, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < T * T / 8 / THREADS; ++i) {
      const int slot = tid + i * THREADS;
      const int r = slot >> 3, c = (slot & 7) * 8;
      const bool in = r < rlim && c0 + c < clim;
      cp_async16(dst + r * LDK + c, in ? base + r * rstride + c0 + c : base,
                 in);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < T * T; e += THREADS) {
      const int r = e >> 6, c = e & 63;
      dst[r * LDK + c] =
          r < rlim && c0 + c < clim ? base[r * rstride + c0 + c] : zero;
    }
  }
}

// hi and lo bf16 parts of v0, v1 stored as pairs at hi + off, lo + off
__device__ __forceinline__ void put_split(bf16* hi, bf16* lo, int off,
                                          float v0, float v1) {
  uint32_t h, l;
  split_pair(v0, v1, h, l);
  *reinterpret_cast<uint32_t*>(hi + off) = h;
  *reinterpret_cast<uint32_t*>(lo + off) = l;
}

// Copy a slice's hi and lo tiles [rows][LDK] (columns e0 .. e0 + 63 of a
// D x D matrix) to the hi then lo D x D matrices at `dst`, 16 bytes at a
// time when `vec` (D % 8 == 0), else element by element.
__device__ __forceinline__ void put_slice(bf16* dst, const bf16* hi,
                                          const bf16* lo, int D, int e0,
                                          bool vec) {
  const long long dd2 = static_cast<long long>(D) * D;
  if (vec) {
    for (int e = threadIdx.x; e < D * T / 8; e += THREADS) {
      const int d = e >> 3, col = (e & 7) * 8;
      if (e0 + col >= D) continue;
      bf16* o = dst + static_cast<long long>(d) * D + e0 + col;
      *reinterpret_cast<uint4*>(o) =
          *reinterpret_cast<const uint4*>(hi + d * LDK + col);
      *reinterpret_cast<uint4*>(o + dd2) =
          *reinterpret_cast<const uint4*>(lo + d * LDK + col);
    }
  } else {
    for (int e = threadIdx.x; e < D * T; e += THREADS) {
      const int d = e >> 6, col = e & 63;
      if (e0 + col >= D) continue;
      bf16* o = dst + static_cast<long long>(d) * D + e0 + col;
      o[0] = hi[d * LDK + col];
      o[dd2] = lo[d * LDK + col];
    }
  }
}

__device__ __forceinline__ float2 get2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// each live row's sum of a fragment over the warp's 32 columns (rows
// g and g + 8 in rs[0], rs[1] of the lanes with t4 = 0)
__device__ __forceinline__ void quad_rows(float (&rs)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(FULL, rs[r], 1);
    rs[r] += __shfl_xor_sync(FULL, rs[r], 2);
  }
}

// 2. the forward's walk on the tensor cores, recording the chunk states.
// Block (64 value columns e0 .., head, batch row). Shared memory: C's
// slice as bf16 hi and lo [DP][LDK] (~16 bits, re-split after each
// update, as csrc/mlstm_chunk.cu carries it); tiles q, k (slabs [t][d],
// [u][d]), v [u][e], and two more that hold k w_out / sqrt(D) (hi, lo)
// during the slabs and S (hi, lo) after; n and n_in; the record. Writes
// C_in (bf16 hi then lo matrices, in the bytes of the float32 one) and
// n_in of every chunk, q k~^T and qn (first block), and the block's
// share of dy . num.
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_bwd_forward_tc_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dy,
                                float* __restrict__ work, Dims m, int vec,
                                int vec_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* chs = reinterpret_cast<bf16*>(smem_raw);  // [d][e] hi
  bf16* cls = chs + m.DP * LDK;                   // [d][e] lo
  bf16* qs0 = cls + m.DP * LDK;                   // 2 x [t][d]
  bf16* ks0 = qs0 + 2 * BTILE;                       // 2 x [u][d]
  bf16* vs = ks0 + 2 * BTILE;                        // [u][e]
  bf16* sh = vs + BTILE;                             // k w_out, then S: hi
  bf16* sl = sh + BTILE;                             //                  lo
  float* ns = reinterpret_cast<float*>(sl + BTILE);  // [DP]
  float* nins = ns + m.DP;                        // [DP]
  float* gs = nins + m.DP;                        // [T] each
  float* cms = gs + T;
  float* ints = cms + T;
  float* wos = ints + T;
  float* qnin = wos + T;
  float* red = qnin + T;                          // [2][T]
  float* red2 = red + 2 * T;                      // [2][T]

  const Work w(m);
  const Frag f;
  const int tid = threadIdx.x;
  const int eb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int e0 = eb * T, bh = b * m.H + h;
  const float scale = rsqrtf(static_cast<float>(m.D));
  const long long rs = static_cast<long long>(m.H) * m.D;  // step stride
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < 2 * m.DP * LDK; i += THREADS) chs[i] = zero;
  for (int i = tid; i < m.DP; i += THREADS) ns[i] = 0.f;
  // step s = (chunk, slab of D) in order; its q and k in buffer s & 1,
  // staged a step ahead
  const int nsteps = m.NC * m.NE;
  const auto stage_step = [&](int s_) {
    const int cc = s_ / m.NE, ds = (s_ - cc * m.NE) * T;
    const long long bs_ = (static_cast<long long>(b) * m.L + cc * T) * rs +
                          static_cast<long long>(h) * m.D;
    const int tn_ = min(T, m.L - cc * T);
    tc_stage(qs0 + (s_ & 1) * BTILE, q + bs_, rs, tn_, ds, m.D, vec);
    tc_stage(ks0 + (s_ & 1) * BTILE, k + bs_, rs, tn_, ds, m.D, vec);
  };
  stage_step(0);
  cp_async_commit();

  for (int c = 0, step = 0; c < m.NC; ++c) {
    const int c0 = c * T, tn = min(T, m.L - c0);
    const long long base = (static_cast<long long>(b) * m.L + c0) * rs +
                           static_cast<long long>(h) * m.D;
    __syncthreads();  // the last chunk's readers are done
    const float carry = load_chunk(work, w, m, bh, c, tn, gs, cms, ints, wos);
    // C_in and n_in of this chunk
    put_slice(reinterpret_cast<bf16*>(work + w.cst +
                                      (static_cast<long long>(bh) * m.NC +
                                       c) * m.D * m.D),
              chs, cls, m.D, e0, vec_w);
    for (int d = tid; d < m.DP; d += THREADS) {
      nins[d] = ns[d];
      if (eb == 0 && d < m.D)
        work[w.nst + (static_cast<long long>(bh) * m.NC + c) * m.D + d] =
            ns[d];
    }
    if (tid < T) qnin[tid] = 0.f;
    tc_stage(vs, v + base, rs, tn, e0, m.D, vec);
    cp_async_commit();
    float qk[4][4], qc[4][4];
    tc_zero(qk);
    tc_zero(qc);
    for (int d0 = 0; d0 < m.DP; d0 += T, ++step) {
      __syncthreads();  // the last slab's readers are done
      if (step + 1 < nsteps) {
        stage_step(step + 1);
        cp_async_commit();
        cp_async_wait<1>();  // this step's slab (and the chunk's v)
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* qs = qs0 + (step & 1) * BTILE;
      const bf16* ks = ks0 + (step & 1) * BTILE;
      // q k^T (keys left of the diagonal) and q C_in (this slab's rows)
      tc_mma<false, false, false, false>(qk, f, qs, nullptr, ks, nullptr,
                                         T / 16, true);
      tc_mma<false, true, false, true>(qc, f, qs, nullptr, chs + d0 * LDK,
                                       cls + d0 * LDK);
      if (eb == 0 && tid < T) {
        float acc = qnin[tid];
        for (int dd = 0; dd < T; dd += 2) {
          const float2 qv = get2(qs + tid * LDK + dd);
          acc = fmaf(qv.x, nins[d0 + dd], fmaf(qv.y, nins[d0 + dd + 1], acc));
        }
        qnin[tid] = acc;
      }
      // k w_out / sqrt(D) as hi and lo tiles [u][d]
      for (int e = tid; e < T * T / 2; e += THREADS) {
        const int u = e >> 5, dd = 2 * (e & 31);
        const float2 kv = get2(ks + u * LDK + dd);
        const float wv = scale * wos[u];
        put_split(sh, sl, u * LDK + dd, kv.x * wv, kv.y * wv);
      }
      __syncthreads();  // every read of this slab of C_in is done
      // C <- carry C + (k w_out)^T v for the slab's rows d (A [u][d])
      float up[4][4];
      tc_zero(up);
      tc_mma<true, true, true, false>(up, f, sh, sl, vs, nullptr,
                                      (tn + 15) / 16);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (d0 + f.row(2 * r)) * LDK + f.col(n, 0);
          const float2 hv = get2(chs + off), lv = get2(cls + off);
          put_split(chs, cls, off, fmaf(carry, hv.x + lv.x, up[n][2 * r]),
                    fmaf(carry, hv.y + lv.y, up[n][2 * r + 1]));
        }
      if (eb == 0 && tid < T) {  // n's update in float32, from k as given
        float acc = 0.f;
        for (int u = 0; u < T; ++u)
          acc = fmaf(__bfloat162float(ks[u * LDK + tid]), scale * wos[u],
                     acc);
        ns[d0 + tid] = fmaf(carry, ns[d0 + tid], acc);
      }
    }
    __syncthreads();  // every reader of the k w_out tiles is done
    // S = q k~^T w as hi and lo tiles [t][u], its row sums; q k~^T
    // recorded by the first block
    float* qkw =
        work + w.qkw + (static_cast<long long>(bh) * m.NC + c) * T * T;
    {
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = f.row(2 * r), u = f.col(n, 0);
          const float q0 = qk[n][2 * r] * scale, q1 = qk[n][2 * r + 1] * scale;
          if (eb == 0) {
            qkw[t * T + u] = q0;
            qkw[t * T + u + 1] = q1;
          }
          const float s0 = q0 * weight(gs, cms, t, u, tn);
          const float s1 = q1 * weight(gs, cms, t, u + 1, tn);
          rsum[r] += s0 + s1;
          put_split(sh, sl, t * LDK + u, s0, s1);
        }
      quad_rows(rsum);
      if (f.t4 == 0) {
        red[f.wj * T + f.row(0)] = rsum[0];
        red[f.wj * T + f.row(2)] = rsum[1];
      }
    }
    __syncthreads();
    if (eb == 0 && tid < tn)
      work[w.qnw + static_cast<long long>(bh) * m.L + c0 + tid] =
          red[tid] + red[T + tid] + ints[tid] * qnin[tid];
    // num = S v + inter q C_in; this block's share of dy . num
    float num[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) num[n][e] = qc[n][e] * ints[f.row(e)];
    tc_mma<false, true, true, false>(num, f, sh, sl, vs, nullptr, f.wi + 1);
    {
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = f.row(2 * r);
        if (t >= tn) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = e0 + f.col(n, 0);
          const bf16* dr = dy + base + t * rs + col;
          if (col < m.D)
            part[r] = fmaf(__bfloat162float(dr[0]), num[n][2 * r], part[r]);
          if (col + 1 < m.D)
            part[r] = fmaf(__bfloat162float(dr[1]), num[n][2 * r + 1],
                           part[r]);
        }
      }
      quad_rows(part);
      if (f.t4 == 0) {
        red2[f.wj * T + f.row(0)] = part[0];
        red2[f.wj * T + f.row(2)] = part[1];
      }
    }
    __syncthreads();
    if (tid < tn)
      work[w.ynp + (static_cast<long long>(bh) * m.NE + eb) * m.L + c0 + tid] =
          red2[tid] + red2[T + tid];
  }
}

// 4. the chunks in reverse with dC's slice on the tensor cores. Block (64
// value columns, head, batch row). Shared memory: dC's slice as bf16 hi
// and lo [DP][LDK]; dn (first block); tiles S (hi, lo) [t][u], dy then
// dnum = dy / den (hi in dy's tile, lo), v [u][e], q then inter q (hi in
// q's tile, lo) [t][d], k [u][d]; the record. Once S^T dnum is done, S's
// tiles take every other slab's q and k, so the next slab's copies are
// in flight while one computes.
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_bwd_reverse_tc_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dy,
                                const float* __restrict__ dcf,
                                const float* __restrict__ dnf,
                                bf16* __restrict__ dv,
                                float* __restrict__ work, Dims m, int vec,
                                int vec_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* dch = reinterpret_cast<bf16*>(smem_raw);  // [d][e] hi
  bf16* dcl = dch + m.DP * LDK;                   // [d][e] lo
  bf16* shh = dcl + m.DP * LDK;                   // S [t][u] hi
  bf16* shl = shh + BTILE;                           //          lo
  bf16* dnh = shl + BTILE;                           // dy, then dnum hi [t][e]
  bf16* dnl = dnh + BTILE;                           //          dnum lo
  bf16* vs = dnl + BTILE;                            // v [u][e]
  bf16* iqh = vs + BTILE;                            // q, then inter q hi
  bf16* iql = iqh + BTILE;                           //          inter q lo
  bf16* ks = iql + BTILE;                            // k [u][d]
  float* dns = reinterpret_cast<float*>(ks + BTILE);  // [DP]
  float* gs = dns + m.DP;                          // [T] each
  float* cms = gs + T;
  float* ints = cms + T;
  float* wos = ints + T;
  float* rdn = wos + T;
  float* dqs = rdn + T;

  const Work w(m);
  const Frag f;
  const int tid = threadIdx.x;
  const int eb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int e0 = eb * T, bh = b * m.H + h;
  const float scale = rsqrtf(static_cast<float>(m.D));
  const long long rs = static_cast<long long>(m.H) * m.D;
  for (int e = tid; e < m.DP * T / 2; e += THREADS) {
    const int d = e >> 5, col = 2 * (e & 31);
    float v0 = 0.f, v1 = 0.f;
    if (dcf != nullptr && d < m.D) {
      const float* src = dcf + (static_cast<long long>(bh) * m.D + d) * m.D;
      if (e0 + col < m.D) v0 = src[e0 + col];
      if (e0 + col + 1 < m.D) v1 = src[e0 + col + 1];
    }
    put_split(dch, dcl, d * LDK + col, v0, v1);
  }
  for (int d = tid; d < m.DP; d += THREADS)
    dns[d] = dnf != nullptr && d < m.D
                 ? dnf[static_cast<long long>(bh) * m.D + d]
                 : 0.f;

  for (int c = m.NC - 1; c >= 0; --c) {
    const int c0 = c * T, tn = min(T, m.L - c0);
    const long long base = (static_cast<long long>(b) * m.L + c0) * rs +
                           static_cast<long long>(h) * m.D;
    const long long s0 = static_cast<long long>(bh) * m.L + c0;
    const long long ci = static_cast<long long>(bh) * m.NC + c;
    __syncthreads();  // the last chunk's update is done
    const float carry = load_chunk(work, w, m, bh, c, tn, gs, cms, ints, wos);
    for (int t = tid; t < T; t += THREADS) {
      rdn[t] = t < tn ? work[w.rden + s0 + t] : 0.f;
      dqs[t] = t < tn ? work[w.dqn + s0 + t] : 0.f;
    }
    // the cotangent this chunk's output state receives (hi, lo matrices)
    put_slice(reinterpret_cast<bf16*>(work + w.dco + ci * m.D * m.D), dch,
              dcl, m.D, e0, vec_w);
    if (eb == 0)
      for (int d = tid; d < m.D; d += THREADS)
        work[w.dno + ci * m.D + d] = dns[d];
    tc_stage(dnh, dy + base, rs, tn, e0, m.D, vec);
    tc_stage(vs, v + base, rs, tn, e0, m.D, vec);
    tc_stage(iqh, q + base, rs, tn, 0, m.D, vec);  // slab 0's q and k
    tc_stage(ks, k + base, rs, tn, 0, m.D, vec);
    cp_async_commit();
    __syncthreads();  // the record
    // S = q k~^T w as hi and lo tiles [t][u]
    const float* qkw = work + w.qkw + ci * T * T;
    for (int e = tid; e < T * T / 2; e += THREADS) {
      const int t = e >> 5, u = 2 * (e & 31);
      put_split(shh, shl, t * LDK + u,
                qkw[t * T + u] * weight(gs, cms, t, u, tn),
                qkw[t * T + u + 1] * weight(gs, cms, t, u + 1, tn));
    }
    cp_async_wait<0>();
    __syncthreads();
    // this block's share of dnum v^T: (dy v^T) / den by rows t
    {
      float part[4][4];
      tc_zero(part);
      tc_mma<false, false, false, false>(part, f, dnh, nullptr, vs, nullptr,
                                         T / 16, true);
      float* pd = work + w.pdnv + (ci * m.NE + eb) * T * T;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = f.row(2 * r), u = f.col(n, 0);
          *reinterpret_cast<float2*>(pd + t * T + u) = make_float2(
              part[n][2 * r] * rdn[t], part[n][2 * r + 1] * rdn[t]);
        }
    }
    __syncthreads();  // every read of dy is done
    // dnum = dy / den, split in place
    for (int e = tid; e < T * T / 2; e += THREADS) {
      const int t = e >> 5, col = 2 * (e & 31);
      const float2 yv = get2(dnh + t * LDK + col);
      put_split(dnh, dnl, t * LDK + col, yv.x * rdn[t], yv.y * rdn[t]);
    }
    __syncthreads();
    // dv = S^T dnum + w_out dC^T k~ (rows u)
    float dva[4][4], dvk[4][4];
    tc_zero(dva);
    tc_zero(dvk);
    tc_mma<true, true, true, true>(dva, f, shh, shl, dnh, dnl);
    // slab i's q and k in (iqh, ks) for even i, in S's free tiles for odd
    // i, each staged a slab ahead
    for (int d0 = 0, i = 0; d0 < m.DP; d0 += T, ++i) {
      __syncthreads();  // the last slab's readers (and dva's) are done
      if (d0 + T < m.DP) {
        tc_stage(i & 1 ? iqh : shh, q + base, rs, tn, d0 + T, m.D, vec);
        tc_stage(i & 1 ? ks : shl, k + base, rs, tn, d0 + T, m.D, vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      bf16* qb = i & 1 ? shh : iqh;
      const bf16* kb = i & 1 ? shl : ks;
      // dn's update in float32, from q as given (before q's tile is split)
      float dn_acc = 0.f;
      if (eb == 0 && tid < T)
        for (int t = 0; t < T; ++t)
          dn_acc = fmaf(__bfloat162float(qb[t * LDK + tid]), ints[t] * dqs[t],
                        dn_acc);
      __syncthreads();
      for (int e = tid; e < T * T / 2; e += THREADS) {
        const int t = e >> 5, dd = 2 * (e & 31);
        const float2 qv = get2(qb + t * LDK + dd);
        put_split(qb, iql, t * LDK + dd, qv.x * ints[t], qv.y * ints[t]);
      }
      __syncthreads();
      // k dC (rows u, k over this slab's d) and (inter q)^T dnum (rows d)
      tc_mma<false, true, false, true>(dvk, f, kb, nullptr, dch + d0 * LDK,
                                       dcl + d0 * LDK);
      float up[4][4];
      tc_zero(up);
      tc_mma<true, true, true, true>(up, f, qb, iql, dnh, dnl,
                                     (tn + 15) / 16);
      __syncthreads();  // every read of this slab of dC is done
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = (d0 + f.row(2 * r)) * LDK + f.col(n, 0);
          const float2 hv = get2(dch + off), lv = get2(dcl + off);
          put_split(dch, dcl, off, fmaf(carry, hv.x + lv.x, up[n][2 * r]),
                    fmaf(carry, hv.y + lv.y, up[n][2 * r + 1]));
        }
      if (eb == 0 && tid < T)
        dns[d0 + tid] = fmaf(carry, dns[d0 + tid], dn_acc);
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int u = f.row(2 * r), col = e0 + f.col(n, 0);
        if (u >= tn) continue;
        const float wv = wos[u] * scale;
        const float o0 = fmaf(wv, dvk[n][2 * r], dva[n][2 * r]);
        const float o1 = fmaf(wv, dvk[n][2 * r + 1], dva[n][2 * r + 1]);
        bf16* dr = dv + base + u * rs + col;
        if (vec) {
          if (col < m.D)
            *reinterpret_cast<__nv_bfloat162*>(dr) =
                __floats2bfloat162_rn(o0, o1);
        } else {
          if (col < m.D) dr[0] = __float2bfloat16(o0);
          if (col + 1 < m.D) dr[1] = __float2bfloat16(o1);
        }
      }
  }
}

// 5. every chunk at once on the tensor cores, 64 rows of D a block: grid
// (D/64, chunks, B x H). Shared memory: dS w (hi, lo) [t][u]; per slab of
// value columns dy [t][e], C_in (hi, lo) and dC (hi, lo) rows [d][e],
// v [u][e]; then q [t][d] and k [u][d] over dy's and v's tiles.
__global__ void __launch_bounds__(THREADS)
    mlstm_bwd_chunks_tc_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dy,
                               bf16* __restrict__ dq, bf16* __restrict__ dk,
                               float* __restrict__ work, Dims m, int vec,
                               int vec_w) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gh = reinterpret_cast<bf16*>(smem_raw);  // dS w [t][u] hi
  bf16* gl = gh + BTILE;                             //             lo
  bf16* t1 = gl + BTILE;                             // dy [t][e], then q
  bf16* chh = t1 + BTILE;                            // C_in [d][e] hi
  bf16* chl = chh + BTILE;                           //             lo
  bf16* t3 = chl + BTILE;                            // v [u][e], then k
  bf16* dhh = t3 + BTILE;                            // dC [d][e] hi
  bf16* dhl = dhh + BTILE;                           //           lo
  float* gs = reinterpret_cast<float*>(dhl + BTILE);  // [T] each
  float* cms = gs + T;
  float* ints = cms + T;
  float* wos = ints + T;
  float* rdn = wos + T;
  float* dqs = rdn + T;
  float* nin = dqs + T;   // n_in and dn_out of the block's rows
  float* dno = nin + T;
  float* colp = dno + T;  // [4][T]
  float* rowp = colp + 4 * T;  // [2][T]
  float* pins = rowp + 2 * T;  // [2][T]
  float* pous = pins + 2 * T;  // [2][T]
  float* red = pous + 2 * T;   // [THREADS / 32]

  const Work w(m);
  const Frag f;
  const int tid = threadIdx.x;
  const int db = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / m.H, h = bh % m.H;
  const int d0 = db * T, c0 = c * T, tn = min(T, m.L - c0);
  const float scale = rsqrtf(static_cast<float>(m.D));
  const long long rs = static_cast<long long>(m.H) * m.D;
  const long long base = (static_cast<long long>(b) * m.L + c0) * rs +
                         static_cast<long long>(h) * m.D;
  const long long s0 = static_cast<long long>(bh) * m.L + c0;
  const long long ci = static_cast<long long>(bh) * m.NC + c;
  load_chunk(work, w, m, bh, c, tn, gs, cms, ints, wos);
  for (int t = tid; t < T; t += THREADS) {
    rdn[t] = t < tn ? work[w.rden + s0 + t] : 0.f;
    dqs[t] = t < tn ? work[w.dqn + s0 + t] : 0.f;
    const bool dl = d0 + t < m.D;
    nin[t] = dl ? work[w.nst + ci * m.D + d0 + t] : 0.f;
    dno[t] = dl ? work[w.dno + ci * m.D + d0 + t] : 0.f;
  }
  __syncthreads();
  // dS = the column blocks' dnum v^T + dqn; dqk = dS w, split; dqk . qk's
  // row sums (over u, a warp's 32 lanes) and column sums (thread u's 16
  // rows, then 4 threads in order)
  const float* qkw = work + w.qkw + ci * T * T;
  {
    const int u = tid & 63;
    float cacc = 0.f;
    for (int i = 0; i < T * T / THREADS; ++i) {
      const int t = (tid >> 6) + 4 * i, e = t * T + u;
      const float wt = weight(gs, cms, t, u, tn);
      float ds = 0.f;
      if (u <= t && t < tn) {
        ds = dqs[t];
        for (int eb = 0; eb < m.NE; ++eb)
          ds += work[w.pdnv + (ci * m.NE + eb) * T * T + e];
      }
      const float gv = ds * wt;
      const bf16 hi = __float2bfloat16(gv);
      gh[t * LDK + u] = hi;
      gl[t * LDK + u] = __float2bfloat16(gv - __bfloat162float(hi));
      const float prod = gv * qkw[e];
      cacc += prod;
      float racc = prod;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
        racc += __shfl_xor_sync(FULL, racc, off);
      if ((tid & 31) == 0) rowp[(u >> 5) * T + t] = racc;
    }
    colp[(tid >> 6) * T + u] = cacc;
  }
  __syncthreads();
  if (db == 0 && tid < 2 * T) {
    const int r = tid & 63;
    if (r < tn) {
      if (tid < T)
        work[w.roww + s0 + r] = rowp[r] + rowp[T + r];
      else
        work[w.colw + s0 + r] =
            colp[r] + colp[T + r] + colp[2 * T + r] + colp[3 * T + r];
    }
  }
  // C_in dnum (rows t) and v dC^T (rows u), summed over value columns;
  // d carry's share: C_in . dC over the block's rows
  float cdn[4][4], dcv[4][4];
  tc_zero(cdn);
  tc_zero(dcv);
  float dcar = 0.f;
  const bf16* cst =
      reinterpret_cast<const bf16*>(work + w.cst + ci * m.D * m.D);
  const bf16* dco =
      reinterpret_cast<const bf16*>(work + w.dco + ci * m.D * m.D);
  const long long dd2 = static_cast<long long>(m.D) * m.D;
  const int drows = min(T, m.D - d0);
  for (int ec = 0; ec < m.DP; ec += T) {
    __syncthreads();  // the last slab's readers are done
    tc_stage(t1, dy + base, rs, tn, ec, m.D, vec);
    tc_stage(t3, v + base, rs, tn, ec, m.D, vec);
    tc_stage(chh, cst + static_cast<long long>(d0) * m.D, m.D, drows, ec,
             m.D, vec_w);
    tc_stage(chl, cst + dd2 + static_cast<long long>(d0) * m.D, m.D, drows,
             ec, m.D, vec_w);
    tc_stage(dhh, dco + static_cast<long long>(d0) * m.D, m.D, drows, ec,
             m.D, vec_w);
    tc_stage(dhl, dco + dd2 + static_cast<long long>(d0) * m.D, m.D, drows,
             ec, m.D, vec_w);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tc_mma<false, false, false, true>(cdn, f, t1, nullptr, chh, chl);
    tc_mma<false, false, false, true>(dcv, f, t3, nullptr, dhh, dhl);
    for (int e = tid; e < T * T / 2; e += THREADS) {
      const int r = e >> 5, cc = 2 * (e & 31);
      const int o = r * LDK + cc;
      const float2 ch = get2(chh + o), cl = get2(chl + o);
      const float2 dh = get2(dhh + o), dl = get2(dhl + o);
      dcar = fmaf(ch.x + cl.x, dh.x + dl.x,
                  fmaf(ch.y + cl.y, dh.y + dl.y, dcar));
    }
  }
  __syncthreads();
  tc_stage(t1, q + base, rs, tn, d0, m.D, vec);
  tc_stage(t3, k + base, rs, tn, d0, m.D, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float dqa[4][4], dka[4][4];
  tc_zero(dqa);
  tc_zero(dka);
  tc_mma<false, true, true, false>(dqa, f, gh, gl, t3, nullptr, f.wi + 1);
  tc_mma<true, true, true, false>(dka, f, gh, gl, t1, nullptr);
  float pin[2] = {0.f, 0.f}, pout[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = f.row(e), dd = f.col(n, e), d = d0 + dd;
      const float cd = fmaf(dqs[t], nin[dd], cdn[n][e] * rdn[t]);
      const float cv = dcv[n][e] + dno[dd];
      pin[e >> 1] = fmaf(__bfloat162float(t1[t * LDK + dd]), cd, pin[e >> 1]);
      pout[e >> 1] =
          fmaf(__bfloat162float(t3[t * LDK + dd]) * scale, cv, pout[e >> 1]);
      if (t < tn && d < m.D) {
        dq[base + t * rs + d] =
            __float2bfloat16(fmaf(ints[t], cd, dqa[n][e] * scale));
        dk[base + t * rs + d] =
            __float2bfloat16(fmaf(wos[t], cv, dka[n][e]) * scale);
      }
    }
  quad_rows(pin);
  quad_rows(pout);
  if (f.t4 == 0) {
    pins[f.wj * T + f.row(0)] = pin[0];
    pins[f.wj * T + f.row(2)] = pin[1];
    pous[f.wj * T + f.row(0)] = pout[0];
    pous[f.wj * T + f.row(2)] = pout[1];
  }
  // d carry's share: C_in . dC over the block's rows, and n_in . dn
  if (tid < T) dcar = fmaf(nin[tid], dno[tid], dcar);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    dcar += __shfl_xor_sync(FULL, dcar, off);
  if ((tid & 31) == 0) red[tid >> 5] = dcar;
  __syncthreads();
  if (tid < tn) {
    const long long pi =
        (static_cast<long long>(bh) * m.NE + db) * m.L + c0 + tid;
    work[w.pdi + pi] = pins[tid] + pins[T + tid];
    work[w.pdw + pi] = pous[tid] + pous[T + tid];
  }
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < THREADS / 32; ++i) s += red[i];
    work[w.pdc + ci * m.NE + db] = s;
  }
}

size_t forward_smem(const Dims& m) {
  return sizeof(float) * (static_cast<size_t>(m.DP) * LD + m.DP + 4 * TILE +
                          5 * T);
}
size_t reverse_smem(const Dims& m) {
  return sizeof(float) * (static_cast<size_t>(m.DP) * LD + m.DP + 4 * TILE +
                          6 * T);
}
size_t chunks_smem() {
  return sizeof(float) * (6 * TILE + 8 * T + THREADS / 32);
}
size_t forward_tc_smem(const Dims& m) {
  return sizeof(bf16) * (2 * static_cast<size_t>(m.DP) * LDK + 7 * BTILE) +
         sizeof(float) * (2 * m.DP + 9 * T);
}
size_t reverse_tc_smem(const Dims& m) {
  return sizeof(bf16) * (2 * static_cast<size_t>(m.DP) * LDK + 8 * BTILE) +
         sizeof(float) * (m.DP + 6 * T);
}
size_t chunks_tc_smem() {
  return sizeof(bf16) * 8 * BTILE + sizeof(float) * (18 * T + THREADS / 32);
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <typename X>
int launch(const X* q, const X* k, const X* v, const float* ig,
           const float* fg, const X* dy, const float* dcf, const float* dnf,
           const float* dmf, X* dq, X* dk, X* dv, float* di, float* df,
           float* work, int B, int L, int H, int D, cudaStream_t s) {
  const Dims m(B, L, H, D);
  const int bh = B * H;
  const long long steps = static_cast<long long>(bh) * L;
  const dim3 walk(m.NE, H, B), chunks(m.NE, m.NC, bh);
  const int warps = (bh + 3) / 4;  // blocks of 4 warps, a warp per (b, h)
  if constexpr (sizeof(X) == 2) {
    const auto aligned = [](const void* p) {
      return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
    };
    const int vec = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                    aligned(dy) && aligned(dv);
    const int vec_w = D % 8 == 0;
    int err = set_smem(reinterpret_cast<const void*>(
                           mlstm_bwd_forward_tc_kernel),
                       forward_tc_smem(m));
    if (!err)
      err = set_smem(reinterpret_cast<const void*>(
                         mlstm_bwd_reverse_tc_kernel),
                     reverse_tc_smem(m));
    if (!err)
      err = set_smem(reinterpret_cast<const void*>(
                         mlstm_bwd_chunks_tc_kernel),
                     chunks_tc_smem());
    if (err) return err;
    mlstm_bwd_gates_kernel<<<warps, 128, 0, s>>>(ig, fg, work, m);
    mlstm_bwd_forward_tc_kernel<<<walk, THREADS, forward_tc_smem(m), s>>>(
        q, k, v, dy, work, m, vec, vec_w);
    mlstm_bwd_steps_kernel<<<static_cast<unsigned>((steps + 255) / 256),
                             256, 0, s>>>(work, m);
    mlstm_bwd_reverse_tc_kernel<<<walk, THREADS, reverse_tc_smem(m), s>>>(
        q, k, v, dy, dcf, dnf, dv, work, m, vec, vec_w);
    mlstm_bwd_chunks_tc_kernel<<<chunks, THREADS, chunks_tc_smem(), s>>>(
        q, k, v, dy, dq, dk, work, m, vec, vec_w);
  } else {
    int err = set_smem(reinterpret_cast<const void*>(
                           mlstm_bwd_forward_kernel<X>),
                       forward_smem(m));
    if (!err)
      err = set_smem(reinterpret_cast<const void*>(
                         mlstm_bwd_reverse_kernel<X>),
                     reverse_smem(m));
    if (!err)
      err = set_smem(reinterpret_cast<const void*>(
                         mlstm_bwd_chunks_kernel<X>),
                     chunks_smem());
    if (err) return err;
    mlstm_bwd_gates_kernel<<<warps, 128, 0, s>>>(ig, fg, work, m);
    mlstm_bwd_forward_kernel<X><<<walk, THREADS, forward_smem(m), s>>>(
        q, k, v, dy, work, m);
    mlstm_bwd_steps_kernel<<<static_cast<unsigned>((steps + 255) / 256),
                             256, 0, s>>>(work, m);
    mlstm_bwd_reverse_kernel<X><<<walk, THREADS, reverse_smem(m), s>>>(
        q, k, v, dy, dcf, dnf, dv, work, m);
    mlstm_bwd_chunks_kernel<X><<<chunks, THREADS, chunks_smem(), s>>>(
        q, k, v, dy, dq, dk, work, m);
  }
  mlstm_bwd_chain_kernel<<<warps, 128, 0, s>>>(fg, dmf, di, df, work, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The float32 workspace `repro_mlstm_chunk_bwd` needs, in elements.
extern "C" long long repro_mlstm_chunk_bwd_workspace(int B, int L, int H,
                                                     int D) {
  return Work(Dims(B, L, H, D)).total;
}

// q, k, v, dy, dq, dk, dv (B, L, H, D) of one dtype (0 float32,
// 1 bfloat16); ig, fg, di, df (B, L, H) float32; dcf (B, H, D, D), dnf
// (B, H, D), dmf (B, H) float32, each may be null (a zero cotangent);
// `work` float32 of repro_mlstm_chunk_bwd_workspace elements; all
// contiguous, on one device; L >= 1, 1 <= D <= 512. `stream` is a
// cudaStream_t. Returns a cudaError_t (0 on success).
extern "C" int repro_mlstm_chunk_bwd(const void* q, const void* k,
                                     const void* v, const void* ig,
                                     const void* fg, const void* dy,
                                     const void* dcf, const void* dnf,
                                     const void* dmf, void* dq, void* dk,
                                     void* dv, void* di, void* df, void* work,
                                     int dtype, int B, int L, int H, int D,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* igf = static_cast<const float*>(ig);
  const float* fgf = static_cast<const float*>(fg);
  const float* dc = static_cast<const float*>(dcf);
  const float* dn = static_cast<const float*>(dnf);
  const float* dm = static_cast<const float*>(dmf);
  float* dif = static_cast<float*>(di);
  float* dff = static_cast<float*>(df);
  float* wk = static_cast<float*>(work);
  if (dtype == 1)
    return launch<bf16>(static_cast<const bf16*>(q),
                        static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), igf, fgf,
                        static_cast<const bf16*>(dy), dc, dn, dm,
                        static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                        static_cast<bf16*>(dv), dif, dff, wk, B, L, H, D, s);
  return launch<float>(static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v), igf, fgf,
                       static_cast<const float*>(dy), dc, dn, dm,
                       static_cast<float*>(dq), static_cast<float*>(dk),
                       static_cast<float*>(dv), dif, dff, wk, B, L, H, D, s);
}

