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
// products are ~2.5x the forward's ~40 GFLOP. This first kernel runs them
// on the CUDA cores in float32 (tensor cores are later work). The forward
// keeps one head's D x D memory in shared memory only as 64-column slices,
// one per block; so does the backward for the memory and its cotangent
// dC, and every product that sums over value columns (dnum v^T, C_in
// dnum, dC v) is split into per-block partials that a later kernel sums
// in a fixed order, never with atomics (two runs give the same bits). The
// states are recomputed, not stored by the forward. Six launches:
//   1. gates: one thread per (batch row, head) scans the gates: g, cm and
//      m per step, m_in per chunk;
//   2. forward: grid (D/64, H, B), the forward's walk over the chunks with
//      a 512 x 64 slice of C in shared memory; it writes C_in and n_in of
//      every chunk, q k~^T and qn (first block), and its columns' share of
//      dy . num;
//   3. steps: one thread per step: 1/den, dqn and the gradient of m
//      through den, from the summed shares;
//   4. reverse: grid (D/64, H, B), the chunks in reverse with a 512 x 64
//      slice of dC (and dn, first block) in shared memory: writes dv, the
//      dC and dn each chunk receives, and its columns' share of dnum v^T;
//   5. chunks: grid (D/64 rows, chunks, B x H), every chunk at once: dS,
//      then C_in dnum and dC v for 64 rows of D, dq and dk, and the
//      shares of the gates' sums (d inter, d wout, d carry, dS S);
//   6. gate chain: one thread per (batch row, head) walks the chunks in
//      reverse with the stabiliser's gradient and writes di and df.
// Every product is a 64 x 64 x 64 tile product from shared memory, each
// thread a 4 x 4 output tile fed by two float4 reads (every tile is
// stored with its contracted index as the row). q, k, v, dy are read in
// their dtype (float32 or bf16) and dq, dk, dv written in it; every sum
// is float32. A ragged last chunk stages zeros past L.
//
// Plain C entry points, loaded with ctypes. The launcher returns
// cudaGetLastError() after the launches, so a refused launch is reported
// to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// workspace (floats), each array [b][h][...]
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
    const long long steps = bh * m.L, chunks = bh * m.NC;
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

// 1. the gates' scans: one thread per (b, h)
__global__ void mlstm_bwd_gates_kernel(const float* __restrict__ ig,
                                       const float* __restrict__ fg,
                                       float* __restrict__ work, Dims m) {
  const Work w(m);
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= m.B * m.H) return;
  const int b = bh / m.H, h = bh % m.H;
  float m_in = NEG_INF_M;
  for (int c = 0; c < m.NC; ++c) {
    const int c0 = c * T, tn = min(T, m.L - c0);
    work[w.minw + static_cast<long long>(bh) * m.NC + c] = m_in;
    float bsum = 0.f, cmx = -INFINITY, mt = 0.f;
    for (int t = 0; t < tn; ++t) {
      const long long gi = (static_cast<long long>(b) * m.L + c0 + t) * m.H + h;
      bsum += log_sigmoid(fg[gi]);
      const float g = ig[gi] - bsum;
      cmx = fmaxf(cmx, g);
      const float cm = fmaxf(cmx, m_in);
      mt = bsum + cm;
      const long long si = static_cast<long long>(bh) * m.L + c0 + t;
      work[w.gw + si] = g;
      work[w.cmw + si] = cm;
      work[w.mw + si] = mt;
    }
    m_in = mt;
  }
}

// The chunk's gate record in shared memory: g and cm per step (g = -inf
// and inter = wout = 0 past the live steps), inter, wout; returns carry
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

// 6. the gate chain: one thread per (b, h), chunks in reverse
__global__ void mlstm_bwd_chain_kernel(const float* __restrict__ fg,
                                       const float* __restrict__ dmf,
                                       float* __restrict__ di,
                                       float* __restrict__ df,
                                       const float* __restrict__ work,
                                       Dims m) {
  const Work w(m);
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= m.B * m.H) return;
  const int b = bh / m.H, h = bh % m.H;
  float dm_out = dmf != nullptr ? dmf[bh] : 0.f;
  float dg[T], dcm[T], dmt[T];
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
    float dm_in = d_carry, sum_wout = 0.f;
    for (int t = 0; t < tn; ++t) {
      const float g = work[w.gw + s0 + t], cm = work[w.cmw + s0 + t];
      float dint = 0.f, dwo = 0.f;
      for (int db = 0; db < m.NE; ++db) {
        const long long pi = (static_cast<long long>(bh) * m.NE + db) * m.L +
                             c0 + t;
        dint += work[w.pdi + pi];
        dwo += work[w.pdw + pi];
      }
      const float d_inter = dint * expf(m_in - cm);
      const float d_wout = dwo * expf(g - cm_last);
      dg[t] = work[w.colw + s0 + t] + d_wout;
      dmt[t] = work[w.dmden + s0 + t] + (t == tn - 1 ? dm_out : 0.f);
      dcm[t] = dmt[t] - work[w.roww + s0 + t] - d_inter;
      dm_in += d_inter;
      sum_wout += d_wout;
    }
    dcm[tn - 1] -= sum_wout + d_carry;
    // cm = max(m_in, cummax g): to m_in or to the argmax (last on a tie)
    float cmx = -INFINITY;
    int arg = 0;
    for (int t = 0; t < tn; ++t) {
      const float g = work[w.gw + s0 + t];
      if (g >= cmx) {
        cmx = g;
        arg = t;
      }
      const float to_g = cmx > m_in ? 1.f : cmx < m_in ? 0.f : 0.5f;
      dg[arg] = fmaf(to_g, dcm[t], dg[arg]);
      dm_in = fmaf(1.f - to_g, dcm[t], dm_in);
    }
    float run = 0.f;
    for (int t = tn - 1; t >= 0; --t) {
      const long long gi = (static_cast<long long>(b) * m.L + c0 + t) * m.H + h;
      run += dmt[t] - dg[t];
      di[gi] = dg[t];
      df[gi] = run / (1.f + expf(fg[gi]));
    }
    dm_out = dm_in;
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

template <typename X>
int launch(const X* q, const X* k, const X* v, const float* ig,
           const float* fg, const X* dy, const float* dcf, const float* dnf,
           const float* dmf, X* dq, X* dk, X* dv, float* di, float* df,
           float* work, int B, int L, int H, int D, cudaStream_t s) {
  const Dims m(B, L, H, D);
  const int bh = B * H;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_forward_kernel<X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(forward_smem(m)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_bwd_reverse_kernel<X>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(reverse_smem(m)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_bwd_chunks_kernel<X>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(chunks_smem()));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_gates_kernel<<<(bh + 63) / 64, 64, 0, s>>>(ig, fg, work, m);
  mlstm_bwd_forward_kernel<X><<<dim3(m.NE, H, B), THREADS, forward_smem(m),
                                s>>>(q, k, v, dy, work, m);
  const long long steps = static_cast<long long>(bh) * L;
  mlstm_bwd_steps_kernel<<<static_cast<unsigned>((steps + 255) / 256), 256,
                           0, s>>>(work, m);
  mlstm_bwd_reverse_kernel<X><<<dim3(m.NE, H, B), THREADS, reverse_smem(m),
                                s>>>(q, k, v, dy, dcf, dnf, dv, work, m);
  mlstm_bwd_chunks_kernel<X><<<dim3(m.NE, m.NC, bh), THREADS, chunks_smem(),
                               s>>>(q, k, v, dy, dq, dk, work, m);
  mlstm_bwd_chain_kernel<<<(bh + 63) / 64, 64, 0, s>>>(fg, dmf, di, df, work,
                                                       m);
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
