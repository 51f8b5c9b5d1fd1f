// Chunkwise mLSTM (xLSTM matrix memory, arXiv:2405.04517), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_mlstm_kernel`, launched by `mlstm_chunk`
// in src/repro/kernels/mlstm_chunk.py. Same function, the same chunkwise
// re-association: per batch row and head, from C = 0, n = 0, m = -1e30,
// for each chunk of T = 64 steps
//   b_t = cumsum(logsigmoid f),  g_t = i_t - b_t,
//   cm_t = max(m_in, cummax g),  m_t = b_t + cm_t,
//   S_tu = (q_t . k_u / sqrt(D)) exp(g_u - cm_t) [u <= t],
//   y_t = (sum_u S_tu v_u + exp(m_in - cm_t) q_t C_in)
//         / max(|sum_u S_tu + exp(m_in - cm_t) q_t . n_in|, exp(-m_t)),
// then C <- exp(m_in - cm_T) C + sum_u (k_u w_u)^T v_u with
// w_u = exp(g_u - cm_T) / sqrt(D), and n likewise. y is returned in q's
// dtype, C (D, D), n (D) and m in float32.
//
// What bounds it on an H100: at xlstm-350m's prefill shape (B 4, L 512,
// H 4, D 512, q/k/v bf16) one call moves ~50 MB (a 15 us byte bound) and
// its products are ~10 GFLOP (10 us on the bf16 tensor cores, 150 us on
// the float32 CUDA cores). The Pallas kernel keeps one head's D x D memory
// in VMEM; at D = 512 that is 1 MiB of float32, 4.6x the 227 KB of shared
// memory one block may use. So in both kernels C's value columns are split
// over blocks: a block owns 64 columns of one (batch row, head), a 512 x 64
// slice that stays in shared memory for the whole sequence, and walks the
// chunks in order itself (the Pallas grid's sequential chunk axis); the
// grid is (D / 64, H, B), 128 blocks of 8 warps at xlstm's shape. What
// does not depend on v (the gates' scans, the T x T q.k^T, the n vector)
// is computed by every block of a head alone, so the denominator needs no
// other block: q_t . n_t = sum_u S_tu + exp(m_in - cm_t) q_t . n_in. A
// block writes only its 64 columns of y and C; the first block of a head
// writes n and m. q and k stream through shared memory in slabs of 64 of
// D: one pass over the slabs accumulates q.k^T and q.C_in (rows of the
// slab, read before the chunk's update of those rows), then updates those
// rows of C and n. The last chunk may be ragged (masked steps get a zero
// q, k and v and a gate of -inf, which leaves the scans as they were); any
// B, L, H and D <= 512.
//
// bf16 (`mlstm_bf16_kernel`, serving): every product on the tensor cores,
// `mma.sync.m16n8k16` (bf16 in, f32 sums): q.k^T from q and k as given
// (exact products; 1/sqrt(D) applied to the f32 result), q.C_in, S.v, the
// C update (k w_out / sqrt(D))^T v, and n's terms as products too: q.n_in
// with n_in as a one-column B operand, n's update as the row sums of the
// update's A operand (a B operand of ones). S, n_in and k w_out are
// float32 values; each goes to the tensor cores as two bf16 operands,
// hi = bf16(v) and lo = bf16(v - hi), in two products, which keeps ~16
// bits. C itself is carried in shared memory as such a hi/lo pair (~16
// bits, re-split after each update in float32), so both parts are B
// operands of q.C_in as they stand. Rounded to bf16 once, S misses y's bar
// of 2e-2 and k w_out or C misses C's 5e-4 / 5e-3 (tests/test_torch_mlstm.py
// models this arithmetic against a float64 oracle). The gates' scans, n
// and m themselves, the row sums of S and the denominators stay float32.
//   * warp w = (i, j) = (w & 3, w >> 2) takes steps 16i .. 16i+15: q.k^T
//     for keys 32j .. 32j+31 (tiles right of the diagonal skipped), q.C_in
//     and y for columns 32j .. 32j+31; in the C update it takes rows
//     16i .. 16i+15 of the slab and the same columns. Every warp's tiles
//     of q.k^T and q.C_in stay in accumulator registers across the slabs;
//   * q and k slabs are double-buffered: the next slab's (or the next
//     chunk's first) 16-byte cp.async copies are in flight while this one
//     computes, and v and the gates are fetched a chunk ahead; rows are
//     padded by 16 bytes, so the 8 rows an ldmatrix reads fall in distinct
//     bank quads and a warp's read-modify-writes of C hit distinct banks;
//   * per slab, k w_out is split once into hi/lo tiles, which S's hi/lo
//     tiles take over after the last slab (the q.k^T tiles of a row of
//     steps lie in two warps, so S.v reads S from shared memory).
//
// float32 (`mlstm_f32_kernel`): the CUDA-core kernel, every sum float32,
// C in shared memory as float32. Each thread holds a 4 x 4 tile of q.k^T
// and one of q.C in registers; every shared-memory read is a float4 feeding
// 16 FMAs.
//
// Plain C entry point, loaded with ctypes. It returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TC = 64;        // chunk length
constexpr int EC = 64;        // value columns of C per block
constexpr int DS = 64;        // rows of D per slab of q and k
constexpr int LDT = DS + 4;   // padded row of the transposed slabs
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 tile
constexpr float NEG_INF_M = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// The gates of one chunk for the calling warp's lane l: steps 2l and
// 2l + 1 of `tn` live ones (pointers at the chunk's first step, `H`
// apart); 0 past the end.
__device__ __forceinline__ void load_gates(const float* __restrict__ ig,
                                           const float* __restrict__ fg,
                                           long long g0, int H, int tn,
                                           float (&gate)[4]) {
  const int ta = 2 * (threadIdx.x & 31);
  const long long pa = g0 + static_cast<long long>(ta) * H;
  gate[0] = ta < tn ? ig[pa] : 0.f;
  gate[1] = ta + 1 < tn ? ig[pa + H] : 0.f;
  gate[2] = ta < tn ? fg[pa] : 0.f;
  gate[3] = ta + 1 < tn ? fg[pa + H] : 0.f;
}

// The gates' scans of one chunk, run by one warp from `load_gates`'
// values: lane l takes steps 2l and 2l + 1 of `tn` live ones. Writes g,
// cm, exp(m_in - cm), exp(-m), w_out for the 64 steps and
// exp(m_in - cm_T) to scal[0]; advances the carried stabiliser m_run
// (kept in registers by the calling warp).
__device__ __forceinline__ void scan_gates(
    const float (&gate)[4], int tn, float& m_run, float* gs, float* cms,
    float* inters, float* emins, float* wouts, float* scal) {
  const int lane = threadIdx.x & 31;
  const int ta = 2 * lane, tb = ta + 1;
  const bool ina = ta < tn, inb = tb < tn;
  const float la = ina ? log_sigmoid(gate[2]) : 0.f;
  const float lb = inb ? log_sigmoid(gate[3]) : 0.f;
  float s = la + lb;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, s, off);
    if (lane >= off) s += o;
  }
  float excl = __shfl_up_sync(FULL, s, 1);
  if (lane == 0) excl = 0.f;
  const float ba = excl + la, bb = s;
  const float ga = ina ? gate[0] - ba : -INFINITY;
  const float gb = inb ? gate[1] - bb : -INFINITY;
  float mx = fmaxf(ga, gb);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(FULL, mx, off);
    if (lane >= off) mx = fmaxf(mx, o);
  }
  float prev = __shfl_up_sync(FULL, mx, 1);
  if (lane == 0) prev = -INFINITY;
  const float cma = fmaxf(m_run, fmaxf(prev, ga));
  const float cmb = fmaxf(m_run, mx);
  const float b_last = __shfl_sync(FULL, bb, 31);
  const float cm_last = __shfl_sync(FULL, cmb, 31);
  gs[ta] = ga;
  gs[tb] = gb;
  cms[ta] = cma;
  cms[tb] = cmb;
  inters[ta] = expf(m_run - cma);
  inters[tb] = expf(m_run - cmb);
  emins[ta] = expf(-(ba + cma));
  emins[tb] = expf(-(bb + cmb));
  wouts[ta] = expf(ga - cm_last);
  wouts[tb] = expf(gb - cm_last);
  if (lane == 0) scal[0] = expf(m_run - cm_last);
  m_run = b_last + cm_last;
}

__device__ __forceinline__ void unpack(const float4 v, float (&o)[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__host__ __device__ constexpr int padded_dim(int d) {
  return (d + DS - 1) / DS * DS;
}

size_t f32_smem_bytes(int d) {
  const size_t dp = padded_dim(d);
  return sizeof(float) *
         (dp * EC + 2 * DS * LDT + TC * DS + TC * EC + dp + 7 * TC + 4);
}

// q, k, v, y (B, L, H, D); ig, fg (B, L, H) f32; cout (B, H, D, D),
// nout (B, H, D), mout (B, H) f32. Block (column block, head, batch row);
// thread (ty, tx) owns rows 4ty..4ty+3 and columns 4tx..4tx+3 of each
// 64 x 64 tile.
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ ig,
                     const float* __restrict__ fg, float* __restrict__ y,
                     float* __restrict__ cout, float* __restrict__ nout,
                     float* __restrict__ mout, int L, int H, int D,
                     float scale) {
  extern __shared__ float4 smem4[];
  const int dpad = padded_dim(D);
  float* cs = reinterpret_cast<float*>(smem4);  // dpad x EC: C's columns
  float* qs = cs + dpad * EC;    // DS x LDT: q slab, [d][t]; then S^T [u][t]
  float* ks = qs + DS * LDT;     // DS x LDT: k slab / sqrt(D), [d][u]
  float* kws = ks + DS * LDT;    // TC x DS: k w_out / sqrt(D), [u][d]
  float* vs = kws + TC * DS;     // TC x EC: v's columns, [u][e]
  float* ns = vs + TC * EC;      // dpad: n
  float* gs = ns + dpad;         // TC each: g, cm, exp(m_in - cm),
  float* cms = gs + TC;          // exp(-m), w_out, row sums of S, q.n_in
  float* inters = cms + TC;
  float* emins = inters + TC;
  float* wouts = emins + TC;
  float* rss = wouts + TC;
  float* qns = rss + TC;
  float* scal = qns + TC;        // [0]: exp(m_in - cm_T)

  const int tid = threadIdx.x, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int e0 = blockIdx.x * EC;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long hd = static_cast<long long>(H) * D;
  const long long xbase = static_cast<long long>(b) * L * hd +
                          static_cast<long long>(h) * D;
  const long long gbase = static_cast<long long>(b) * L * H + h;

  for (int i = tid; i < dpad * EC; i += THREADS) cs[i] = 0.f;
  for (int i = tid; i < dpad; i += THREADS) ns[i] = 0.f;
  float m_run = NEG_INF_M;  // the carried stabiliser, kept by warp 0

  for (int t0 = 0; t0 < L; t0 += TC) {
    const int tn = min(TC, L - t0);
    __syncthreads();  // the last chunk's readers are done
    if (warp == 0) {
      float gate[4];
      load_gates(ig, fg, gbase + static_cast<long long>(t0) * H, H, tn, gate);
      scan_gates(gate, tn, m_run, gs, cms, inters, emins, wouts, scal);
    } else {
      for (int i = tid - 32; i < TC * EC; i += THREADS - 32) {
        const int u = i / EC, e = i % EC;
        vs[i] = u < tn && e0 + e < D
                    ? v[xbase + static_cast<long long>(t0 + u) * hd + e0 + e]
                    : 0.f;
      }
    }

    float qk[4][4], qc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qk[i][j] = qc[i][j] = 0.f;
    float qn = 0.f;  // q_t . n_in, over this thread's quarter of each slab

    for (int ds = 0; ds < dpad; ds += DS) {
      __syncthreads();  // gates and v staged; the last slab's readers done
#pragma unroll
      for (int r = 0; r < TC * DS / THREADS; ++r) {
        const int i = tid + r * THREADS;
        const int t = i / DS, dd = i % DS;
        const bool in = t < tn && ds + dd < D;
        const long long g =
            xbase + static_cast<long long>(t0 + t) * hd + ds + dd;
        const float qv = in ? q[g] : 0.f;
        const float kv = in ? k[g] * scale : 0.f;
        qs[dd * LDT + t] = qv;
        ks[dd * LDT + t] = kv;
        kws[t * DS + dd] = kv * wouts[t];
      }
      __syncthreads();

      // q.k^T and q.C_in over the slab's rows, before their update
#pragma unroll 8
      for (int dd = 0; dd < DS; ++dd) {
        float a[4], kk[4], cc[4];
        unpack(*reinterpret_cast<const float4*>(qs + dd * LDT + 4 * ty), a);
        unpack(*reinterpret_cast<const float4*>(ks + dd * LDT + 4 * tx), kk);
        unpack(*reinterpret_cast<const float4*>(cs + (ds + dd) * EC + 4 * tx),
               cc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qk[i][j] = fmaf(a[i], kk[j], qk[i][j]);
            qc[i][j] = fmaf(a[i], cc[j], qc[i][j]);
          }
      }
      {
        const int t = tid >> 2, part = tid & 3;
#pragma unroll
        for (int j = 0; j < DS / 4; ++j) {
          const int dd = part * (DS / 4) + j;
          qn = fmaf(qs[dd * LDT + t], ns[ds + dd], qn);
        }
      }
      __syncthreads();

      // the chunk's update of the slab's rows of C and n
      const float carry = scal[0];
      {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int u = 0; u < tn; ++u) {
          float kw[4], vv[4];
          unpack(*reinterpret_cast<const float4*>(kws + u * DS + 4 * ty), kw);
          unpack(*reinterpret_cast<const float4*>(vs + u * EC + 4 * tx), vv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(kw[i], vv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float4* row =
              reinterpret_cast<float4*>(cs + (ds + 4 * ty + i) * EC + 4 * tx);
          float4 c = *row;
          c.x = fmaf(carry, c.x, acc[i][0]);
          c.y = fmaf(carry, c.y, acc[i][1]);
          c.z = fmaf(carry, c.z, acc[i][2]);
          c.w = fmaf(carry, c.w, acc[i][3]);
          *row = c;
        }
      }
      {
        const int dd = tid >> 2, part = tid & 3;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < TC / 4; ++j)
          s += kws[(part * (TC / 4) + j) * DS + dd];
        s += __shfl_xor_sync(FULL, s, 1);
        s += __shfl_xor_sync(FULL, s, 2);
        if (part == 0) ns[ds + dd] = fmaf(carry, ns[ds + dd], s);
      }
    }

    // S = q.k^T exp(g_u - cm_t) [u <= t], stored transposed over the q
    // slab (no reader of qs is left: the update above reads kws, vs, cs)
    float rs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      const float cm_t = cms[t];
      rs[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = 4 * tx + j;
        qk[i][j] = u <= t ? qk[i][j] * expf(gs[u] - cm_t) : 0.f;
        rs[i] += qk[i][j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(qs + (4 * tx + j) * LDT + 4 * ty) =
          make_float4(qk[0][j], qk[1][j], qk[2][j], qk[3][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs[i] += __shfl_xor_sync(FULL, rs[i], off);  // the 16 lanes of ty
    }
    if (tx == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) rss[4 * ty + i] = rs[i];
    qn += __shfl_xor_sync(FULL, qn, 1);
    qn += __shfl_xor_sync(FULL, qn, 2);
    if ((tid & 3) == 0) qns[tid >> 2] = qn;
    __syncthreads();

    // y = (S v + exp(m_in - cm_t) q.C_in) / den
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int u = 0; u < tn; ++u) {
      float sv[4], vv[4];
      unpack(*reinterpret_cast<const float4*>(qs + u * LDT + 4 * ty), sv);
      unpack(*reinterpret_cast<const float4*>(vs + u * EC + 4 * tx), vv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv[i], vv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = 4 * ty + i;
      if (t >= tn) continue;
      const float inter = inters[t];
      const float den = fmaxf(fabsf(rss[t] + inter * qns[t]), emins[t]);
      float* yr = y + xbase + static_cast<long long>(t0 + t) * hd + e0 + 4 * tx;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + 4 * tx + j < D)
          yr[j] = (acc[i][j] + inter * qc[i][j]) / den;
    }
  }

  __syncthreads();
  const long long bh = static_cast<long long>(b) * H + h;
  for (int i = tid; i < D * EC; i += THREADS) {
    const int d = i / EC, e = i % EC;
    if (e0 + e < D) cout[(bh * D + d) * D + e0 + e] = cs[i];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < D; d += THREADS) nout[bh * D + d] = ns[d];
    if (tid == 0) mout[bh] = m_run;
  }
}


int launch_f32(const void* q, const void* k, const void* v, const void* ig,
               const void* fg, void* y, void* cout, void* nout, void* mout,
               int B, int L, int H, int D, cudaStream_t stream) {
  const dim3 grid((D + EC - 1) / EC, H, B);
  const size_t smem = f32_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      mlstm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_f32_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<float*>(y),
      static_cast<float*>(cout), static_cast<float*>(nout),
      static_cast<float*>(mout), L, H, D,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int PAD = 8;            // bf16 of padding per staged row
constexpr int LDK = DS + PAD;     // row stride of the bf16 tiles

// C's hi and lo parts (2 x dpad x LDK bf16); q and k, double-buffered, v
// double-buffered and S's hi and lo parts (8 tiles of 64 x LDK bf16); n
// and n_in (dpad floats each); g, cm, exp(m_in - cm), exp(-m), w_out,
// q.n_in (TC floats each), the row sums of S (2 TC) and exp(m_in - cm_T)
// (4 floats)
size_t bf16_smem_bytes(int d) {
  const size_t dp = padded_dim(d);
  return sizeof(bf16) * (2 * dp + 8 * TC) * LDK +
         sizeof(float) * (2 * dp + 8 * TC + 4);
}

// Stage step `ds` (a slab of 64 of D) of the chunk at `t0`: q and k's
// [t][d] tiles, rows t < tn and columns < D - ds live, the rest zero. With
// `vec` by 16-byte cp.async copies, else by plain loads and stores.
__device__ __forceinline__ void stage_qk(bf16* qs, bf16* ks,
                                        const bf16* __restrict__ q,
                                        const bf16* __restrict__ k,
                                        long long base, long long hd, int tn,
                                        int dn, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < TC * DS / 8 / THREADS; ++i) {
      const int slot = tid + i * THREADS;
      const int t = slot / (DS / 8), c = (slot % (DS / 8)) * 8;
      const bool in = t < tn && c < dn;
      const long long off = in ? base + t * hd + c : base;
      cp_async16(qs + t * LDK + c, q + off, in);
      cp_async16(ks + t * LDK + c, k + off, in);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < TC * DS; i += THREADS) {
      const int t = i / DS, c = i % DS;
      const bool in = t < tn && c < dn;
      qs[t * LDK + c] = in ? q[base + t * hd + c] : zero;
      ks[t * LDK + c] = in ? k[base + t * hd + c] : zero;
    }
  }
}

// v's [u][e] tile of the chunk at `base`: rows u < tn, columns < ec live.
__device__ __forceinline__ void stage_v(bf16* vs, const bf16* __restrict__ v,
                                       long long base, long long hd, int tn,
                                       int ec, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int i = 0; i < TC * EC / 8 / THREADS; ++i) {
      const int slot = tid + i * THREADS;
      const int u = slot / (EC / 8), c = (slot % (EC / 8)) * 8;
      const bool in = u < tn && c < ec;
      cp_async16(vs + u * LDK + c, v + (in ? base + u * hd + c : base), in);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < TC * EC; i += THREADS) {
      const int u = i / EC, c = i % EC;
      vs[u * LDK + c] = u < tn && c < ec ? v[base + u * hd + c] : zero;
    }
  }
}

// q, k, v, y (B, L, H, D) bf16; ig, fg (B, L, H) f32; cout (B, H, D, D),
// nout (B, H, D), mout (B, H) f32. Block (column block, head, batch row).
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ ig,
                      const float* __restrict__ fg, bf16* __restrict__ y,
                      float* __restrict__ cout, float* __restrict__ nout,
                      float* __restrict__ mout, int L, int H, int D,
                      float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dpad = padded_dim(D);
  bf16* chs = reinterpret_cast<bf16*>(smem_raw);  // [d][e] C's columns, hi
  bf16* cls = chs + dpad * LDK;                   // [d][e] lo
  bf16* qs = cls + dpad * LDK;    // 2 x [t][d]: q slab, double-buffered
  bf16* ks = qs + 2 * TC * LDK;   // 2 x [u][d]: k slab
  bf16* vs = ks + 2 * TC * LDK;   // 2 x [u][e]: v's columns, by chunk
  bf16* shs = vs + 2 * TC * LDK;  // [t][u] S hi
  bf16* sls = shs + TC * LDK;     // [t][u] S lo
  float* ns = reinterpret_cast<float*>(sls + TC * LDK);  // n
  float* nins = ns + dpad;        // n_in, read by q.n_in while n updates
  float* gs = nins + dpad;        // TC each: g, cm, exp(m_in - cm),
  float* cms = gs + TC;           // exp(-m), w_out, q.n_in
  float* inters = cms + TC;
  float* emins = inters + TC;
  float* wouts = emins + TC;
  float* qns = wouts + TC;
  float* rss = qns + TC;          // 2 x TC: row sums of S, per key half
  float* scal = rss + 2 * TC;     // [0]: exp(m_in - cm_T)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row, column pair
  const int wi = warp & 3, wj = warp >> 2;  // steps 16 wi.., columns 32 wj..
  const int e0 = blockIdx.x * EC;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long hd = static_cast<long long>(H) * D;
  const long long xbase = static_cast<long long>(b) * L * hd +
                          static_cast<long long>(h) * D;
  const long long gbase = static_cast<long long>(b) * L * H + h;
  const int ec = min(EC, D - e0);  // live columns of this block
  const int nslab = dpad / DS;
  const int nsteps = (L + TC - 1) / TC * nslab;

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

  const bf16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < 2 * dpad * LDK; i += THREADS) chs[i] = zero;
  for (int i = tid; i < dpad; i += THREADS) ns[i] = 0.f;
  float m_run = NEG_INF_M;  // the carried stabiliser, kept by warp 0
  float gate[4];            // warp 0: the next chunk's gates
  if (warp == 0) load_gates(ig, fg, gbase, H, min(TC, L), gate);
  stage_qk(qs, ks, q, k, xbase, hd, min(TC, L), min(DS, D), vec);
  stage_v(vs, v, xbase + e0, hd, min(TC, L), ec, vec);

  for (int t0 = 0, step = 0; t0 < L; t0 += TC) {
    const int tn = min(TC, L - t0);
    const int vbuf = (t0 / TC) & 1;
    __syncthreads();  // the last chunk's readers are done
    for (int i = tid; i < dpad; i += THREADS) nins[i] = ns[i];
    if (warp == 0) {
      scan_gates(gate, tn, m_run, gs, cms, inters, emins, wouts, scal);
      if (t0 + TC < L)
        load_gates(ig, fg, gbase + static_cast<long long>(t0 + TC) * H, H,
                   min(TC, L - t0 - TC), gate);
    }

    float qk[4][4], qc[4][4];  // q.k^T (keys 32 wj + 8 n ..), q.C_in
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) qk[n][e] = qc[n][e] = 0.f;
    float qn[4] = {0.f, 0.f, 0.f, 0.f};  // q.n_in in fragment column 0

    for (int ds = 0; ds < dpad; ds += DS, ++step) {
      const int buf = step & 1;
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();  // this step's slab has landed; the gates are
                        // scanned; the last step's readers are done
      // prefetch the next step's slab (the next chunk's first one after
      // the last) and, at a chunk's first slab, the next chunk's v
      if (step + 1 < nsteps) {
        const int nds = ds + DS < dpad ? ds + DS : 0;
        const int nt0 = ds + DS < dpad ? t0 : t0 + TC;
        stage_qk(qs + (buf ^ 1) * TC * LDK, ks + (buf ^ 1) * TC * LDK, q, k,
                 xbase + static_cast<long long>(nt0) * hd + nds, hd,
                 min(TC, L - nt0), min(DS, D - nds), vec);
      }
      if (ds == 0 && t0 + TC < L)
        stage_v(vs + (vbuf ^ 1) * TC * LDK, v,
                xbase + static_cast<long long>(t0 + TC) * hd + e0, hd,
                min(TC, L - t0 - TC), ec, vec);
      const bf16* qb = qs + buf * TC * LDK;
      const bf16* kb = ks + buf * TC * LDK;
      const bf16* vb = vs + vbuf * TC * LDK;

      // q's A operand for steps 16 wi .. 16 wi + 15
      uint32_t qf[DS / 16][4];
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk)
        ldmatrix_x4(qf[kk], smem_u32(qb + (wi * 16 + a_row) * LDK + kk * 16 +
                                     a_col));
      // q.k^T, key tiles 2 wj + np left of the diagonal
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        if (2 * wj + np > wi) continue;
#pragma unroll
        for (int kk = 0; kk < DS / 16; ++kk) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_u32(kb + (32 * wj + 16 * np + k_row) * LDK +
                                   kk * 16 + k_col));
          mma_bf16(qk[2 * np], qf[kk], bk[0], bk[1]);
          mma_bf16(qk[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
      // q.C_in from C's hi and lo parts, columns 32 wj .. 32 wj + 31
#pragma unroll
      for (int kk = 0; kk < DS / 16; ++kk)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bh[4], bl[4];
          const int off =
              (ds + kk * 16 + v_row) * LDK + 32 * wj + 16 * np + v_col;
          ldmatrix_x4_trans(bh, smem_u32(chs + off));
          ldmatrix_x4_trans(bl, smem_u32(cls + off));
          mma_bf16(qc[2 * np], qf[kk], bh[0], bh[1]);
          mma_bf16(qc[2 * np + 1], qf[kk], bh[2], bh[3]);
          mma_bf16(qc[2 * np], qf[kk], bl[0], bl[1]);
          mma_bf16(qc[2 * np + 1], qf[kk], bl[2], bl[3]);
        }
      // q.n_in, by the warps of key half 1 (which have the fewer q.k^T
      // tiles): n_in split, as column 0 of a B operand (the lanes of
      // fragment column g = 0; the rest zero)
      if (wj == 1) {
        float2 nk[DS / 16][2];
#pragma unroll
        for (int kk = 0; kk < DS / 16; ++kk) {
          const float* p = nins + ds + kk * 16 + 2 * t4;
          nk[kk][0] = make_float2(p[0], p[1]);
          nk[kk][1] = make_float2(p[8], p[9]);
        }
#pragma unroll
        for (int kk = 0; kk < DS / 16; ++kk) {
          uint32_t bh[2], bl[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            split_pair(nk[kk][r].x, nk[kk][r].y, bh[r], bl[r]);
            if (g != 0) bh[r] = bl[r] = 0u;
          }
          mma_bf16(qn, qf[kk], bh[0], bh[1]);
          mma_bf16(qn, qf[kk], bl[0], bl[1]);
        }
      }
      // k w_out / sqrt(D), split into hi and lo [u][d] tiles (over S's,
      // which are free until the slabs are done)
      uint4 kv[TC * DS / 8 / THREADS];
#pragma unroll
      for (int i = 0; i < TC * DS / 8 / THREADS; ++i) {
        const int slot = tid + i * THREADS;
        const int u = slot / (DS / 8), c = (slot % (DS / 8)) * 8;
        kv[i] = *reinterpret_cast<const uint4*>(kb + u * LDK + c);
      }
#pragma unroll
      for (int i = 0; i < TC * DS / 8 / THREADS; ++i) {
        const int slot = tid + i * THREADS;
        const int u = slot / (DS / 8), c = (slot % (DS / 8)) * 8;
        const __nv_bfloat162* k2 =
            reinterpret_cast<const __nv_bfloat162*>(&kv[i]);
        const float w = scale * wouts[u];
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 kf = __bfloat1622float2(k2[j]);
          split_pair(kf.x * w, kf.y * w, hi[j], lo[j]);
        }
        *reinterpret_cast<uint4*>(shs + u * LDK + c) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(sls + u * LDK + c) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      __syncthreads();  // every read of the slab's rows of C_in is done

      // the chunk's update of the slab's rows of C: rows 16 wi ..,
      // columns 32 wj .., C's new value split into its hi and lo parts;
      // the warps of column half 0 also update n, as the row sums of
      // (k w_out / sqrt(D))^T (a product with a B operand of ones)
      const float carry = scal[0];
      {
        constexpr uint32_t ONES = 0x3f803f80u;  // two bf16 1.0
        float acc[4][4], nacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < TC / 16; ++kk) {
          if (kk * 16 >= tn) break;  // zero rows of a ragged chunk
          uint32_t ah[4], al[4];
          const int aoff = (kk * 16 + at_row) * LDK + wi * 16 + at_col;
          ldmatrix_x4_trans(ah, smem_u32(shs + aoff));
          ldmatrix_x4_trans(al, smem_u32(sls + aoff));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, smem_u32(vb + (kk * 16 + v_row) * LDK +
                                           32 * wj + 16 * np + v_col));
            mma_bf16(acc[2 * np], ah, bv[0], bv[1]);
            mma_bf16(acc[2 * np + 1], ah, bv[2], bv[3]);
            mma_bf16(acc[2 * np], al, bv[0], bv[1]);
            mma_bf16(acc[2 * np + 1], al, bv[2], bv[3]);
          }
          if (wj == 0) {
            mma_bf16(nacc, ah, ONES, ONES);
            mma_bf16(nacc, al, ONES, ONES);
          }
        }
        // every load before any store, so they are all in flight at once
        __nv_bfloat162 ch[4][2], cl[4][2];
        const int off0 = (ds + wi * 16 + g) * LDK + 32 * wj + 2 * t4;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int off = off0 + 8 * r * LDK + 8 * n;
            ch[n][r] = *reinterpret_cast<const __nv_bfloat162*>(chs + off);
            cl[n][r] = *reinterpret_cast<const __nv_bfloat162*>(cls + off);
          }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int off = off0 + 8 * r * LDK + 8 * n;
            const float2 h2 = __bfloat1622float2(ch[n][r]);
            const float2 l2 = __bfloat1622float2(cl[n][r]);
            uint32_t hi, lo;
            split_pair(fmaf(carry, h2.x + l2.x, acc[n][2 * r]),
                       fmaf(carry, h2.y + l2.y, acc[n][2 * r + 1]), hi, lo);
            *reinterpret_cast<uint32_t*>(chs + off) = hi;
            *reinterpret_cast<uint32_t*>(cls + off) = lo;
          }
        if (wj == 0 && t4 == 0) {
          float* nr = ns + ds + wi * 16 + g;
          nr[0] = fmaf(carry, nr[0], nacc[0]);
          nr[8] = fmaf(carry, nr[8], nacc[2]);
        }
      }
    }
    __syncthreads();  // every reader of the k w_out tiles is done

    // S = q.k^T / sqrt(D) exp(g_u - cm_t) [u <= t]: float32 row sums, and
    // hi/lo tiles [t][u]
    const int t_a = wi * 16 + g, t_b = t_a + 8;  // this lane's two steps
    {
      const float cm_a = cms[t_a], cm_b = cms[t_b];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int u0 = 32 * wj + 8 * n + 2 * t4, u1 = u0 + 1;
        const float g0 = gs[u0], g1 = gs[u1];
        const float s00 = u0 <= t_a ? qk[n][0] * scale * expf(g0 - cm_a) : 0.f;
        const float s01 = u1 <= t_a ? qk[n][1] * scale * expf(g1 - cm_a) : 0.f;
        const float s10 = u0 <= t_b ? qk[n][2] * scale * expf(g0 - cm_b) : 0.f;
        const float s11 = u1 <= t_b ? qk[n][3] * scale * expf(g1 - cm_b) : 0.f;
        rs[0] += s00 + s01;
        rs[1] += s10 + s11;
        uint32_t hi, lo;
        split_pair(s00, s01, hi, lo);
        *reinterpret_cast<uint32_t*>(shs + t_a * LDK + u0) = hi;
        *reinterpret_cast<uint32_t*>(sls + t_a * LDK + u0) = lo;
        split_pair(s10, s11, hi, lo);
        *reinterpret_cast<uint32_t*>(shs + t_b * LDK + u0) = hi;
        *reinterpret_cast<uint32_t*>(sls + t_b * LDK + u0) = lo;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(FULL, rs[r], 1);
        rs[r] += __shfl_xor_sync(FULL, rs[r], 2);
      }
      if (t4 == 0) {
        rss[wj * TC + t_a] = rs[0];
        rss[wj * TC + t_b] = rs[1];
      }
    }
    if (wj == 1 && t4 == 0) {
      qns[t_a] = qn[0];
      qns[t_b] = qn[2];
    }
    __syncthreads();

    // y = (S v + exp(m_in - cm_t) q.C_in) / den, columns 32 wj ..
    const bf16* vb = vs + vbuf * TC * LDK;
    float sv[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TC / 16; ++kk) {
      if (kk > wi) continue;  // key tiles right of the diagonal
      uint32_t ah[4], al[4];
      const int aoff = (wi * 16 + a_row) * LDK + kk * 16 + a_col;
      ldmatrix_x4(ah, smem_u32(shs + aoff));
      ldmatrix_x4(al, smem_u32(sls + aoff));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_u32(vb + (kk * 16 + v_row) * LDK +
                                       32 * wj + 16 * np + v_col));
        mma_bf16(sv[2 * np], ah, bv[0], bv[1]);
        mma_bf16(sv[2 * np + 1], ah, bv[2], bv[3]);
        mma_bf16(sv[2 * np], al, bv[0], bv[1]);
        mma_bf16(sv[2 * np + 1], al, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r ? t_b : t_a;
      if (t >= tn) continue;
      const float inter = inters[t];
      const float den = fmaxf(
          fabsf(rss[t] + rss[TC + t] + inter * qns[t]), emins[t]);
      bf16* yr = y + xbase + static_cast<long long>(t0 + t) * hd + e0;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = 32 * wj + 8 * n + 2 * t4;
        const float y0 = (sv[n][2 * r] + inter * qc[n][2 * r]) / den;
        const float y1 = (sv[n][2 * r + 1] + inter * qc[n][2 * r + 1]) / den;
        if (vec) {
          if (c < ec)
            *reinterpret_cast<__nv_bfloat162*>(yr + c) =
                __floats2bfloat162_rn(y0, y1);
        } else {
          if (c < ec) yr[c] = __float2bfloat16(y0);
          if (c + 1 < ec) yr[c + 1] = __float2bfloat16(y1);
        }
      }
    }
  }

  __syncthreads();
  const long long bh = static_cast<long long>(b) * H + h;
  for (int i = tid; i < D * EC; i += THREADS) {
    const int d = i / EC, e = i % EC;
    if (e < ec)
      cout[(bh * D + d) * D + e0 + e] = __bfloat162float(chs[d * LDK + e]) +
                                        __bfloat162float(cls[d * LDK + e]);
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < D; d += THREADS) nout[bh * D + d] = ns[d];
    if (tid == 0) mout[bh] = m_run;
  }
}

int launch_bf16(const void* q, const void* k, const void* v, const void* ig,
                const void* fg, void* y, void* cout, void* nout, void* mout,
                int B, int L, int H, int D, cudaStream_t stream) {
  const size_t smem = bf16_smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      mlstm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = D % 8 == 0 && aligned(q) && aligned(k) && aligned(v) &&
                  aligned(y);
  const dim3 grid((D + EC - 1) / EC, H, B);
  mlstm_bf16_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<bf16*>(y),
      static_cast<float*>(cout), static_cast<float*>(nout),
      static_cast<float*>(mout), L, H, D,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, y (B, L, H, D) of one dtype (0 float32, 1 bfloat16); ig, fg
// (B, L, H), cout (B, H, D, D), nout (B, H, D), mout (B, H) float32; all
// contiguous, on one device; L >= 1, 1 <= D <= 512.
// `stream` is a cudaStream_t. Returns a cudaError_t (0 on success).
extern "C" int repro_mlstm_chunk(const void* q, const void* k, const void* v,
                                 const void* ig, const void* fg, void* y,
                                 void* cout, void* nout, void* mout, int dtype,
                                 int B, int L, int H, int D, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_bf16(q, k, v, ig, fg, y, cout, nout, mout, B, L, H, D, s);
  return launch_f32(q, k, v, ig, fg, y, cout, nout, mout, B, L, H, D, s);
}
