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
// the float32 CUDA cores), so on the CUDA cores it is bound by
// operations. The Pallas kernel keeps one head's D x D memory in VMEM; at
// D = 512 that is 1 MiB of float32, 4.6x the 227 KB of shared memory one
// block may use. What the design does:
//   * C's value columns are split over blocks: a block owns 64 columns of
//     one (batch row, head), a 512 x 64 float32 slice (128 KB) that stays
//     in shared memory for the whole sequence, and walks the chunks in
//     order itself (the Pallas grid's sequential chunk axis). The grid is
//     (D / 64, H, B): 128 blocks at xlstm's shape, one wave on 132 SMs.
//   * what does not depend on v is computed by every block of a head
//     alone: the gates' scans (one warp, shuffles), the T x T weighted
//     q.k^T and the n vector. The denominator then needs no other block:
//     q_t . n_t = sum_u S_tu + exp(m_in - cm_t) q_t . n_in. A block writes
//     only its 64 columns of y and C; the first block of a head writes n
//     and m.
//   * q and k stream through shared memory in slabs of 64 of D. One pass
//     over the slabs accumulates q.k^T and q.C_in (rows of the slab, read
//     before the chunk's update of those rows), then updates those rows of
//     C and n. Each thread holds a 4 x 4 tile of q.k^T and one of q.C in
//     registers; every shared-memory read is a float4 feeding 16 FMAs.
//   * bf16 is converted on load, every sum is float32 on the CUDA cores,
//     y is rounded once on store. No tensor cores yet.
//   * any B, L and H: the last chunk may be ragged (masked steps get a
//     zero k, q and v and a gate of -inf, which leaves the scans as they
//     were); D <= 512, not a multiple of 64 needed.
//
// Plain C entry point, loaded with ctypes. It returns cudaGetLastError()
// after the launch, so a refused launch is reported to the caller.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TC = 64;        // chunk length
constexpr int EC = 64;        // value columns of C per block
constexpr int DS = 64;        // rows of D per slab of q and k
constexpr int LDT = DS + 4;   // padded row of the transposed slabs
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 tile
constexpr float NEG_INF_M = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
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

size_t smem_bytes(int d) {
  const size_t dp = padded_dim(d);
  return sizeof(float) *
         (dp * EC + 2 * DS * LDT + TC * DS + TC * EC + dp + 7 * TC + 4);
}

// q, k, v, y (B, L, H, D); ig, fg (B, L, H) f32; cout (B, H, D, D),
// nout (B, H, D), mout (B, H) f32. Block (column block, head, batch row);
// thread (ty, tx) owns rows 4ty..4ty+3 and columns 4tx..4tx+3 of each
// 64 x 64 tile.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const float* __restrict__ ig,
                       const float* __restrict__ fg, T* __restrict__ y,
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

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
      // the gates' scans: lane l takes steps 2l and 2l + 1
      const int ta = 2 * lane, tb = ta + 1;
      const bool ina = ta < tn, inb = tb < tn;
      const long long pa = gbase + static_cast<long long>(t0 + ta) * H;
      const long long pb = pa + H;
      const float la = ina ? log_sigmoid(fg[pa]) : 0.f;
      const float lb = inb ? log_sigmoid(fg[pb]) : 0.f;
      float s = la + lb;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, s, off);
        if (lane >= off) s += o;
      }
      float excl = __shfl_up_sync(FULL, s, 1);
      if (lane == 0) excl = 0.f;
      const float ba = excl + la, bb = s;
      const float ga = ina ? ig[pa] - ba : -INFINITY;
      const float gb = inb ? ig[pb] - bb : -INFINITY;
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
    } else {
      for (int i = tid - 32; i < TC * EC; i += THREADS - 32) {
        const int u = i / EC, e = i % EC;
        vs[i] = u < tn && e0 + e < D
                    ? to_f32(v[xbase + static_cast<long long>(t0 + u) * hd +
                               e0 + e])
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
        const float qv = in ? to_f32(q[g]) : 0.f;
        const float kv = in ? to_f32(k[g]) * scale : 0.f;
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
      T* yr = y + xbase + static_cast<long long>(t0 + t) * hd + e0 + 4 * tx;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e0 + 4 * tx + j < D)
          yr[j] = from_f32<T>((acc[i][j] + inter * qc[i][j]) / den);
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

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ig,
           const void* fg, void* y, void* cout, void* nout, void* mout, int B,
           int L, int H, int D, cudaStream_t stream) {
  const dim3 grid((D + EC - 1) / EC, H, B);
  const size_t smem = smem_bytes(D);
  const cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_chunk_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ig),
      static_cast<const float*>(fg), static_cast<T*>(y),
      static_cast<float*>(cout), static_cast<float*>(nout),
      static_cast<float*>(mout), L, H, D,
      static_cast<float>(1.0 / sqrt(static_cast<double>(D))));
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
    return launch<__nv_bfloat16>(q, k, v, ig, fg, y, cout, nout, mout, B, L,
                                 H, D, s);
  return launch<float>(q, k, v, ig, fg, y, cout, nout, mout, B, L, H, D, s);
}
