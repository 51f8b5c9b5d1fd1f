// The Hopper (sm_90a) building blocks of the bf16 flash attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): mbarriers, TMA tile loads
// and stores through a tensor map, the generic-to-async proxy fence,
// wgmma shared-memory descriptors and instructions, setmaxnreg, named
// barriers; and on the host the encoding of a tensor map, with
// cuTensorMapEncodeTiled looked up at run time through the CUDA runtime's
// entry-point query (the libraries do not link libcuda).
//
// Shared-memory tiles are written by TMA with 128-byte swizzle: a tile of
// R rows by 64 bf16 columns (one TMA box) is R rows of 128 bytes, 16-byte
// chunk c of row r stored at chunk c ^ (r % 8), each box 1024-byte
// aligned. A tile wider than 64 columns is DP / 64 such boxes one after
// another. wgmma reads such a tile:
//   * K-major (the reduction dimension along a row: A and B of Q . K^T):
//     rows 8 at a time 1024 bytes apart (SBO), a k-step of 16 columns 32
//     bytes further along the row, the next box for columns 64 on;
//   * MN-major (B of P . V: rows are the reduction dimension, keys, and
//     the 64 columns of a box the output dimension): 8 rows of the
//     reduction 1024 bytes apart (SBO), each further 64 output columns
//     one box further (LBO), a k-step of 16 rows 2048 bytes further.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA traffic on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the barrier's phase with this parity has completed (the
// phase bit differs from `parity`)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA and proxies
// ---------------------------------------------------------------------------

// one box of a 4-D tensor map into shared memory; completion (the box's
// bytes, out-of-bounds elements zero-filled) is reported to `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box of shared memory to a 4-D tensor map; elements out of bounds
// are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the issuing thread's TMA stores have read their shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's generic-proxy shared-memory writes become visible to the
// async proxy (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of `threads` threads (a multiple of 32) on hardware barrier
// `id` (1-15; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// an arrival on it that does not wait
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Ping-pong of two consumer warpgroups (hardware barriers PING and
// PING + 1): each issues its first products of a tile only on its turn
// and then hands the turn over, so the tensor cores take the two
// warpgroups' products one after the other and one warpgroup's
// elementwise work runs under the other's products instead of both
// waiting together. Warpgroup 1 hands warpgroup 0 the first turn, and
// warpgroup 0 takes the last hand-over after its loop.
constexpr int PING = 3;
__device__ __forceinline__ void ping_start(int wg) {
  if (wg == 1) named_arrive(PING, 256);
}
__device__ __forceinline__ void ping_wait(int wg) {
  named_sync(PING + wg, 256);
}
__device__ __forceinline__ void ping_pass(int wg) {
  named_arrive(PING + (wg ^ 1), 256);
}
__device__ __forceinline__ void ping_end(int wg) {
  if (wg == 0) named_sync(PING, 256);
}

// Rows [row0, row0 + ROWS) of one head's (L, D) bf16 slab `src` into a
// tile of DP / 64 swizzled boxes at `dst`, as a TMA load of the (D, L, H,
// B) map writes them: zeros past L and past D. The path for rows a tensor
// map cannot take (D % 8 != 0, a base that is not 16-byte aligned): one
// warp's plain loads and stores, fenced for the async proxy; the caller
// syncs the warp and arrives on the tile's barrier.
template <int DP, int ROWS>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int row0, int L, int D,
                                           int lane) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = lane; e < ROWS * DP; e += 32) {
    const int r = e / DP, c = e - r * DP, cc = c & 63;
    dst[(c >> 6) * ROWS * 64 + r * 64 + ((((cc >> 3) ^ (r & 7)) << 3) |
                                         (cc & 7))] =
        row0 + r < L && c < D
            ? src[static_cast<long long>(row0 + r) * D + c]
            : zero;
  }
  fence_proxy_async();
}

// tanh(x) = 1 - 2 / (2^(2 x log2 e) + 1) on the special-function unit (ex2
// and a fast reciprocal, ~1e-7 absolute error; +-1 past |x| ~ 44), for the
// softcap, in place of tanhf's longer instruction sequence
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, exp2_approx(x * 2.8853900817779268f) + 1.f);
}

// The thread's warp index as a value ptxas knows to be the same across the
// warp (a shuffle from lane 0, as CUTLASS does). Branches on values derived
// from threadIdx.x alone look divergent to ptxas, and a wgmma under one is
// serialized: ptxas waits after each (C7518, "compiler-inserted WG.DP in
// divergent path").
__device__ __forceinline__ int warp_uniform() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
}

// tanh(x) in one special-function instruction (tanh.approx, relative
// error ~2^-11): for the serving forward's softcap, where the logits only
// feed a bf16 output; the training forward keeps tanh_fast, whose
// log-sum-exp the backward reads back
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// registers
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a 128-byte-swizzled shared-memory operand at `p` (1024-byte
// aligned atoms), strides in bytes
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for A fragments in registers, which the wgmma reads after it
// was issued: they stay put until the fence after its wait
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The accumulator of m64nNk16 (float32): thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 (+ 8) and, per 8 columns j, columns
// 8 j + 2 (t % 4) (+ 1): d[4 j + e] is row + 8 (e >> 1), column + (e & 1),
// the C layout of mma.sync's m16n8 tiles, warp by warp. Its A registers
// for 16-bit types follow the same rows: a k-step's 16 columns are two of
// those 8-column groups, so the accumulator of one product, rounded to
// bf16 in pairs, is the A operand of the next as it stands.
#define WGMMA_D8(d, i)                                                 \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGMMA_D32(d) \
  WGMMA_D8(d, 0), WGMMA_D8(d, 8), WGMMA_D8(d, 16), WGMMA_D8(d, 24)
#define WGMMA_D40(d) WGMMA_D32(d), WGMMA_D8(d, 32)
#define WGMMA_D64(d) WGMMA_D32(d), WGMMA_D8(d, 32), WGMMA_D8(d, 40), \
                     WGMMA_D8(d, 48), WGMMA_D8(d, 56)
#define WGMMA_D128(d)                                                   \
  WGMMA_D64(d), WGMMA_D8(d, 64), WGMMA_D8(d, 72), WGMMA_D8(d, 80),     \
      WGMMA_D8(d, 88), WGMMA_D8(d, 96), WGMMA_D8(d, 104),              \
      WGMMA_D8(d, 112), WGMMA_D8(d, 120)

// bf16 inputs, float32 accumulators, one k-step of 16; `acc` 0 overwrites
// d, else adds to it
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d (64 x 32) (+)= A . B^T, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : WGMMA_D8(d, 0), WGMMA_D8(d, 8)
        : "l"(a), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  // d (64 x 64) (+)= A . B^T, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WGMMA_D32(d)
        : "l"(a), "l"(b), "r"(acc));
  }
  // d (64 x 64) (+)= A . B, A (64 x 16) in registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WGMMA_D32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<80> {
  // d (64 x 80) (+)= A . B, A (64 x 16) in registers, B MN-major in
  // shared memory (the output columns of a head dimension of 80)
  static __device__ __forceinline__ void rs(float (&d)[40],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : WGMMA_D40(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  // d (64 x 128) (+)= A . B^T, A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WGMMA_D64(d)
        : "l"(a), "l"(b), "r"(acc));
  }
  // d (64 x 128) (+)= A . B, A (64 x 16) in registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WGMMA_D64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Wgmma<256> {
  // d (64 x 256) (+)= A . B, A (64 x 16) in registers, B MN-major in
  // shared memory
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : WGMMA_D128(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

#undef WGMMA_D128
#undef WGMMA_D64
#undef WGMMA_D40
#undef WGMMA_D32
#undef WGMMA_D8

}  // namespace

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A contiguous bf16 tensor (B, H, L, D) as a 4-D tensor map, dimensions
// innermost first (D, L, H, B), boxes of 64 columns by `rows` rows of one
// head, 128-byte swizzle; elements outside the tensor read as zeros (a box
// past L does not reach the next head's rows). Needs D % 8 == 0 and a
// 16-byte aligned base. Returns 0 on success.
inline int make_map(CUtensorMap* map, const void* base, int B, int H, int L,
                    int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t strides[3] = {row, row * L, row * L * H};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// the current device's streaming multiprocessors
inline int multiprocessors() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// whether a tensor's rows can go through a tensor map (TMA's 16-byte rule
// for the base and the row stride)
inline bool tma_ok(const void* p, int D) {
  return D % 8 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
