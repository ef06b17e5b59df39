// Hopper-only (sm_90a) building blocks of csrc/flash_attention.cu,
// csrc/mrf.cu and csrc/dilated_conv.cu: mbarriers, TMA tile loads and stores
// through a tensor map (and the host's cuTensorMapEncodeTiled), plain bulk
// copies, the async-proxy fence, the wgmma shared-memory descriptor for
// 128-byte-swizzled and for unswizzled tiles, the asynchronous warpgroup
// products (bf16 in, fp32 accumulators in registers), ldmatrix, named
// barriers and setmaxnreg.
//
// Tile layout. A TMA box of R rows x 64 bf16 columns (128 bytes a row) loaded
// with CU_TENSOR_MAP_SWIZZLE_128B lands as R consecutive 128-byte lines whose
// 16-byte groups are XORed with (row % 8); the tile's base is 1024-byte
// aligned. wgmma reads that tile
//   - K-major (the reduction runs along the 64 columns: q and k in q k^T):
//     layout type 1, stride offset 1024 bytes between groups of 8 rows; a
//     step of 16 along the reduction adds 32 bytes to the start address;
//   - MN-major (the reduction runs along the rows: v in p v, "transposed"):
//     layout type 1, stride offset 1024 bytes between groups of 8 reduction
//     rows, leading offset = bytes from one 64-column tile to the next where
//     the product is wider than 64; a step of 16 along the reduction adds
//     16 * 128 bytes.
// An unswizzled ("interleaved", layout type 0) K-major tile is made of core
// matrices of 8 rows x 16 bytes (8 reduction values), each 128 contiguous
// bytes: stride offset = bytes between groups of 8 rows, leading offset =
// bytes between the two core matrices of a 16-deep step. Its start needs only
// 16-byte alignment, so a tile stored [K/8][rows][8] can start at any row.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase differs from `parity`. (No trap on a
// time-out here: ptxas then stops giving the consumers the registers that
// setmaxnreg asks for, and their wgmma are serialised.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
#ifdef FA_BOUNDED_WAIT
  for (int spin = 0; spin < (1 << 24); ++spin) {
#else
  for (;;) {
#endif
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// ---------------------------------------------------------------------------
// TMA: one box of a 3-d tensor map (features, rows, batch) into shared memory

__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// TMA store of one box of a 3-d tensor map from shared memory, as a bulk
// group of the issuing thread (the box's part outside the tensor is not
// written). The shared memory must be fenced (fence_proxy_async) after the
// threads' writes.
__device__ __forceinline__ void tma_store_3d(const void* map, const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar` like a TMA load.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the process has loaded; the
// libraries link none. Null when the driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// ---------------------------------------------------------------------------
// ldmatrix: four 8x8 bf16 matrices, lane l giving the address of row l % 8 of
// matrix l / 8; r[i] is this lane's part of matrix i (the mma/wgmma A layout
// when the matrices are rows 0-7 and 8-15 at columns 0-7, then at 8-15)

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same, each matrix transposed: r[i] holds row lane / 4, columns
// 2 * (lane % 4) and + 1 of matrix i's transpose.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// ---------------------------------------------------------------------------
// named barriers and register reallocation

template <int THREADS>
__device__ __forceinline__ void named_bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
}

template <int REGS>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ---------------------------------------------------------------------------
// wgmma

constexpr uint64_t WGMMA_NO_SWIZZLE = 0, WGMMA_SWIZZLE_128B = 1;

// Descriptor of a tile at a shared-memory address (128-byte swizzled unless
// told otherwise); offsets in bytes. Advance the start by adding (bytes >> 4)
// to the result.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t leading_bytes,
                                               uint32_t stride_bytes,
                                               uint64_t layout = WGMMA_SWIZZLE_128B) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(leading_bytes >> 4) << 16) |
         ((uint64_t)(stride_bytes >> 4) << 32) | (layout << 62);
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

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous product that is still in flight.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define WG_R16_0 "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
#define WG_R16_1 "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
#define WG_R16_2 "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
#define WG_R16_3 "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
#define WG_R16_4 "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79"
#define WG_R16_5 "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
#define WG_R16_6 \
  "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111"
#define WG_R16_7 \
  "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
#define WG_R32 WG_R16_0 "," WG_R16_1
#define WG_R64 WG_R32 "," WG_R16_2 "," WG_R16_3
#define WG_R128 WG_R64 "," WG_R16_4 "," WG_R16_5 "," WG_R16_6 "," WG_R16_7

#define WG_D4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D16(d, i) WG_D4(d, i), WG_D4(d, i + 4), WG_D4(d, i + 8), WG_D4(d, i + 12)
#define WG_D32(d, i) WG_D16(d, i), WG_D16(d, i + 16)
#define WG_D64(d, i) WG_D32(d, i), WG_D32(d, i + 32)
#define WG_D128(d, i) WG_D64(d, i), WG_D64(d, i + 64)

// d (64 x 32) = or += a (64 x 16, shared, K-major) * b (32 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_R16_0
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D16(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) = or += a (64 x 16, shared, K-major) * b (64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D32(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) = or += a (64 x 16, shared, K-major) * b (128 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D64(d, 0)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += a (64 x 16, registers) * b (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_D32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 256) += a (64 x 16, registers) * b (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_R128
      "}, {%128,%129,%130,%131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : WG_D128(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x N) += a (64 x 16, registers) * b (N x 16, shared, K-major): b's N
// rows of 16 reduction values, as a 128-byte-swizzled tile of 64 columns
__device__ __forceinline__ void wgmma_rs_kmajor_n32(float (&d)[16], const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_R16_0
      "}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : WG_D16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_kmajor_n64(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : WG_D32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_kmajor_n128(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : WG_D64(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n32(d, a, b, acc);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n64(d, a, b, acc);
}
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  wgmma_ss_n128(d, a, b, acc);
}

// Dynamic shared memory rounded up to the 1024 bytes the swizzle needs.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
