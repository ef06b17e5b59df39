// Flash self-attention for Hopper (sm_90a): kernels K1 and K2 of the port.
//
// Replaces the JAX package's Pallas kernels
//   K1  consistencytta_tpu/ops/pallas_attention.py:flash_mha_packed
//       (_flash_packed_kernel, UNet self-attention on the packed
//       [B, S, H*64] projection layout), and
//   K2  consistencytta_tpu/ops/pallas_attention.py:flash_self_attention
//       (_flash_kernel, VAE mid-block attention, one head of width 512).
// Both compute non-causal, unmasked softmax(q k^T * scale) v with an fp32
// online softmax in base 2, and never write the [S, S] logits to memory.
//
// What bounds it on the H100: at the main path's shapes (S = 4096, 1024,
// 256, 64) the work is 4*S^2*d operations against ~4*S*d bytes, far above
// the card's ~295 operations per byte, so it is bound by operations: both
// products run on the tensor cores (bf16 in, fp32 accumulate).
//
// K1 (mha_packed_kernel): one block of 4 warps takes a 64-row query tile of
// one head; each warp owns 16 query rows. q/k/v/o are addressed through row
// and batch strides, so the three views of one fused QKV projection are read
// in place and no head transpose is materialised. A loop over 64-row key
// tiles inside the block replaces the TPU's sequential grid axis; the next
// K/V tile is fetched with cp.async while the current one is used (double
// buffer). The products are mma.sync m16n8k16 with operands from ldmatrix;
// the logits stay in the accumulator registers, the online softmax runs on
// them there (row max and sum across the 4 lanes of a row by shuffles), and
// the same registers, rounded to bf16, are the A operand of p v. Known gaps:
// no warp specialisation or wgmma (the Hopper-only async tensor-core path).
//
// K2 (self_attention_kernel): the same design for one head of width D = 512,
// the only width on the port's path. q stays in shared memory for the whole key loop (64 rows x
// 512), key/value tiles are 32 rows, double-buffered. A 64-row fp32
// accumulator of width 512 does not fit a warp's registers, so the output's
// D is split into 2 slices of 256 across blocks; each block recomputes
// q k^T over the full D for its slice (1.5x the minimal work).
//
// Ragged S (both): key rows beyond S load as zeros and their logits are set
// to -1e30 before the max; query rows beyond S are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 128;  // threads per block (4 warps, 16 query rows each)
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// K1: mma.sync flash attention, head width 64

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int K1_D = 64;   // head width
constexpr int K1_LD = 72;  // smem row pitch (144 B: ldmatrix rows hit distinct banks)

// Copy a 64 x 64 bf16 tile (rows row0.. of a strided matrix) to shared
// memory with cp.async, zero-filling rows at or beyond S.
__device__ __forceinline__ void k1_load_tile(bf16* dst, const bf16* src, long ld,
                                             int row0, int S) {
  for (int i = threadIdx.x; i < 64 * 8; i += NT) {
    const int r = i >> 3, c = (i & 7) * 8, row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * K1_LD + c, src + (size_t)(ok ? row : 0) * ld + c, ok);
  }
}

__global__ void __launch_bounds__(NT)
mha_packed_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                  long ldq, long ldk, long ldv, long ldo, long bsq, long bsk,
                  long bsv, long bso, float scale_log2) {
  __shared__ __align__(128) bf16 Qs[64 * K1_LD];
  __shared__ __align__(128) bf16 Ks[2][64 * K1_LD];
  __shared__ __align__(128) bf16 Vs[2][64 * K1_LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * 64;
  const size_t head = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * bsq + head * K1_D;
  const bf16* kb = k + b * bsk + head * K1_D;
  const bf16* vb = v + b * bsv + head * K1_D;
  bf16* ob = o + b * bso + head * K1_D;

  k1_load_tile(Qs, qb, ldq, q0, S);
  k1_load_tile(Ks[0], kb, ldk, 0, S);
  k1_load_tile(Vs[0], vb, ldv, 0, S);
  cp_async_commit();

  float oacc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  uint32_t qf[4][4];

  const int n_tiles = (S + 63) / 64;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      k1_load_tile(Ks[buf ^ 1], kb, ldk, (j + 1) * 64, S);
      k1_load_tile(Vs[buf ^ 1], vb, ldv, (j + 1) * 64, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(qf[kk], Qs + row * K1_LD + kk * 16 + (lane >> 4) * 8);
      }
    }

    // logits of this warp's 16 rows against the tile's 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    const bf16* Kt = Ks[buf];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        ldsm_x4(bk, Kt + key * K1_LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], qf[kk], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // online softmax, base 2
    const int kbase = j * 64;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kbase + n * 8 + 2 * t4 + e < S;
        s[n][e] = ok ? s[n][e] * scale_log2 : NEG;
        s[n][2 + e] = ok ? s[n][2 + e] * scale_log2 : NEG;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = exp2f(s[n][e] - mx0);
        s[n][2 + e] = exp2f(s[n][2 + e] - mx1);
        rs0 += s[n][e];
        rs1 += s[n][2 + e];
      }
      oacc[n][0] *= alpha0;
      oacc[n][1] *= alpha0;
      oacc[n][2] *= alpha1;
      oacc[n][3] *= alpha1;
    }
    l0 = l0 * alpha0 + rs0;  // this lane's partial row sums
    l1 = l1 * alpha1 + rs1;

    // O += P V, P from the logit registers rounded to bf16
    const bf16* Vt = Vs[buf];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bv[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(bv, Vt + key * K1_LD + np * 16 + (lane >> 4) * 8);
        mma16816(oacc[2 * np], pa, bv[0], bv[1]);
        mma16816(oacc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * ldo + col) =
          __floats2bfloat162_rn(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * ldo + col) =
          __floats2bfloat162_rn(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// K2: mma.sync flash attention, one head of width D, output in slices of DV

template <int D, int DV>
struct K2Smem {
  static constexpr int BK = 32;       // keys per tile
  static constexpr int LDQ = D + 8;   // q/k row pitch (rows on distinct banks)
  static constexpr int LDV = DV + 8;  // v row pitch
  static constexpr size_t q = 0;
  static constexpr size_t k = q + (size_t)64 * LDQ * 2;
  static constexpr size_t v = k + (size_t)2 * BK * LDQ * 2;
  static constexpr size_t bytes = v + (size_t)2 * BK * LDV * 2;
};

template <int W>
__device__ __forceinline__ void k2_load_rows(bf16* dst, int pitch, const bf16* src,
                                             long ld, int row0, int rows, int S) {
  constexpr int V = W / 8;
  for (int i = threadIdx.x; i < rows * V; i += NT) {
    const int r = i / V, c = (i % V) * 8, row = row0 + r;
    const bool ok = row < S;
    cp_async16(dst + r * pitch + c, src + (size_t)(ok ? row : 0) * ld + c, ok);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(NT)
self_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                      long ldq, long ldk, long ldv, long ldo, long bsq, long bsk,
                      long bsv, long bso, float scale_log2) {
  using L = K2Smem<D, DV>;
  constexpr int BK = L::BK, NO = DV / 8;  // output n8 tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * 64;
  const size_t slice = blockIdx.y, b = blockIdx.z;
  const bf16* qb = q + b * bsq;
  const bf16* kb = k + b * bsk;
  const bf16* vb = v + b * bsv + slice * DV;
  bf16* ob = o + b * bso + slice * DV;

  k2_load_rows<D>(Qs, L::LDQ, qb, ldq, q0, 64, S);
  k2_load_rows<D>(Ks, L::LDQ, kb, ldk, 0, BK, S);
  k2_load_rows<DV>(Vs, L::LDV, vb, ldv, 0, BK, S);
  cp_async_commit();

  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  const int n_tiles = (S + BK - 1) / BK;
  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      k2_load_rows<D>(Ks + (buf ^ 1) * BK * L::LDQ, L::LDQ, kb, ldk, (j + 1) * BK, BK, S);
      k2_load_rows<DV>(Vs + (buf ^ 1) * BK * L::LDV, L::LDV, vb, ldv, (j + 1) * BK, BK, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * BK * L::LDQ;
    const bf16* Vt = Vs + buf * BK * L::LDV;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      const int qrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm_x4(qa, Qs + qrow * L::LDQ + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bk[4];
        const int key = np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        ldsm_x4(bk, Kt + key * L::LDQ + kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], qa, bk[0], bk[1]);
        mma16816(s[2 * np + 1], qa, bk[2], bk[3]);
      }
    }

    const int kbase = j * BK;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = kbase + n * 8 + 2 * t4 + e < S;
        s[n][e] = ok ? s[n][e] * scale_log2 : NEG;
        s[n][2 + e] = ok ? s[n][2 + e] * scale_log2 : NEG;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = exp2f(s[n][e] - mx0);
        s[n][2 + e] = exp2f(s[n][2 + e] - mx1);
        rs0 += s[n][e];
        rs1 += s[n][2 + e];
      }
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= alpha0;
      oacc[n][1] *= alpha0;
      oacc[n][2] *= alpha1;
      oacc[n][3] *= alpha1;
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        uint32_t bv[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(bv, Vt + key * L::LDV + np * 16 + (lane >> 4) * 8);
        mma16816(oacc[2 * np], pa, bv[0], bv[1]);
        mma16816(oacc[2 * np + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t4;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * ldo + col) =
          __floats2bfloat162_rn(oacc[n][0] * inv0, oacc[n][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * ldo + col) =
          __floats2bfloat162_rn(oacc[n][2] * inv1, oacc[n][3] * inv1);
  }
}

template <int D, int DV>
cudaError_t launch_self_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, long ldq, long ldk,
                                  long ldv, long ldo, long bsq, long bsk,
                                  long bsv, long bso, float scale_log2,
                                  cudaStream_t stream) {
  const size_t smem = K2Smem<D, DV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(self_attention_kernel<D, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + 63) / 64, D / DV, B);
  self_attention_kernel<D, DV><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, ldq, ldk, ldv, ldo,
      bsq, bsk, bsv, bso, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// K1: packed multi-head layout. q/k/v/o rows hold H heads of width d == 64;
// strides in elements.
extern "C" int flash_mha_packed_fwd(const void* q, const void* k, const void* v,
                                    void* o, int B, int S, int heads, int d,
                                    int ldq, int ldk, int ldv, int ldo, int bsq,
                                    int bsk, int bsv, int bso, float scale_log2,
                                    void* stream) {
  if (d != K1_D) return (int)cudaErrorInvalidValue;
  dim3 grid((S + 63) / 64, heads, B);
  mha_packed_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, ldq, ldk, ldv,
      ldo, bsq, bsk, bsv, bso, scale_log2);
  return (int)cudaGetLastError();
}

// K2: one head of width D == 512, the output split in 2 slices of 256
// across blocks.
extern "C" int flash_self_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, int B, int S,
                                        int D, int ldq, int ldk, int ldv,
                                        int ldo, int bsq, int bsk, int bsv,
                                        int bso, float scale_log2,
                                        void* stream) {
  if (D != 512) return (int)cudaErrorInvalidValue;
  return (int)launch_self_attention<512, 256>(q, k, v, o, B, S, ldq, ldk, ldv,
                                              ldo, bsq, bsk, bsv, bso,
                                              scale_log2, (cudaStream_t)stream);
}
