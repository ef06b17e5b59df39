// Fused HiFi-GAN MRF level for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces the JAX package's Pallas kernel
//   consistencytta_tpu/ops/pallas_mrf.py:fused_mrf_level (_kernel_body),
// which computes one vocoder upsample level in one pass: three ResBlocks
// (kernel sizes k = 3, 7, 11, dilations 1, 3, 5), each a chain of
//   t = lrelu(xb); t = conv_{k,d}(t) + b; t = lrelu(t); t = conv_{k,1}(t) + b;
//   xb = xb + t
// over its three dilations, then the mean of the three results. Every conv
// output is re-zeroed outside [0, L): that is each conv's zero padding at
// the signal edges. Rounding follows the plain chain in bf16: each conv
// accumulates in fp32 and rounds to bf16, then the bias add, the leaky
// relu, the residual add, the 3-way sum and the division each round to bf16.
//
// What bounds it on the H100: unfused, the level reads and writes its
// [B, C, L] activation some 20 times (once per conv and relu pass) against
// 6 * 21 * 2 * C^2 operations per sample; at C = 32 and 64 that is below the
// card's ~295 operations per byte, so the plain chain is bound by memory.
// Fused, the level reads x once and writes y once, and what bounds it is
// operations: the convs run as per-tap matrix products on the tensor cores,
// positions x input channels against input channels x output channels.
//
// Layout and tiling: the activation stays in its natural [B, C, L] layout in
// device memory. One block takes T output positions of one batch row; each
// ResBlock recomputes a halo of H_k = (k-1)/2 * (1+3+5) + 3*(k-1)/2 positions
// on each side (60 for k = 11), so that every conv of the chain has its
// whole receptive field in the block and no intermediate leaves it. The
// intermediates sit position-major ([pos][C + 8], channels contiguous, the
// 8-element pad puts the rows of a fragment on distinct banks) in two
// buffers: xb and the first conv's output (lrelu(xb) is applied to the
// fragments in registers, never stored). They live in shared memory when
// both buffers of T + 2*H + 16 rows fit, with T as large as fits up to 512
// (512 at C = 32 and 64, 224 at C = 128); at wider C (the C = 256 and 512
// levels) they live in a per-block slice of a device workspace that the
// caller allocates (T = 64), and the blocks loop over tiles. The weights do
// not fit beside them (one
// k = 11 conv at C = 128 is 352 KB; the level's 18 convs, 1.4 MB, stay
// resident in L2): they stream through shared memory in units of one tap x
// 64 input channels x <= 128 output channels, double-buffered with cp.async
// so the next unit loads while the current one is used. The products are
// mma.sync m16n8k16 (bf16 in, fp32 accumulate): each warp holds MR row
// chunks of 16 positions x all <= 128 output channels of the pass in
// registers (MR = 4, 2, 1 at C = 32, 64, >= 128), and the epilogue (bias,
// rounding, leaky relu, edge mask, residual) works on those registers.
// Known gaps: the halo is recomputed (about 1.2x the useful work at C = 128,
// T = 224), and there is no warp specialisation or wgmma.

#include "mma_common.cuh"

// Kernel sizes of the three ResBlocks and their dilations, by value.
struct MrfPlan {
  int ks[3];
  int dil[3][3];
};

namespace {

constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;

__device__ __forceinline__ bf16 lrelu(bf16 v, float slope) {
  const float f = __bfloat162float(v);
  return f > 0.f ? v : __float2bfloat16(f * slope);
}

__device__ __forceinline__ bf16 badd(bf16 a, bf16 b) {
  return __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
}

__device__ __forceinline__ uint32_t lrelu2(uint32_t v, float slope) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h.x = lrelu(h.x, slope);
  h.y = lrelu(h.y, slope);
  return *reinterpret_cast<uint32_t*>(&h);
}

__host__ __device__ constexpr int co_width(int C) { return C < 128 ? C : 128; }
__host__ __device__ constexpr int ci_width(int C) { return C < 64 ? C : 64; }

// One conv of the chain over output rows [lo, hi) of the block's extent:
//   FIRST:  Bb[j] = mask(lrelu(bf16(sum_t W[t] . lrelu(X[j - p + t*d])) + b))
//   !FIRST: X[j] += mask(bf16(sum_t W[t] . Bb[j - p + t]) + b)
// (W[t] is [C_in][C_out]; the input's leaky relu is applied to the A
// fragments in registers, so lrelu(X) is never stored.)
// Output channels go in passes of CO = 8*NF8 (<= 128); within one, the
// 16-row chunks go in rounds of NWARPS*MR. Buffers may be in shared or device
// memory (plain loads and stores); Ws is two weight units in shared memory.
template <int NF8, int MR, bool FIRST>
__device__ void conv_stage(bf16* X, bf16* Bb, bf16* Ws, int ld, int lo, int hi, int k,
                           int d, const bf16* __restrict__ W,
                           const bf16* __restrict__ bias, int C, int g0, int L,
                           float slope) {
  constexpr int CO = 8 * NF8;
  constexpr int LDW = CO + 8;
  const int KC = ci_width(C), n_ci = C / KC, n_units = k * n_ci;
  const int unit = KC * LDW;  // elements of one weight buffer
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int p = d * (k - 1) / 2;
  const int n_rc = (hi - lo + 15) / 16;
  const bf16* in = FIRST ? X : Bb;

  for (int co0 = 0; co0 < C; co0 += CO) {
    // stage weight unit u (tap u / n_ci, input channels (u % n_ci) * KC..)
    auto issue = [&](int u, bf16* buf) {
      const bf16* src = W + (size_t)(u / n_ci) * C * C +
                        (size_t)((u % n_ci) * KC) * C + co0;
      for (int i = threadIdx.x; i < KC * (CO / 8); i += NT) {
        const int r = i / (CO / 8), c = (i % (CO / 8)) * 8;
        cp_async16(buf + r * LDW + c, src + (size_t)r * C + c);
      }
      cp_async_commit();
    };
    for (int rc0 = 0; rc0 < n_rc; rc0 += NWARPS * MR) {
      float acc[MR][NF8][4];
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int n = 0; n < NF8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

      issue(0, Ws);
      for (int u = 0; u < n_units; ++u) {
        if (u + 1 < n_units) {
          issue(u + 1, Ws + ((u + 1) & 1) * unit);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // unit u is visible to every warp
        const int t = u / n_ci, ci0 = (u % n_ci) * KC;
        const bf16* wb = Ws + (u & 1) * unit;
        for (int kk = 0; kk < KC; kk += 16) {
          uint32_t bw[NF8][2];
#pragma unroll
          for (int np = 0; np < NF8 / 2; ++np) {
            uint32_t r[4];
            ldsm_x4_trans(r, wb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDW +
                                 np * 16 + (lane >> 4) * 8);
            bw[2 * np][0] = r[0];
            bw[2 * np][1] = r[1];
            bw[2 * np + 1][0] = r[2];
            bw[2 * np + 1][1] = r[3];
          }
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const int rc = rc0 + m * NWARPS + warp;
            if (rc < n_rc) {
              const bf16* ar =
                  in + (size_t)(lo + rc * 16 - p + t * d + g) * ld + ci0 + kk + 2 * t4;
              uint32_t a[4];
              a[0] = *reinterpret_cast<const uint32_t*>(ar);
              a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * ld);
              a[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
              a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * ld + 8);
              if (FIRST) {
#pragma unroll
                for (int e = 0; e < 4; ++e) a[e] = lrelu2(a[e], slope);
              }
#pragma unroll
              for (int n = 0; n < NF8; ++n) mma16816(acc[m][n], a, bw[n][0], bw[n][1]);
            }
          }
        }
        __syncthreads();  // every warp is done with this buffer before its refill
      }

      // epilogue on the accumulator registers
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int rc = rc0 + m * NWARPS + warp;
        if (rc >= n_rc) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = lo + rc * 16 + g + half * 8;
          if (j >= hi) continue;
          const int gpos = g0 + j;
          const bool inside = gpos >= 0 && gpos < L;
#pragma unroll
          for (int n = 0; n < NF8; ++n) {
            const int co = co0 + n * 8 + 2 * t4;
            bf16 v0 = badd(__float2bfloat16(acc[m][n][2 * half]), bias[co]);
            bf16 v1 = badd(__float2bfloat16(acc[m][n][2 * half + 1]), bias[co + 1]);
            const size_t idx = (size_t)j * ld + co;
            if (FIRST) {
              __nv_bfloat162 out;
              out.x = inside ? lrelu(v0, slope) : __float2bfloat16(0.f);
              out.y = inside ? lrelu(v1, slope) : __float2bfloat16(0.f);
              *reinterpret_cast<__nv_bfloat162*>(Bb + idx) = out;
            } else {
              if (!inside) v0 = v1 = __float2bfloat16(0.f);
              __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(X + idx);
              xv.x = badd(xv.x, v0);
              xv.y = badd(xv.y, v1);
              *reinterpret_cast<__nv_bfloat162*>(X + idx) = xv;
            }
          }
        }
      }
    }
  }
}

__host__ __device__ constexpr size_t ws_bytes(int C) {
  return (size_t)2 * ci_width(C) * (co_width(C) + 8) * 2;
}

template <int NF8, int MR>
__global__ void __launch_bounds__(NT)
mrf_level_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                 const bf16* __restrict__ w, const bf16* __restrict__ bias,
                 bf16* workspace, MrfPlan plan, int B, int C, int L, int T,
                 int rows, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  const int ld = C + 8;
  const size_t buf = (size_t)rows * ld;
  bf16* base = workspace != nullptr
                   ? workspace + (size_t)blockIdx.x * 2 * buf
                   : reinterpret_cast<bf16*>(smem + ws_bytes(C));
  bf16* X = base;
  bf16* Bb = base + buf;
  const bf16 zero = __float2bfloat16(0.f);

  const int n_tiles = (L + T - 1) / T;
  for (int work = blockIdx.x; work < B * n_tiles; work += gridDim.x) {
    const int b = work / n_tiles;
    const int t0 = (work % n_tiles) * T;
    const bf16* xb = x + (size_t)b * C * L;
    bf16* yb = y + (size_t)b * C * L;
    const bf16* wconv = w;
    const bf16* bconv = bias;
    for (int rb = 0; rb < 3; ++rb) {
      const int k = plan.ks[rb];
      int hk = 0;
      for (int i = 0; i < 3; ++i) hk += (plan.dil[rb][i] + 1) * (k - 1) / 2;
      const int E = T + 2 * hk;
      const int g0 = t0 - hk;
      __syncthreads();  // previous tile / resblock is done with the buffers
      for (int i = threadIdx.x; i < E * C; i += NT) {
        const int c = i / E, j = i % E, g = g0 + j;
        X[(size_t)j * ld + c] = (g >= 0 && g < L) ? xb[(size_t)c * L + g] : zero;
      }
      int lo = 0, hi = E;
      for (int i = 0; i < 3; ++i) {
        const int d = plan.dil[rb][i];
        const int p1 = d * (k - 1) / 2, p2 = (k - 1) / 2;
        // each conv_stage opens with a barrier before reading its input
        conv_stage<NF8, MR, true>(X, Bb, Ws, ld, lo + p1, hi - p1, k, d,
                                  wconv, bconv, C, g0, L, slope);
        wconv += (size_t)k * C * C;
        bconv += C;
        lo += p1;
        hi -= p1;
        conv_stage<NF8, MR, false>(X, Bb, Ws, ld, lo + p2, hi - p2, k, 1,
                                   wconv, bconv, C, g0, L, slope);
        wconv += (size_t)k * C * C;
        bconv += C;
        lo += p2;
        hi -= p2;
      }
      __syncthreads();  // the last conv's writes to X are visible
      // rows [hk, hk + T) now hold this resblock's output for the tile
      for (int i = threadIdx.x; i < T * C; i += NT) {
        const int c = i / T, j = i % T, g = t0 + j;
        if (g >= L) continue;
        const bf16 v = X[(size_t)(hk + j) * ld + c];
        bf16* out = yb + (size_t)c * L + g;
        if (rb == 0) {
          *out = v;
        } else {
          bf16 s = badd(*out, v);
          if (rb == 2) s = __float2bfloat16(__bfloat162float(s) / 3.f);
          *out = s;
        }
      }
    }
  }
}

template <int NF8, int MR>
cudaError_t launch(const void* x, void* y, const void* w, const void* bias,
                   void* workspace, MrfPlan plan, int B, int C, int L, int T,
                   int rows, int grid, int smem, float slope,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mrf_level_kernel<NF8, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  mrf_level_kernel<NF8, MR><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y),
      static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<bf16*>(workspace), plan, B, C, L, T, rows, slope);
  return cudaGetLastError();
}

// Bytes of dynamic shared memory: two weight units, and the two buffers
// when they live in shared memory.
int smem_bytes(int C, int rows, bool buffers_in_smem) {
  size_t bytes = ws_bytes(C);
  if (buffers_in_smem) bytes += (size_t)2 * rows * (C + 8) * 2;
  return (int)bytes;
}

}  // namespace

// x, y: [B, C, L] bf16, contiguous. w: the 18 convs in chain order, each
// [k][C_in][C_out] bf16, back to back. bias: [18][C] bf16. workspace: null
// (buffers in shared memory) or grid * 2 * rows * (C + 8) bf16.
// C is 32, 64 or a multiple of 128.
extern "C" int mrf_level_fwd(const void* x, void* y, const void* w,
                             const void* bias, void* workspace, MrfPlan plan,
                             int B, int C, int L, int T, int rows, int grid,
                             float slope, void* stream) {
  const int smem = smem_bytes(C, rows, workspace == nullptr);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (C == 32)
    err = launch<4, 4>(x, y, w, bias, workspace, plan, B, C, L, T, rows, grid,
                       smem, slope, s);
  else if (C == 64)
    err = launch<8, 2>(x, y, w, bias, workspace, plan, B, C, L, T, rows, grid,
                       smem, slope, s);
  else if (C % 128 == 0)
    err = launch<16, 1>(x, y, w, bias, workspace, plan, B, C, L, T, rows, grid,
                        smem, slope, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
