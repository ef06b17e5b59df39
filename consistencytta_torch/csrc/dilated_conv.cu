// Dilated conv1d for Hopper (sm_90a): kernel K5 of the port.
//
// Replaces the JAX package's Pallas kernel
//   consistencytta_tpu/ops/pallas_blockconv.py:blockconv1d_dense (_kernel_body),
// a standalone kernel for the vocoder's dilated ResBlock convs that nothing
// dispatches there, and nothing dispatches here. It computes
//   y[b, co, j] = sum_t sum_ci w[co, ci, t] * x[b, ci, j - p + t*d]
// with x zero outside [0, L), bf16 in, fp32 accumulation, bf16 out. The TPU
// kernel exists to skip the structured zeros that its [B, M, 2*64] block
// layout puts into the taps; in the natural [B, C, L] layout used here there
// are none, so the function is k shifted [C, C] products over a tile of
// positions.
//
// What bounds it on the H100: 2*C*k operations per 4 bytes moved (x read
// once, y written once): 352 operations per byte at C = 64, k = 11, near
// the card's ~295 line, and 96 at k = 3, where it is bound by memory.
//
// Design, after csrc/mrf.cu, whose fragments it shares (mma_common.cuh).
// One block takes T output positions of one batch row and stages
// x[t0 - p, t0 - p + T + (k-1)*d) position-major ([pos][C + 8] bf16: the
// channels of a position are contiguous, the 8-element pad spreads a
// fragment's rows over the banks) in shared memory, zero outside the
// signal. The weights, [k][C_in][C_out], stream through shared memory in
// units of one tap x min(C, 64) input channels, double-buffered with
// cp.async. Each of the 8 warps holds MR chunks of 16 positions x all C
// output channels as mma.sync m16n8k16 accumulators (MR = 4, 2, 1 and
// T = 512, 256, 128 at C = 32, 64, 128). The epilogue rounds to bf16 into
// the staging buffer and the block writes y from there along the position
// axis, so that the stores to the [B, C, L] layout are contiguous.
// Known gaps: the transposing loads and stores move 2 bytes a thread, and
// there is no wgmma.

#include "mma_common.cuh"

namespace {

constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;

template <int NF8, int MR>
__global__ void __launch_bounds__(NT)
dilated_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ y, int L, int L_out, int k, int d, int p) {
  constexpr int C = 8 * NF8;
  constexpr int LD = C + 8;
  constexpr int KC = C < 64 ? C : 64;
  constexpr int N_CI = C / KC;
  constexpr int T = NWARPS * MR * 16;
  constexpr int UNIT = KC * LD;  // elements of one weight buffer
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* X = Ws + 2 * UNIT;
  const int rows = T + (k - 1) * d;
  const int t0 = blockIdx.x * T;
  const bf16* xb = x + (size_t)blockIdx.y * C * L;
  bf16* yb = y + (size_t)blockIdx.y * C * L_out;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_units = k * N_CI;

  // stage weight unit u (tap u / N_CI, input channels (u % N_CI) * KC..)
  auto issue = [&](int u, bf16* buf) {
    const bf16* src = w + (size_t)(u / N_CI) * C * C + (size_t)((u % N_CI) * KC) * C;
    for (int i = threadIdx.x; i < KC * (C / 8); i += NT) {
      const int r = i / (C / 8), c = (i % (C / 8)) * 8;
      cp_async16(buf + r * LD + c, src + (size_t)r * C + c);
    }
    cp_async_commit();
  };
  issue(0, Ws);

  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < rows * C; i += NT) {
    const int c = i / rows, r = i % rows, gx = t0 - p + r;
    X[(size_t)r * LD + c] = (gx >= 0 && gx < L) ? xb[(size_t)c * L + gx] : zero;
  }

  float acc[MR][NF8][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int n = 0; n < NF8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int u = 0; u < n_units; ++u) {
    if (u + 1 < n_units) {
      issue(u + 1, Ws + ((u + 1) & 1) * UNIT);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // unit u (and, first time round, X) is visible to every warp
    const int t = u / N_CI, ci0 = (u % N_CI) * KC;
    const bf16* wb = Ws + (u & 1) * UNIT;
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t bw[NF8][2];
#pragma unroll
      for (int np = 0; np < NF8 / 2; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, wb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                             np * 16 + (lane >> 4) * 8);
        bw[2 * np][0] = r[0];
        bw[2 * np][1] = r[1];
        bw[2 * np + 1][0] = r[2];
        bw[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int j0 = (m * NWARPS + warp) * 16;
        const bf16* ar = X + (size_t)(j0 + t * d + g) * LD + ci0 + kk + 2 * t4;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(ar);
        a[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * LD);
        a[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * LD + 8);
#pragma unroll
        for (int n = 0; n < NF8; ++n) mma16816(acc[m][n], a, bw[n][0], bw[n][1]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  // every warp is past its last read of X: round into it, position-major
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int j0 = (m * NWARPS + warp) * 16;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = j0 + g + half * 8;
#pragma unroll
      for (int n = 0; n < NF8; ++n) {
        __nv_bfloat162 v;
        v.x = __float2bfloat16(acc[m][n][2 * half]);
        v.y = __float2bfloat16(acc[m][n][2 * half + 1]);
        *reinterpret_cast<__nv_bfloat162*>(X + (size_t)j * LD + n * 8 + 2 * t4) = v;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T * C; i += NT) {
    const int c = i / T, j = i % T, gy = t0 + j;
    if (gy < L_out) yb[(size_t)c * L_out + gy] = X[(size_t)j * LD + c];
  }
}

template <int NF8, int MR>
cudaError_t launch(const void* x, const void* w, void* y, int B, int L, int L_out,
                   int k, int d, int p, cudaStream_t stream) {
  constexpr int C = 8 * NF8, LD = C + 8, KC = C < 64 ? C : 64;
  constexpr int T = NWARPS * MR * 16;
  const size_t smem = (size_t)(2 * KC * LD + (T + (k - 1) * d) * LD) * sizeof(bf16);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dilated_conv_kernel<NF8, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L_out + T - 1) / T, B);
  dilated_conv_kernel<NF8, MR><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(y), L, L_out, k, d, p);
  return cudaGetLastError();
}

}  // namespace

// x: [B, C, L] bf16. w: [k][C_in][C_out] bf16. y: [B, C, L_out] bf16 with
// L_out = L + 2p - d(k-1). C is 32, 64 or 128.
extern "C" int dilated_conv1d_fwd(const void* x, const void* w, void* y, int B, int C,
                                  int L, int L_out, int k, int d, int p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (C == 32)
    err = launch<4, 4>(x, w, y, B, L, L_out, k, d, p, s);
  else if (C == 64)
    err = launch<8, 2>(x, w, y, B, L, L_out, k, d, p, s);
  else if (C == 128)
    err = launch<16, 1>(x, w, y, B, L, L_out, k, d, p, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
