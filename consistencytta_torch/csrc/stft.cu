// STFT magnitude for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces the JAX package's Pallas kernel
//   consistencytta_tpu/ops/pallas_stft.py:stft_magnitude_pallas (_stft_kernel),
// which computes, for a [B, T] float32 waveform, the reflect-padded framed
// real DFT against a windowed basis and its magnitude,
//   out[b, f, n] = | sum_k wavpad[b, f*hop + k] * (cos[k, n] + i sin[k, n]) |,
// without ever writing the overlapping frames to device memory.
//
// What bounds it on the H100: at window 1024, hop 160 and 513 bins the
// function does 2 * 1024 * 1026 operations per output frame against 640
// bytes of waveform read and 2052 bytes written, some 780 operations per
// byte: it is bound by operations. The accuracy the frontend needs is that
// of float32 (a single bf16 or TF32 pass loses three digits on the 1024-term
// sums). The fastest arithmetic of that accuracy is three TF32 passes on the
// tensor cores: each operand is split into hi (its top 10 mantissa bits,
// rounded to nearest) and lo = x - hi (exact), and a*b is taken as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi; the dropped a_lo*b_lo is 2^-22 of the
// product. The tensor cores add into their float32 accumulators with
// truncation, which over 1024 terms would cost a digit, so the products of
// only KC = 32 window samples are summed there and each such partial sum is
// added to the running total by an ordinary (round-to-nearest) float add.
//
// Design. One block of 8 warps computes a tile of TF = 64 frames x TB = 64
// bins (128 basis columns: 64 cos, then the 64 sin of the same bins) of one
// batch row with mma.sync m16n8k8 (TF32 in, float32 out); a warp owns 32
// frames x 16 bins, so re and im of a bin land in the same thread and the
// magnitude needs no exchange. The block stages the span of the padded
// waveform that its frames cover, (TF - 1) * hop + L samples (44 KB at hop
// 160, L 1024), in shared memory once, doing the reflect padding by index
// arithmetic while it loads; frame f of the tile is the window at f*hop, so
// the frames are never materialised. Two things make the fragment loads
// cheap. Within every aligned group of 8 samples the order is permuted to
// k0 k4 k1 k5 k2 k6 k3 k7, so the two A values a thread needs of a row
// (columns t and t + 4) are one 8-byte load; and every hop samples the span
// skips 8 words, because with hop = 160 = 0 mod 32 the 8 frames of a
// fragment would otherwise sit in one bank. The basis (1024 x 1026 float32,
// 4.2 MB, resident in L2) is packed once on the host side into the exact
// image of the shared-memory tiles ([bin tile][k / 8][128 columns][8 samples
// in the same permuted order], zero columns past n_bins: see
// ops/stft.py:pack_basis), so a tile of KC samples is a contiguous 16 KB that
// streams in with 16-byte cp.async, double-buffered, and a thread's two B
// values are again one conflict-free 8-byte load. hi and lo are split in
// registers after the loads (two integer operations and a subtraction).
// Both edges are ragged (1001 frames, 513 bins): samples past the padded
// signal are zero, and the stores are masked.
// Known gaps: 9 bin tiles cover 576 columns for 513 bins (12% idle work),
// the split is redone by every warp that loads a value, and mma.sync
// reaches a fraction of the wgmma rate.

#include "mma_common.cuh"  // smem_u32, cp_async16, cp_async_commit, cp_async_wait

namespace {

constexpr int TF = 64;            // frames per block
constexpr int TB = 64;            // bins per block
constexpr int NC = 2 * TB;        // basis columns per block: cos then sin
constexpr int KC = 32;            // window samples per staged basis tile
constexpr int NT = 256;           // 8 warps: 2 (frames) x 4 (bins)
constexpr int TILE = KC * NC;     // floats of one staged basis tile
constexpr int SKEW = 8;           // words skipped in the span every hop samples

// x = hi + lo with hi on 10 mantissa bits (round to nearest) and lo exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), TF32 operands, float32 accumulate
__device__ __forceinline__ void mma1688(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// position of sample j (0..7) of an aligned group of 8: k0 k4 k1 k5 k2 k6 k3 k7
__device__ __forceinline__ int slot(int j) { return j < 4 ? 2 * j : 2 * (j - 4) + 1; }

__global__ void __launch_bounds__(NT, 2)
stft_magnitude_kernel(const float* __restrict__ wav, const float* __restrict__ packed,
                      float* __restrict__ out, int T, int L, int hop, int pad,
                      int n_frames, int n_bins) {
  extern __shared__ __align__(16) float smem[];
  const int span = (TF - 1) * hop + L;
  const int row = hop + SKEW;  // words between the starts of two frames
  float* Bs = smem;            // [2][KC / 8][NC][8]
  float* S = smem + 2 * TILE;  // the tile's span of the padded waveform
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int f0 = blockIdx.y * TF;
  const float* w = wav + (size_t)blockIdx.z * T;
  const float* tiles = packed + (size_t)blockIdx.x * L * NC;
  const int n_kc = L / KC;

  auto issue = [&](int kc, float* buf) {
    const float* src = tiles + (size_t)kc * TILE;
    for (int i = tid * 4; i < TILE; i += NT * 4) cp_async16(buf + i, src + i);
    cp_async_commit();
  };
  issue(0, Bs);

  // the span, reflect-padded by index: padded position p is sample p - pad,
  // mirrored about 0 and about T - 1; past the padded signal it is zero
  const int padded = T + 2 * pad;
  for (int i = tid; i < span; i += NT) {
    const int p = f0 * hop + i;
    float v = 0.f;
    if (p < padded) {
      int n = p - pad;
      if (n < 0) n = -n;
      else if (n >= T) n = 2 * (T - 1) - n;
      v = w[n];
    }
    S[(i & ~7) + slot(i & 7) + SKEW * (i / hop)] = v;
  }

  // [frame half of 16][n8 tile: 0, 1 cos and 2, 3 sin of the warp's 16 bins][4]
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

  for (int kc = 0; kc < n_kc; ++kc) {
    if (kc + 1 < n_kc) {
      issue(kc + 1, Bs + ((kc + 1) & 1) * TILE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kc (and, first time round, the span) is visible
    const float* bt = Bs + (kc & 1) * TILE;
    float part[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < KC / 8; ++k8) {
      const int kk = kc * KC + k8 * 8;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = (n >> 1) * TB + wn * 16 + (n & 1) * 8 + g;
        const float2 v = *reinterpret_cast<const float2*>(bt + (k8 * NC + col) * 8 + 2 * t4);
        split(v.x, bh[n][0], bl[n][0]);
        split(v.y, bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* ar = S + (wm * 32 + m * 16 + g) * row + kk + SKEW * (kk / hop) + 2 * t4;
        const float2 top = *reinterpret_cast<const float2*>(ar);            // row g
        const float2 bot = *reinterpret_cast<const float2*>(ar + 8 * row);  // row g + 8
        uint32_t ah[4], al[4];
        split(top.x, ah[0], al[0]);
        split(bot.x, ah[1], al[1]);
        split(top.y, ah[2], al[2]);
        split(bot.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          mma1688(part[m][n], al, bh[n]);
          mma1688(part[m][n], ah, bl[n]);
          mma1688(part[m][n], ah, bh[n]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
    __syncthreads();  // every warp is done with this buffer before its refill
  }

  float* o = out + (size_t)blockIdx.z * n_frames * n_bins;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int f = f0 + wm * 32 + m * 16 + g + 8 * half;
      if (f >= n_frames) continue;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bin = blockIdx.x * TB + wn * 16 + n * 8 + 2 * t4 + e;
          const float re = acc[m][n][2 * half + e], im = acc[m][n + 2][2 * half + e];
          if (bin < n_bins) o[(size_t)f * n_bins + bin] = sqrtf(re * re + im * im);
        }
    }
}

}  // namespace

// wav: [B, T] float32. packed: [ceil(n_bins / 64)][L / 8][128][8] float32, the
// basis as ops/stft.py:pack_basis lays it out. out: [B, n_frames, n_bins]
// float32. hop % 8 == 0 and L % 32 == 0; pad < T.
extern "C" int stft_magnitude_fwd(const void* wav, const void* packed, void* out, int B,
                                  int T, int L, int hop, int pad, int n_frames,
                                  int n_bins, void* stream) {
  if (hop % 8 || L % KC || pad >= T) return (int)cudaErrorInvalidValue;
  const int span = (TF - 1) * hop + L;
  const int smem = (2 * TILE + span + SKEW * (span / hop + 1)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stft_magnitude_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_bins + TB - 1) / TB, (n_frames + TF - 1) / TF, B);
  stft_magnitude_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(wav), static_cast<const float*>(packed),
      static_cast<float*>(out), T, L, hop, pad, n_frames, n_bins);
  return (int)cudaGetLastError();
}
