// STFT magnitude for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces the JAX package's Pallas kernel
//   consistencytta_tpu/ops/pallas_stft.py:stft_magnitude_pallas (_stft_kernel),
// which computes, for a [B, T] float32 waveform, the reflect-padded framed
// real DFT against a windowed basis and its magnitude,
//   out[b, f, k] = | sum_n wavpad[b, f*hop + n] * w[n] * e^{-2 pi i k n / N} |,
// for N = 1024 and bins k = 0..N/2, without ever writing the overlapping
// frames to device memory. The windowed basis of the frontend is exactly the
// window times the DFT (ops/mel.py:real_dft_basis), so the kernel takes the
// window and computes the DFT as an FFT.
//
// What bounds it on the H100: a complex FFT of two frames does about
// 5 N log2 N = 51,200 operations, ~25,600 a frame, against 640 bytes of new
// waveform read and 2052 bytes of magnitudes written a frame: ~10 operations
// a byte, below the ~20 a byte at which the FP32 rate (67 TFLOP/s) and the
// memory (3.35 TB/s) balance. At batch 8 that is ~3 us of arithmetic against
// ~6.4 us of bytes: it is bound by the bytes it must move (read the waveform
// once, write the magnitudes once).
//
// Design. One block of 8 warps takes FPB = 32 consecutive frames of one batch
// row. It stages the span of the padded waveform those frames cover,
// (FPB - 1) * hop + N samples, in shared memory once, doing the reflect
// padding by index arithmetic while it loads. Each warp then takes two frames
// at a time as one complex sequence (frame f the real part, frame f + 1 the
// imaginary part) and runs a 1024-point complex FFT on it as 32 x 32 (the
// four-step FFT): lane n1 takes the 32 samples n1 + 32 n2 (times the window,
// staged in shared memory beside the span), runs a radix-2 32-point FFT on them in
// registers, multiplies by the twiddles W_1024^(n1 k2) and writes the result
// transposed to a per-warp exchange buffer (rows of 33 to keep the banks
// apart); lane k2 then reads row k2 and runs the second 32-point FFT, which
// leaves bins k2 + 32 k1 in its registers. The two real spectra are separated
// with the conjugate-symmetry identity: bin N - k of the same pair lives in
// lane (32 - k2) mod 32, one shuffle away. Each lane takes the magnitude in
// fp32 and stores it, 32 consecutive bins a warp store.
//
// Precision: all arithmetic is fp32 (no fast-math, no __sinf); the twiddles
// come from a table the host builds once in float64 and rounds to float32
// (ops/stft.py:fft_twiddles). An fp32 FFT is accurate to about eps * log2 N
// of the spectrum's RMS.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N = 1024;       // filter length: 32 x 32
constexpr int R = 32;         // radix of the two passes
constexpr int FPB = 32;       // frames a block
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int XROW = R + 1;   // float2 a row of the exchange buffer

__host__ __device__ constexpr int bitrev5(int x) {
  return ((x & 1) << 4) | ((x & 2) << 2) | (x & 4) | ((x & 8) >> 2) | ((x & 16) >> 4);
}

// One radix-2 decimation-in-frequency stage over butterflies HALF apart
// (every index a constant, so the arrays stay in registers). tw32[e] is
// W_32^e for e < 16; the multiplications by 1 and -i are done exactly.
template <int HALF>
__device__ __forceinline__ void fft_stage(float (&re)[R], float (&im)[R], const float2* tw32) {
  constexpr int STRIDE = (R / 2) / HALF;
#pragma unroll
  for (int base = 0; base < R; base += 2 * HALF) {
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int a = base + j, b = a + HALF, e = j * STRIDE;
      const float ur = re[a] + re[b], ui = im[a] + im[b];
      const float vr = re[a] - re[b], vi = im[a] - im[b];
      re[a] = ur;
      im[a] = ui;
      if (e == 0) {
        re[b] = vr;
        im[b] = vi;
      } else if (e == R / 4) {  // W_32^8 = -i
        re[b] = vi;
        im[b] = -vr;
      } else {
        const float2 w = tw32[e];
        re[b] = vr * w.x - vi * w.y;
        im[b] = vr * w.y + vi * w.x;
      }
    }
  }
}

// In-place radix-2 FFT of 32 complex values in registers: natural order in,
// bin k out in register bitrev5(k).
__device__ __forceinline__ void fft32(float (&re)[R], float (&im)[R], const float2* tw32) {
  fft_stage<16>(re, im, tw32);
  fft_stage<8>(re, im, tw32);
  fft_stage<4>(re, im, tw32);
  fft_stage<2>(re, im, tw32);
  fft_stage<1>(re, im, tw32);
}

__global__ void __launch_bounds__(NT, 2)
stft_fft_kernel(const float* __restrict__ wav, const float* __restrict__ window,
                const float2* __restrict__ twiddles, float* __restrict__ out, int T,
                int hop, int pad, int n_frames) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* xbuf = reinterpret_cast<float2*>(smem);  // [NWARPS][R][XROW]
  float2* tw32 = xbuf + NWARPS * R * XROW;         // [R / 2]
  float* win = reinterpret_cast<float*>(tw32 + R / 2);  // [N]
  float* S = win + N;
  constexpr int n_bins = N / 2 + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int f0 = blockIdx.x * FPB, b = blockIdx.y;
  const int span = (FPB - 1) * hop + N;
  const float* w = wav + (size_t)b * T;

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
    S[i] = v;
  }
  if (tid < R / 2) tw32[tid] = twiddles[R * R + tid];
  for (int i = tid; i < N; i += NT) win[i] = window[i];
  __syncthreads();

  float2* x = xbuf + warp * R * XROW;
  for (int pair = warp; 2 * pair < FPB; pair += NWARPS) {
    const int fa = f0 + 2 * pair;
    if (fa >= n_frames) break;
    const bool has_b = fa + 1 < n_frames;
    const float* sa = S + 2 * pair * hop + lane;
    float re[R], im[R];
#pragma unroll
    for (int n2 = 0; n2 < R; ++n2) {
      const float wn = win[lane + R * n2];
      re[n2] = sa[R * n2] * wn;
      im[n2] = has_b ? sa[hop + R * n2] * wn : 0.f;
    }
    // first pass over n2, then the twiddles W_1024^(n1 k2), written transposed
    fft32(re, im, tw32);
#pragma unroll
    for (int k2 = 0; k2 < R; ++k2) {
      const float2 t = __ldg(twiddles + k2 * R + lane);
      const float yr = re[bitrev5(k2)], yi = im[bitrev5(k2)];
      x[k2 * XROW + lane] = make_float2(yr * t.x - yi * t.y, yr * t.y + yi * t.x);
    }
    __syncwarp();
    // second pass over n1: lane k2 ends with bins k2 + 32 k1 in register bitrev5(k1)
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) {
      const float2 v = x[lane * XROW + n1];
      re[n1] = v.x;
      im[n1] = v.y;
    }
    __syncwarp();  // the buffer is free for the next pair
    fft32(re, im, tw32);

    // Z = A + iB with A, B the spectra of frames fa and fa + 1:
    //   A_k = (Z_k + conj Z_{N-k}) / 2,  B_k = (Z_k - conj Z_{N-k}) / 2i.
    // Bin N - k of bin k = k2 + 32 k1 is in lane (32 - k2) % 32, at k1' =
    // 31 - k1 (k2 > 0) or (32 - k1) % 32 (k2 = 0); each lane sends what its
    // partner needs.
    float* oa = out + ((size_t)b * n_frames + fa) * n_bins;
    float* ob = oa + n_bins;
    const int partner = (R - lane) & (R - 1);
#pragma unroll
    for (int k1 = 0; k1 <= N / 2 / R; ++k1) {
      const int mine = bitrev5(k1);
      const int give_0 = bitrev5((R - k1) & (R - 1)), give = bitrev5((R - 1 - k1) & (R - 1));
      const float sr = lane == 0 ? re[give_0] : re[give];
      const float si = lane == 0 ? im[give_0] : im[give];
      const float pr = __shfl_sync(0xffffffffu, sr, partner);
      const float pi = __shfl_sync(0xffffffffu, si, partner);
      const int k = lane + R * k1;
      if (k < n_bins) {
        const float zr = re[mine], zi = im[mine];
        const float ar = zr + pr, ai = zi - pi, br = zi + pi, bi = zr - pr;
        oa[k] = 0.5f * sqrtf(ar * ar + ai * ai);
        if (has_b) ob[k] = 0.5f * sqrtf(br * br + bi * bi);
      }
    }
  }
}

constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use on Hopper

int smem_bytes(int hop) {
  return (NWARPS * R * XROW + R / 2) * (int)sizeof(float2) + (N + (FPB - 1) * hop + N) * 4;
}

}  // namespace

// wav: [B, T] float32. window: [L] float32 (L == 1024). twiddles: [N_TW]
// float2, W_1024^(n1 k2) at [k2 * 32 + n1], then W_32^e for e < 16. out:
// [B, n_frames, L / 2 + 1] float32. 0 < pad < T.
extern "C" int stft_magnitude_fwd(const void* wav, const void* window, const void* twiddles,
                                  void* out, int B, int T, int L, int hop, int pad,
                                  int n_frames, void* stream) {
  if (L != N || hop < 1 || pad >= T || B < 1 || n_frames < 1) return (int)cudaErrorInvalidValue;
  // the largest block the card allows, set once per device: the attribute
  // is a ceiling, and setting it costs host time at every launch
  static bool allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !allowed[device]) {
    err = cudaFuncSetAttribute(stft_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) allowed[device] = true;
  }
  const int smem = smem_bytes(hop);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_frames + FPB - 1) / FPB, B);
  stft_fft_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(wav), static_cast<const float*>(window),
      static_cast<const float2*>(twiddles), static_cast<float*>(out), T, hop, pad, n_frames);
  return (int)cudaGetLastError();
}
