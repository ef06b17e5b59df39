// STFT magnitude for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces the JAX package's Pallas kernel
//   consistencytta_tpu/ops/pallas_stft.py:stft_magnitude_pallas (_stft_kernel),
// which computes, for a [B, T] float32 waveform, the reflect-padded framed
// real DFT against a windowed basis and its magnitude,
//   out[b, f, k] = | sum_n wavpad[b, f*hop + n] * w[n] * e^{-2 pi i k n / N} |,
// for bins k = 0..N/2, without ever writing the overlapping frames to device
// memory. The windowed basis of the frontend is exactly the window times the
// DFT (ops/mel.py:real_dft_basis), so the kernel takes the window and
// computes the DFT as an FFT. Two filter lengths are built: N = 1024, the
// training frontend's, and N = 512, the evaluation frontend's (hop 160, 257
// bins); any other length is refused.
//
// What bounds it on the H100: a complex FFT of two frames does about
// 5 N log2 N operations (51,200 at N = 1024, 23,040 at 512), against 640
// bytes of new waveform read a frame (hop 160) and 4 (N / 2 + 1) bytes of
// magnitudes written: ~10 and ~6 operations a byte, below the ~20 a byte at
// which the FP32 rate (67 TFLOP/s) and the memory (3.35 TB/s) balance. It is
// bound by the bytes it must move (read the waveform once, write the
// magnitudes once).
//
// Design. One block of 8 warps takes FPB consecutive frames of one batch row
// (32 at N = 1024, 64 at N = 512, where a frame's span is half as long). It
// stages the span of the padded waveform those frames cover,
// (FPB - 1) * hop + N samples, in shared memory once, doing the reflect
// padding by index arithmetic while it loads. A warp takes two frames as one
// complex sequence (frame f the real part, frame f + 1 the imaginary part)
// and runs an N-point complex FFT on it as 32 x Q (the four-step FFT, Q =
// N / 32): lane n1 takes the Q samples n1 + 32 n2 (times the window, staged
// in shared memory beside the span), runs a radix-2 Q-point FFT on them in
// registers, multiplies by the twiddles W_N^(n1 k2) and writes the result
// transposed to a per-warp exchange buffer (rows of 33 to keep the banks
// apart). At N = 1024 (Q = 32) the warp holds one pair; at N = 512 (Q = 16)
// it holds two pairs at once, each lane running the first pass of both, so
// that both layouts fill the 32 x 32 exchange buffer: row g Q + k2 is pair
// g's k2. Lane l then reads row l and runs a 32-point FFT over n1, which
// leaves bins k2 + Q k1 of pair l / Q in its registers. The two real spectra
// of a pair are separated with the conjugate-symmetry identity: bin N - k of
// the same pair lives in lane g Q + (Q - k2) mod Q, one shuffle away. Each
// lane takes the magnitude in fp32 and stores it, Q consecutive bins a pair.
//
// Precision: all arithmetic is fp32 (no fast-math, no __sinf); the twiddles
// come from a table the host builds once in float64 and rounds to float32
// (ops/stft.py:fft_twiddles). An fp32 FFT is accurate to about eps * log2 N
// of the spectrum's RMS.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 32;         // lanes a warp; the radix of the second pass
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int XROW = R + 1;   // float2 a row of the exchange buffer

template <int BITS>
__host__ __device__ constexpr int bitrev(int x) {
  int r = 0;
  for (int i = 0; i < BITS; ++i) r |= ((x >> i) & 1) << (BITS - 1 - i);
  return r;
}

template <int M>
__host__ __device__ constexpr int log2i() {
  if constexpr (M <= 1) return 0;
  else return 1 + log2i<M / 2>();
}

// The shape of the N-point transform: 32 x Q with Q = N / 32, G = 32 / Q
// frame pairs a warp at once, FPB frames a block.
template <int N>
struct Plan {
  static_assert(N == 512 || N == 1024, "K4 is built for N = 512 and 1024");
  static constexpr int Q = N / R;
  static constexpr int G = R / Q;
  static constexpr int FPB = N == 1024 ? 32 : 64;
  static constexpr int N_BINS = N / 2 + 1;
};

// One radix-2 decimation-in-frequency stage of an M-point FFT over
// butterflies HALF apart (every index a constant, so the arrays stay in
// registers). tw32[e] is W_32^e for e < 16, and W_M^e = W_32^(e 32 / M); the
// multiplications by 1 and -i are done exactly.
template <int M, int HALF>
__device__ __forceinline__ void fft_stage(float (&re)[M], float (&im)[M], const float2* tw32) {
  constexpr int STRIDE = (M / 2) / HALF;
#pragma unroll
  for (int base = 0; base < M; base += 2 * HALF) {
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
      } else if (e == M / 4) {  // W_M^(M/4) = -i
        re[b] = vi;
        im[b] = -vr;
      } else {
        const float2 w = tw32[e * (R / M)];
        re[b] = vr * w.x - vi * w.y;
        im[b] = vr * w.y + vi * w.x;
      }
    }
  }
}

// In-place radix-2 FFT of M complex values in registers: natural order in,
// bin k out in register bitrev(k).
template <int M, int HALF = M / 2>
__device__ __forceinline__ void fft(float (&re)[M], float (&im)[M], const float2* tw32) {
  fft_stage<M, HALF>(re, im, tw32);
  if constexpr (HALF > 1) fft<M, HALF / 2>(re, im, tw32);
}

template <int N>
__global__ void __launch_bounds__(NT, 2)
stft_fft_kernel(const float* __restrict__ wav, const float* __restrict__ window,
                const float2* __restrict__ twiddles, float* __restrict__ out, int T,
                int hop, int pad, int n_frames) {
  using P = Plan<N>;
  constexpr int Q = P::Q, G = P::G, FPB = P::FPB, n_bins = P::N_BINS;
  constexpr int QBITS = log2i<Q>(), RBITS = log2i<R>();
  extern __shared__ __align__(16) unsigned char smem[];
  float2* xbuf = reinterpret_cast<float2*>(smem);  // [NWARPS][R][XROW]
  float2* tw32 = xbuf + NWARPS * R * XROW;         // [R / 2]
  float* win = reinterpret_cast<float*>(tw32 + R / 2);  // [N]
  float* S = win + N;
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
  if (tid < R / 2) tw32[tid] = twiddles[Q * R + tid];
  for (int i = tid; i < N; i += NT) win[i] = window[i];
  __syncthreads();

  float2* x = xbuf + warp * R * XROW;
  // a warp takes G pairs (2 G frames) an iteration
  for (int it = warp; 2 * G * it < FPB; it += NWARPS) {
    const int fl = 2 * G * it;  // the iteration's first frame in the block
    if (f0 + fl >= n_frames) break;
    // first pass over n2 for each pair, then the twiddles W_N^(n1 k2),
    // written transposed: row g Q + k2, column n1 = lane
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const bool has_b = f0 + fl + 2 * g + 1 < n_frames;
      const float* sa = S + (fl + 2 * g) * hop + lane;
      float re[Q], im[Q];
#pragma unroll
      for (int n2 = 0; n2 < Q; ++n2) {
        const float wn = win[lane + R * n2];
        re[n2] = sa[R * n2] * wn;
        im[n2] = has_b ? sa[hop + R * n2] * wn : 0.f;
      }
      fft<Q>(re, im, tw32);
#pragma unroll
      for (int k2 = 0; k2 < Q; ++k2) {
        const float2 t = __ldg(twiddles + k2 * R + lane);
        const float yr = re[bitrev<QBITS>(k2)], yi = im[bitrev<QBITS>(k2)];
        x[(g * Q + k2) * XROW + lane] = make_float2(yr * t.x - yi * t.y, yr * t.y + yi * t.x);
      }
    }
    __syncwarp();
    // second pass over n1: lane l = g Q + k2 ends with bins k2 + Q k1 of
    // pair g in register bitrev(k1)
    float re[R], im[R];
#pragma unroll
    for (int n1 = 0; n1 < R; ++n1) {
      const float2 v = x[lane * XROW + n1];
      re[n1] = v.x;
      im[n1] = v.y;
    }
    __syncwarp();  // the buffer is free for the next iteration
    fft<R>(re, im, tw32);

    // Z = A + iB with A, B the spectra of frames fa and fa + 1:
    //   A_k = (Z_k + conj Z_{N-k}) / 2,  B_k = (Z_k - conj Z_{N-k}) / 2i.
    // Bin N - k of bin k = k2 + Q k1 is in lane g Q + (Q - k2) % Q, at k1' =
    // 31 - k1 (k2 > 0) or (32 - k1) % 32 (k2 = 0); each lane sends what its
    // partner needs.
    const int g = lane / Q, k2 = lane % Q;
    const int fa = f0 + fl + 2 * g;
    const bool has_a = fa < n_frames, has_b = fa + 1 < n_frames;
    float* oa = out + ((size_t)b * n_frames + fa) * n_bins;
    float* ob = oa + n_bins;
    const int partner = g * Q + ((Q - k2) & (Q - 1));
#pragma unroll
    for (int k1 = 0; k1 <= N / 2 / Q; ++k1) {
      const int mine = bitrev<RBITS>(k1);
      const int give_0 = bitrev<RBITS>((R - k1) & (R - 1));
      const int give = bitrev<RBITS>((R - 1 - k1) & (R - 1));
      const float sr = k2 == 0 ? re[give_0] : re[give];
      const float si = k2 == 0 ? im[give_0] : im[give];
      const float pr = __shfl_sync(0xffffffffu, sr, partner);
      const float pi = __shfl_sync(0xffffffffu, si, partner);
      const int k = k2 + Q * k1;
      if (k < n_bins && has_a) {
        const float zr = re[mine], zi = im[mine];
        const float ar = zr + pr, ai = zi - pi, br = zi + pi, bi = zr - pr;
        oa[k] = 0.5f * sqrtf(ar * ar + ai * ai);
        if (has_b) ob[k] = 0.5f * sqrtf(br * br + bi * bi);
      }
    }
  }
}

constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use on Hopper

template <int N>
int smem_bytes(int hop) {
  return (NWARPS * R * XROW + R / 2) * (int)sizeof(float2) +
         (N + (Plan<N>::FPB - 1) * hop + N) * 4;
}

template <int N>
int launch(const void* wav, const void* window, const void* twiddles, void* out, int B, int T,
           int hop, int pad, int n_frames, void* stream) {
  // the largest block the card allows, set once per device: the attribute
  // is a ceiling, and setting it costs host time at every launch
  static bool allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !allowed[device]) {
    err = cudaFuncSetAttribute(stft_fft_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) allowed[device] = true;
  }
  const int smem = smem_bytes<N>(hop);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  constexpr int FPB = Plan<N>::FPB;
  const dim3 grid((n_frames + FPB - 1) / FPB, B);
  stft_fft_kernel<N><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(wav), static_cast<const float*>(window),
      static_cast<const float2*>(twiddles), static_cast<float*>(out), T, hop, pad, n_frames);
  return (int)cudaGetLastError();
}

}  // namespace

// wav: [B, T] float32. window: [L] float32 (L == 512 or 1024). twiddles:
// float2, W_L^(n1 k2) at [k2 * 32 + n1] for k2 < L / 32, then W_32^e for
// e < 16. out: [B, n_frames, L / 2 + 1] float32. 0 < pad < T.
extern "C" int stft_magnitude_fwd(const void* wav, const void* window, const void* twiddles,
                                  void* out, int B, int T, int L, int hop, int pad,
                                  int n_frames, void* stream) {
  if (hop < 1 || pad >= T || B < 1 || n_frames < 1) return (int)cudaErrorInvalidValue;
  if (L == 1024)
    return launch<1024>(wav, window, twiddles, out, B, T, hop, pad, n_frames, stream);
  if (L == 512)
    return launch<512>(wav, window, twiddles, out, B, T, hop, pad, n_frames, stream);
  return (int)cudaErrorInvalidValue;
}
