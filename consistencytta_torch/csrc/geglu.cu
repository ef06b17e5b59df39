// The UNet transformer's GEGLU activation for Hopper (sm_90a): one pass
// from the `proj` GEMM's output to the feed-forward's hidden state.
//
// Replaces no Pallas kernel: the JAX package leaves the GEGLU to XLA
// (consistencytta_tpu/nn/attention.py GEGLU), which fuses it into its
// neighbours. In PyTorch the port ran it as four passes over device memory:
// the gate half cast to float32 (a strided copy), torch's float32 gelu, the
// cast back to bf16, and a multiply of the two strided halves: 26 bytes
// moved per output element. This source computes, in one pass,
//   out[m, j] = bf16(float(h) * float(bf16(gelu(float(gate)))))
//   gelu(x)   = x * 0.5f * (1.0f + erff(x * M_SQRT1_2))
// with h = y[m, j] and gate = y[m, N + j] for y [M, 2N] bf16, contiguous,
// N a multiple of 8. The gelu is the exact (erf) one, in float32, written
// as PyTorch's CUDA gelu writes it, and it is rounded to bf16 before the
// product as the four passes round it, so the kernel computes what they
// compute: bit for bit where nvcc contracts the float32 arithmetic as
// PyTorch's build did.
//
// What bounds it on the H100: ~40 instructions an element (erff is most of
// them) against 6 bytes (read h and gate, write the product), far below
// the ridge point, so it is bound by the bytes it must move. The design
// serves that and nothing else:
//   - each thread takes VECS output vectors of 8 elements, a block's
//     threads neighbouring vectors, so a warp reads 512 contiguous bytes of
//     h, 512 of gate and writes 512 of out in each step;
//   - every access is a 16-byte vector: 8 h and the 8 gates of the same
//     row and columns, and one store;
//   - a thread issues all of its 2 x VECS loads before it computes, so each
//     SM keeps enough bytes in flight to cover the memory's latency (VECS =
//     2 at 44 registers: on an H100 the teacher's GEGLUs took 1.2% less
//     time than at VECS = 4, 64 registers, fewer threads an SM, and 1% more
//     than at VECS = 1);
//   - no shared memory, no synchronisation; the grid is ceil(M N / 8 /
//     (NT VECS)) blocks, from M and N alone.
// It allocates nothing (the wrapper, ops/geglu.py, allocates the output),
// launches on the caller's stream and reads only its arguments, so it
// captures into a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads a block
constexpr int VECS = 2;  // output vectors a thread, all loaded before any is computed
constexpr int EL = 8;    // bf16 elements in a 16-byte vector

// PyTorch's CUDA gelu (GeluType::None) on a float: the same expression in
// the same order, so that the same contraction gives the same bits
__device__ __forceinline__ float gelu(float x) {
  constexpr float kAlpha = M_SQRT1_2;
  return x * 0.5f * (1.0f + erff(x * kAlpha));
}

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two neighbouring elements (the low half of each word first)
__device__ __forceinline__ uint32_t geglu2(uint32_t h, uint32_t g) {
  const uint32_t gb = bits(__floats2bfloat162_rn(gelu(lo(g)), gelu(hi(g))));
  return bits(__floats2bfloat162_rn(lo(h) * lo(gb), hi(h) * hi(gb)));
}

__global__ void __launch_bounds__(NT) ctta_geglu_kernel(const uint4* __restrict__ y,
                                                         uint4* __restrict__ out,
                                                         uint32_t nv, uint32_t total) {
  // vectors: nv = N / 8 a row of out, total = M nv; y's rows hold 2 nv
  const uint32_t first = blockIdx.x * (NT * VECS) + threadIdx.x;
  uint4 h[VECS], g[VECS];
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const uint32_t v = first + i * NT;
    if (v < total) {
      const uint32_t row = v / nv;
      const uint4* src = y + (size_t)row * nv + v;  // row 2 nv + (v - row nv)
      h[i] = __ldg(src);
      g[i] = __ldg(src + nv);
    }
  }
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const uint32_t v = first + i * NT;
    if (v < total)
      out[v] = make_uint4(geglu2(h[i].x, g[i].x), geglu2(h[i].y, g[i].y),
                          geglu2(h[i].z, g[i].z), geglu2(h[i].w, g[i].w));
  }
}

}  // namespace

// y: [rows, 2 n] bf16, contiguous, 16-byte aligned; out: [rows, n] bf16,
// contiguous, 16-byte aligned; n a multiple of 8. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.
extern "C" int geglu_fwd(const void* y, void* out, long long rows, int n, void* stream) {
  if (rows < 1 || n < EL || n % EL || (uintptr_t)y % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const long long total = rows * (n / EL);
  if (total > 0xffffffffLL - NT * VECS) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + NT * VECS - 1) / (NT * VECS));
  ctta_geglu_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(y), static_cast<uint4*>(out), (uint32_t)(n / EL),
      (uint32_t)total);
  return (int)cudaGetLastError();
}
