// Normalisation for Hopper (sm_90a): GroupNorm, LayerNorm and RMSNorm of the
// port in one source.
//
// Replaces no Pallas kernel: the JAX package leaves its norms to XLA
// (consistencytta_tpu/nn/layers.py GroupNorm / LayerNorm, nn/t5.py), which
// fuses them into their neighbours. In PyTorch each norm of the port was a
// float32 copy of its bf16 input, torch's float32 statistics and affine
// kernels, a cast back to bf16 and, after most GroupNorms, a SiLU pass:
// about 24 bytes moved per element. This source computes, in one pass over
// device memory,
//   GroupNorm  y = act((x - mean_g) * rstd_g * w[c] + b[c]) over consecutive
//              channel groups of a contiguous [B, C, *spatial] tensor,
//   LayerNorm  y = (x - mean_r) * rstd_r * w[j] + b[j] over the last axis,
//   RMSNorm    y = x * rsqrt(mean_r(x^2) + eps) * w[j] over the last axis,
// with rstd = rsqrt(var + eps), var the biased variance, act the identity
// or SiLU (x / (1 + exp(-x))), statistics and affine in float32 and one
// rounding to the input's dtype (bf16 or float32) at the end.
//
// What bounds it on the H100: a few operations an element against one read
// and one write of it, far below the ridge point, so it is bound by the
// bytes it must move (the input read once, the output written once, the
// float32 affine). The design keeps every element in shared memory or
// registers between its read and its write, so device memory sees each
// byte once.
//
// Statistics are two-pass: the mean, then the sum of squared deviations
// from it, each a float32 sum. Where a group is split over several blocks,
// each block takes its part's (count, mean, M2) and the parts are merged
// with Chan's formula in rank order, so every block of the group gets the
// same bits, run after run.
//
// Design.
//   - ctta_norm_groups_kernel (GroupNorm): a row is one group, cpg channels x inner positions, contiguous
//     in memory. A thread-block cluster of `split` blocks (1 to 8) takes a
//     row; block r stages its chunk of the row in shared memory once with
//     16-byte cp.async copies (the unaligned ends element by element), takes
//     its part's count, mean and M2 from shared memory, and the cluster
//     exchanges the parts through distributed shared memory. The block then
//     normalises from shared memory and writes 16-byte vectors. So x is read
//     from device memory once, and a batch-1 call (32 groups) still fills
//     the card with 8 blocks a group. A chunk over the wrapper's
//     RESIDENT_BYTES (192 KB: groups over 1.5 MB, such as the float32 VAE
//     decoder's 8 x 65,536, 2 MB) is streamed through shared memory in
//     tiles, once per pass.
//   - ctta_norm_rows_kernel (LayerNorm, RMSNorm, up to 1280 wide): a block
//     stages R consecutive rows as one contiguous span (a row of 255 bf16
//     starts on a 2-byte boundary, so row-wise vector loads would not be
//     aligned), W warps take a row at a time into registers (E elements a
//     lane: a warp a row at E = 8, 16, 32 for rows up to 256, 512, 1024;
//     two warps a row at E = 20 for rows up to 1280, TANGO's level-2
//     transformer's, 5-12% faster than one warp at E = 40 on an H100),
//     reduce with shuffles (two warps add their partial sums through
//     shared memory), write the normalised row back into shared memory,
//     and the block stores the span with 16-byte vectors. A row of D
//     elements may hold n <= D true features followed by padding (the
//     UNet transformer's rows of 256 that hold 255): the statistics and
//     the affine take the first n, and the last D - n outputs are written
//     as 0, whatever the input holds there.
// Neither allocates anything; the wrapper (ops/norm.py) allocates the output
// and plans the launch (group_plan, rows_plan). Both capture into CUDA
// graphs: a launch reads only its arguments.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads a block
constexpr int NWARPS = NT / 32;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use on Hopper
constexpr int MAX_SPLIT = 8;      // blocks a cluster, the portable maximum

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements in 16 bytes
};

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// 16 bytes of shared memory to N floats, and N floats to 16 bytes
template <typename T>
__device__ __forceinline__ void unpack(const T* src, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 p = __bfloat1622float2(h[j]);
      f[2 * j] = p.x;
      f[2 * j + 1] = p.y;
    }
  } else {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 u;
  if constexpr (sizeof(T) == 2) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  } else {
    u = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                   __float_as_uint(f[3]));
  }
  return u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's sum, in the same order in every block; every thread calls it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < NWARPS; ++i) t += red[i];
  __syncthreads();
  return t;
}

// Elements [s, e) of x (element indices; x 16-byte aligned) into buf, whose
// first vector is the 16-byte vector that holds element s. Elements of the
// end vectors outside [s, e) are left as they were.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x, T* buf, long long s, long long e) {
  constexpr int N = Vec<T>::N;
  const long long va = s / N, vb = (e + N - 1) / N;
  for (long long v = va + threadIdx.x; v < vb; v += NT) {
    const long long g0 = v * N;
    T* dst = buf + (v - va) * N;
    if (g0 >= s && g0 + N <= e) {
      cp_async16(dst, x + g0);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (g0 + j >= s && g0 + j < e) dst[j] = x[g0 + j];
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

// SiLU, v / (1 + e^-v), with the fast exponential and division (2 ulps
// each): e^-v is held under 2^126, where __fdividef stays exact to them
template <bool SILU>
__device__ __forceinline__ float act(float v) {
  if constexpr (SILU) return __fdividef(v, 1.f + __expf(fminf(-v, 80.f)));
  return v;
}

// ---------------------------------------------------------------------------
// Rows of up to 32 * E * W elements: W warps a row, R rows a block.

// The sum over a row of the W warps that hold it, in the same order in each
// of them; with W > 1 the row's warps exchange their partial sums in red,
// one slot a warp, under a named barrier of the row's warps alone.
template <int W>
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (W == 1) {
    return v;
  } else {
    const int warp = threadIdx.x >> 5, first = warp - warp % W;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / W), "r"(32 * W) : "memory");
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) t += red[first + i];
    return t;
  }
}

template <typename T, bool RMS, int E, int W>
__global__ void __launch_bounds__(NT) ctta_norm_rows_kernel(
    const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ b, long long n_rows, int D, int n, int R, float eps) {
  static_assert(NWARPS % W == 0, "a block's warps in whole rows");
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  // two slots a warp, taken in turn by a warp's successive sums (a
  // LayerNorm's two a row, an RMSNorm's one): a warp rewrites a slot only
  // after passing the barrier of the sum after it, which the row's other
  // warps reach only once they have read the slot
  __shared__ float red[2][NWARPS];
  int sums = 0;
  T* buf = reinterpret_cast<T*>(smem);
  const long long r0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, n_rows - r0);
  const long long s = r0 * D, e = s + (long long)rows * D;
  stage(x, buf, s, e);
  const int lane = threadIdx.x & 31, part = (threadIdx.x >> 5) % W;
  const long long skew = s - (s / N) * N;  // buf index of element s
  for (int r = (threadIdx.x >> 5) / W; r < rows; r += NWARPS / W) {
    T* row = buf + skew + (long long)r * D;
    float v[E];
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = lane + 32 * (part + W * k);
      v[k] = j < n ? to_f(row[j]) : 0.f;
      acc += v[k];
    }
    float mean = 0.f;
    if constexpr (!RMS) {
      mean = row_sum<W>(acc, red[sums++ & 1]) / n;
      acc = 0.f;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const float d = lane + 32 * (part + W * k) < n ? v[k] - mean : 0.f;
        acc += d * d;
      }
    } else {
      acc = 0.f;
#pragma unroll
      for (int k = 0; k < E; ++k) acc += v[k] * v[k];
    }
    const float rstd = rsqrtf(row_sum<W>(acc, red[sums++ & 1]) / n + eps);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int j = lane + 32 * (part + W * k);
      if (j < n) {
        const float scale = w ? rstd * __ldg(w + j) : rstd;
        row[j] = from_f<T>(fmaf(v[k] - mean, scale, b ? __ldg(b + j) : 0.f));
      } else if (j < D) {
        row[j] = from_f<T>(0.f);
      }
    }
  }
  __syncthreads();
  const long long va = s / N, vb = (e + N - 1) / N;
  for (long long v = va + threadIdx.x; v < vb; v += NT) {
    const long long g0 = v * N;
    const T* src = buf + (v - va) * N;
    if (g0 >= s && g0 + N <= e) {
      *reinterpret_cast<uint4*>(y + g0) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (g0 + j >= s && g0 + j < e) y[g0 + j] = src[j];
    }
  }
}

// ---------------------------------------------------------------------------
// Groups: a cluster of `split` blocks a row of row_len elements; block r
// takes elements [r * chunk, (r + 1) * chunk) of it. The row's affine index
// of position p is (row % groups) * cpg + p / inner.

template <typename T, bool SILU>
__global__ void __launch_bounds__(NT) ctta_norm_groups_kernel(
    const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ b, long long row_len, long long chunk, long long tile, int groups,
    int cpg, int inner, float eps) {
  constexpr int N = Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  __shared__ float red[NWARPS];
  __shared__ float part[3];  // this block's count, mean, M2, read by the cluster
  __shared__ float stat[2];  // the row's mean and rstd

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long row = blockIdx.x / split;
  const long long rs = row * row_len, re = rs + row_len;
  const long long s = min(rs + rank * chunk, re), e = min(s + chunk, re);
  const bool resident = e - s <= tile;

  // body(t0, t1, buffer's first vector) over the chunk's tiles; a resident
  // chunk is staged once, before the first pass
  auto tiles = [&](auto&& body) {
    for (long long t0 = s; t0 < e; t0 += tile) {
      const long long t1 = min(t0 + tile, e);
      if (!resident) {
        __syncthreads();
        stage(x, buf, t0, t1);
      }
      body(t0, t1, resident ? s / N : t0 / N);
    }
  };
  auto vectors = [&](long long t0, long long t1, long long vbuf, auto&& f) {
    for (long long v = t0 / N + threadIdx.x; v < (t1 + N - 1) / N; v += NT) {
      float f8[N];
      unpack(buf + (v - vbuf) * N, f8);
      f(v * N, f8);
    }
  };
  if (resident) stage(x, buf, s, e);

  float acc = 0.f;
  tiles([&](long long t0, long long t1, long long vbuf) {
    vectors(t0, t1, vbuf, [&](long long g0, const float* f) {
      const bool full = g0 >= t0 && g0 + N <= t1;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (full || (g0 + j >= t0 && g0 + j < t1)) acc += f[j];
    });
  });
  const float total = block_sum(acc, red);
  const float mean = e > s ? total / (float)(e - s) : 0.f;
  acc = 0.f;
  tiles([&](long long t0, long long t1, long long vbuf) {
    vectors(t0, t1, vbuf, [&](long long g0, const float* f) {
      const bool full = g0 >= t0 && g0 + N <= t1;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (full || (g0 + j >= t0 && g0 + j < t1)) acc += (f[j] - mean) * (f[j] - mean);
    });
  });
  const float m2 = block_sum(acc, red);

  if (threadIdx.x == 0) {
    part[0] = (float)(e - s);
    part[1] = mean;
    part[2] = m2;
  }
  cluster.sync();
  if (threadIdx.x == 0) {
    float n = 0.f, m = 0.f, M2 = 0.f;
    for (int r = 0; r < split; ++r) {
      const float* p = cluster.map_shared_rank(part, r);
      const float nb = p[0];
      if (nb == 0.f) continue;
      const float nn = n + nb, d = p[1] - m;
      m += d * (nb / nn);
      M2 += p[2] + d * d * (n * nb / nn);
      n = nn;
    }
    stat[0] = m;
    stat[1] = rsqrtf(M2 / n + eps);
  }
  cluster.sync();  // the peers have read `part`; stat is visible to the block
  const float row_mean = stat[0], rstd = stat[1];
  const int cbase = (int)(row % groups) * cpg;

  // y = act((x - mean) * (rstd * w[c]) + b[c]); a whole vector inside one
  // channel takes its affine once
  auto affine = [&](int c, float& scale, float& shift) {
    scale = w ? rstd * __ldg(w + c) : rstd;
    shift = b ? __ldg(b + c) : 0.f;
  };
  tiles([&](long long t0, long long t1, long long vbuf) {
    vectors(t0, t1, vbuf, [&](long long g0, const float* f) {
      const bool full = g0 >= t0 && g0 + N <= t1;
      const long long lo = max(g0, t0);
      const int p = (int)(lo - rs);
      int q = p / inner, rem = p - q * inner;
      float o[N], scale, shift;
      if (full && rem + N <= inner) {
        affine(cbase + q, scale, shift);
#pragma unroll
        for (int j = 0; j < N; ++j) o[j] = act<SILU>(fmaf(f[j] - row_mean, scale, shift));
        *reinterpret_cast<uint4*>(y + g0) = pack<T>(o);
        return;
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        o[j] = 0.f;
        if (g0 + j < lo || g0 + j >= t1) continue;
        affine(cbase + q, scale, shift);
        o[j] = act<SILU>(fmaf(f[j] - row_mean, scale, shift));
        if (++rem == inner) {
          rem = 0;
          ++q;
        }
      }
      if (full) {
        *reinterpret_cast<uint4*>(y + g0) = pack<T>(o);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (g0 + j >= t0 && g0 + j < t1) y[g0 + j] = from_f<T>(o[j]);
      }
    });
  });
}

// The largest dynamic shared memory beside the kernel's static arrays,
// allowed once per kernel and device: the attribute is a ceiling, and
// setting it costs host time at every launch.
template <auto Kernel>
cudaError_t allow_smem() {
  static bool allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && allowed[device]) return cudaSuccess;
  cudaFuncAttributes attrs;
  err = cudaFuncGetAttributes(&attrs, Kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX - (int)attrs.sharedSizeBytes);
  if (err == cudaSuccess && device < 64) allowed[device] = true;
  return err;
}

template <typename T, bool RMS, int E, int W>
int launch_rows(const void* x, void* y, const void* w, const void* b, long long n_rows, int D,
                int n, int R, float eps, cudaStream_t stream) {
  constexpr auto kernel = ctta_norm_rows_kernel<T, RMS, E, W>;
  if (D > 32 * E * W) return (int)cudaErrorInvalidValue;  // wider than the instantiation holds
  cudaError_t err = allow_smem<kernel>();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ((size_t)R * D + 2 * Vec<T>::N) * sizeof(T);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const long long grid = (n_rows + R - 1) / R;
  kernel<<<(unsigned)grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const float*>(w),
      static_cast<const float*>(b), n_rows, D, n, R, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool SILU>
int launch_groups(const void* x, void* y, const void* w, const void* b, long long n_rows,
                  long long row_len, long long chunk, long long tile, int split, int groups,
                  int cpg, int inner, float eps, cudaStream_t stream) {
  constexpr auto kernel = ctta_norm_groups_kernel<T, SILU>;
  cudaError_t err = allow_smem<kernel>();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ((size_t)tile + 2 * Vec<T>::N) * sizeof(T);
  if (smem > (size_t)SMEM_MAX - 1024) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_rows * split), 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<T*>(y),
                           static_cast<const float*>(w), static_cast<const float*>(b), row_len,
                           chunk, tile, groups, cpg, inner, eps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instantiation `held` of ops/norm.py:ROWS_WIDTHS, which
// rows_instantiation picks: a warp a row at E = 8, 16, 32 (rows up to 256,
// 512, 1024), two warps a row at E = 20 (up to 1280). An unknown index, or
// a row wider than the instantiation holds, is an error.
template <typename T, bool RMS>
int rows_width_dispatch(int held, const void* x, void* y, const void* w, const void* b,
                        long long n_rows, int D, int n, int R, float eps, cudaStream_t s) {
  switch (held) {
    case 0: return launch_rows<T, RMS, 8, 1>(x, y, w, b, n_rows, D, n, R, eps, s);
    case 1: return launch_rows<T, RMS, 16, 1>(x, y, w, b, n_rows, D, n, R, eps, s);
    case 2: return launch_rows<T, RMS, 32, 1>(x, y, w, b, n_rows, D, n, R, eps, s);
    case 3: return launch_rows<T, RMS, 20, 2>(x, y, w, b, n_rows, D, n, R, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int rows_dispatch(int held, const void* x, void* y, const void* w, const void* b, int rms,
                  long long n_rows, int D, int n, int R, float eps, cudaStream_t s) {
  if (rms) return rows_width_dispatch<T, true>(held, x, y, w, b, n_rows, D, n, R, eps, s);
  return rows_width_dispatch<T, false>(held, x, y, w, b, n_rows, D, n, R, eps, s);
}

template <typename T>
int groups_dispatch(const void* x, void* y, const void* w, const void* b, int silu,
                    long long n_rows, long long row_len, long long chunk, long long tile,
                    int split, int groups, int cpg, int inner, float eps, cudaStream_t s) {
  if (silu)
    return launch_groups<T, true>(x, y, w, b, n_rows, row_len, chunk, tile, split, groups, cpg,
                                  inner, eps, s);
  return launch_groups<T, false>(x, y, w, b, n_rows, row_len, chunk, tile, split, groups, cpg,
                                 inner, eps, s);
}

}  // namespace

// x, y: [n_rows, D] contiguous, 16-byte aligned; dtype 0 bf16, 1 float32.
// Each row's first n features (1 <= n <= D) are normalised; its last D - n
// outputs are 0. w, b: [n] float32 or null (no scale, no shift). R rows a
// block. rms: y = x * rsqrt(mean(x^2) + eps) * w, else the LayerNorm.
// held: the instantiation that takes the rows (rows_width_dispatch), which
// must hold D.
extern "C" int norm_rows_fwd(const void* x, void* y, const void* w, const void* b, int dtype,
                             int rms, long long n_rows, int D, int n, int R, float eps,
                             int held, void* stream) {
  if (n_rows < 1 || D < 1 || n < 1 || n > D || R < 1 || (uintptr_t)x % 16 ||
      (uintptr_t)y % 16 || (n_rows + R - 1) / R > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return rows_dispatch<__nv_bfloat16>(held, x, y, w, b, rms, n_rows, D, n, R, eps, s);
  if (dtype == 1) return rows_dispatch<float>(held, x, y, w, b, rms, n_rows, D, n, R, eps, s);
  return (int)cudaErrorInvalidValue;
}

// x, y: [n_rows, row_len] contiguous, 16-byte aligned; dtype 0 bf16, 1
// float32. Row r's position p takes w[c], b[c] (float32 or null) with
// c = (r % groups) * cpg + p / inner. A cluster of `split` (1 to 8) blocks a
// row, `chunk` elements a block (a multiple of 16 bytes, split * chunk >=
// row_len); `tile` elements of shared memory a block (a multiple of 16
// bytes; chunk <= tile keeps the chunk resident). silu: SiLU after the
// affine.
extern "C" int norm_groups_fwd(const void* x, void* y, const void* w, const void* b, int dtype,
                               int silu, long long n_rows, long long row_len,
                               long long chunk, long long tile, int split, int groups, int cpg,
                               int inner, float eps, void* stream) {
  const int n = dtype == 0 ? 8 : 4;
  if (n_rows < 1 || row_len < 1 || row_len > 0x7fffffffLL || split < 1 || split > MAX_SPLIT ||
      chunk < 1 || chunk % n || tile < n || tile % n || chunk * split < row_len || groups < 1 ||
      cpg < 1 || inner < 1 || (long long)cpg * inner != row_len ||
      n_rows * split > 0x7fffffffLL || (uintptr_t)x % 16 || (uintptr_t)y % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return groups_dispatch<__nv_bfloat16>(x, y, w, b, silu, n_rows, row_len, chunk, tile, split,
                                          groups, cpg, inner, eps, s);
  if (dtype == 1)
    return groups_dispatch<float>(x, y, w, b, silu, n_rows, row_len, chunk, tile, split, groups,
                                  cpg, inner, eps, s);
  return (int)cudaErrorInvalidValue;
}
