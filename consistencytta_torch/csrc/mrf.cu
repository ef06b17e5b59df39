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
// What bounds it on the H100: fused, the level reads x once and writes y
// once against 6 * 21 * 2 * C^2 operations a sample, so it is bound by
// operations, and only wgmma reaches the tensor cores' full rate. The convs
// run as per-tap matrix products: positions x (tap, input channel) against
// (tap, input channel) x output channels, K = k * C deep.
//
// Design. One block takes T output positions of one batch row (a block per
// tile; with the intermediates in a device workspace, a block loops over
// tiles). Each ResBlock recomputes a halo of H_k = sum_d (d + 1)(k - 1)/2
// positions on each side (60 for k = 11), so that every conv of the chain
// has its whole receptive field in the block and no intermediate leaves it.
// The block is two consumer warpgroups and a producer warpgroup (setmaxnreg
// moves the producer's registers to the consumers; ptxas compiles the whole
// kernel at 168 a thread, which bounds the accumulators a consumer holds:
// products committed two 16-deep steps at a time spilled and ran slower):
//   - One producer thread keeps a ring of STAGES weight units full by TMA,
//     each unit CO = min(C, 128) output channels x 64 reduction values (one
//     tap x 64 input channels, or two taps x 32 at C = 32) of one conv,
//     128-byte swizzled, in the order the consumers take them (conv by conv
//     of the whole tile), so the next conv's first units load during this
//     conv's epilogue. The 18 weights are packed once per weight version by
//     the host (ops/mrf.py:packed_weights) as [18 * C_out][taps * C_in],
//     K-major.
//   - The consumers hold the accumulators of EVERY row of the conv's output
//     range: warpgroup w takes the 64-row m-tiles w, w + 2, ... (MT each:
//     6, 4, 2 at C = 32, 64, >= 128), so every staged weight unit feeds all
//     rows of the block and is read from L2 once per tile, not once per
//     round of rows. Per 16 reduction values a warp loads its A fragment (16
//     positions x 16 channels) with ldmatrix at rows shifted by t * d, which
//     a swizzled descriptor cannot address, and issues wgmma with A from
//     registers and the weight unit as B (N = CO). A fragments are
//     double-buffered, so the next step's ldmatrix runs while this step's
//     products are in flight; no block-wide barrier sits in the reduction,
//     only the ring's mbarriers. Every m-tile is computed whether or not the
//     conv's range reaches it: ptxas serialises a wgmma under a branch.
//   - Two buffers, position-major ([pos][C + 8]: channels contiguous, the
//     8-element pad puts the rows of an ldmatrix on distinct banks): X, the
//     residual xb, and A, the next conv's input already through its leaky
//     relu, so the relu is applied once per element, in an epilogue, not at
//     every tap. A conv's result overwrites A in place once both warpgroups
//     are done reading it; the second conv of a pair adds into X and writes
//     lrelu(X) to A. The epilogue (bias, bf16 rounding, leaky relu, edge
//     mask, residual) works on the accumulator registers. With one output
//     pass (C <= 128) the buffers live in shared memory (T = 656, 400, 144
//     at C = 32, 64, 128); wider levels take several passes over the input,
//     so a third buffer takes the result and the buffers live in a device
//     workspace, where the A fragments come from plain loads.
//   - x is staged with 16-byte loads and a transposing store; y, which holds
//     the running bf16 sum of the three ResBlocks, is read and written with
//     16-byte accesses, four in flight a thread.
// Known gaps: the halo is recomputed (T + 2 H_k rows for T outputs; at C =
// 128 the accumulators of 256 rows bound T to 144), the epilogues leave the
// tensor cores idle, and the weights are streamed once per tile from L2 (no
// cluster multicast, no persistent grid).

#include "hopper_async.cuh"

// Kernel sizes of the three ResBlocks and their dilations, by value.
struct MrfPlan {
  int ks[3];
  int dil[3][3];
};

namespace {

constexpr int NCW = 2;                 // consumer warpgroups
constexpr int NT = (NCW + 1) * 128;    // and the producer's
constexpr int PRODUCER_REGS = 40;      // registers a thread after setmaxnreg:
constexpr int CONSUMER_REGS = 232;     // (2 * 232 + 40) * 128 <= 65536
constexpr int STAGES = 4;           // weight units in the ring
constexpr int KU = 64;              // reduction values a weight unit
constexpr int ROW_BYTES = 128;      // one 64-value row of a unit
constexpr int BAR_BYTES = 128;      // the ring's mbarriers

__device__ __forceinline__ bf16 lrelu(bf16 v, float slope) {
  const float f = __bfloat162float(v);
  return f > 0.f ? v : __float2bfloat16(f * slope);
}

__device__ __forceinline__ bf16 badd(bf16 a, bf16 b) {
  return __float2bfloat16(__bfloat162float(a) + __bfloat162float(b));
}

// The same on pairs: the sum and the product by the slope in fp32, each
// rounded once to bf16, as the plain chain's bf16 tensor ops round them.
__device__ __forceinline__ __nv_bfloat162 badd2(__nv_bfloat162 a, __nv_bfloat162 b) {
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return __floats2bfloat162_rn(fa.x + fb.x, fa.y + fb.y);
}

__device__ __forceinline__ __nv_bfloat162 lrelu2(__nv_bfloat162 v, float slope) {
  const float2 f = __bfloat1622float2(v);
  const __nv_bfloat162 n = __floats2bfloat162_rn(f.x * slope, f.y * slope);
  return __halves2bfloat162(f.x > 0.f ? v.x : n.x, f.y > 0.f ? v.y : n.y);
}

__device__ __forceinline__ void wgmma_rs_k(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_kmajor_n32(d, a, b);
}
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_kmajor_n64(d, a, b);
}
__device__ __forceinline__ void wgmma_rs_k(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_kmajor_n128(d, a, b);
}

struct Ring {
  uint64_t full[STAGES], empty[STAGES];
};

// A fragment of 16 positions x 16 channels of `in` ([rows][ld] bf16):
// positions r0 .. r0 + 15 (clamped below `rows`: the rows past a conv's
// range are computed but never stored), channels c0 .. c0 + 15.
template <bool SMEM>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* in, int ld, int r0,
                                       int c0, int rows, int lane) {
  if (SMEM) {
    const int r = min(r0 + (lane & 15), rows - 1);
    ldsm_x4(a, in + (size_t)r * ld + c0 + (lane >> 4) * 8);
  } else {
    const int g = lane >> 2, t4 = lane & 3;
    const int ra = min(r0 + g, rows - 1), rb = min(r0 + g + 8, rows - 1);
    const bf16* pa = in + (size_t)ra * ld + c0 + 2 * t4;
    const bf16* pb = in + (size_t)rb * ld + c0 + 2 * t4;
    a[0] = *reinterpret_cast<const uint32_t*>(pa);
    a[1] = *reinterpret_cast<const uint32_t*>(pb);
    a[2] = *reinterpret_cast<const uint32_t*>(pa + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(pb + 8);
  }
}

// What a consumer thread knows of its block.
struct Consumer {
  bf16* X;  // the residual xb, [rows][ld]
  bf16* A;  // the next conv's input, already through its leaky relu
  bf16* O;  // where the conv's result goes: A itself (in place) or a third buffer
  Ring* ring;
  uint64_t desc0;  // wgmma descriptor of stage 0
  int ld, rows, C, L, g0, wg, wq, lane;
  float slope;
  uint32_t it;  // weight units consumed so far
};

// One conv of the chain over output rows [lo, hi) of the block's extent:
//   FIRST:  O[j] = mask(lrelu(bf16(sum_t W[t] . A[j - p + t*d]) + b))
//   !FIRST: X[j] += mask(bf16(sum_t W[t] . A[j - p + t]) + b); O[j] = lrelu(X[j])
// then O is the next conv's A. With the buffers in shared memory the width
// is one pass (C == CO) and O is A: the result overwrites the input once
// both warpgroups are done reading it. In the workspace, O is a third
// buffer and the two swap.
template <int CO, int MT, bool FIRST, bool SMEM>
__device__ __forceinline__ void conv_stage(Consumer& cs, int lo, int hi, int k, int d,
                                           const bf16* __restrict__ bias) {
  constexpr int NACC = CO / 2;
  constexpr int UNIT_BYTES = CO * ROW_BYTES;
  const int C = cs.C, ld = cs.ld;
  const int n_units = (k * C + KU - 1) / KU;
  const int p = d * (k - 1) / 2;
  const int n_mt = (hi - lo + 63) / 64;
  const int g = cs.lane >> 2, t4 = cs.lane & 3;

  for (int co0 = 0; co0 < C; co0 += CO) {
    // this thread's bias pairs (columns co0 + 8 n + 2 t4), loaded before the
    // products so that the epilogue does not wait for them
    __nv_bfloat162 bias2[CO / 8];
#pragma unroll
    for (int n = 0; n < CO / 8; ++n)
      bias2[n] = *reinterpret_cast<const __nv_bfloat162*>(bias + co0 + 8 * n + 2 * t4);
    float acc[MT][NACC];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[m][i] = 0.f;
    uint32_t a[2][MT][4];
    int prev = 0;
    for (int u = 0; u < n_units; ++u) {
      const int stage = cs.it % STAGES;
      mbar_wait(&cs.ring->full[stage], (cs.it / STAGES) & 1);
      const uint64_t bdesc = cs.desc0 + stage * (UNIT_BYTES >> 4);
#pragma unroll
      for (int s = 0; s < KU / 16; ++s) {
        // reduction index: tap * C + input channel. Past the last tap (k * C
        // is not a multiple of 64 at C = 32) the weights are zero; the A
        // rows of the last tap, which hold finite values, stand in.
        const int kk = u * KU + s * 16;
        const int t = min(kk / C, k - 1), c0 = kk % C;
        const int r0 = lo - p + t * d + 16 * cs.wq;
        // every m-tile is computed, whether or not the range reaches it: a
        // product under a branch would be serialised by ptxas. The rows past
        // the range read clamped rows and are never stored.
#pragma unroll
        for (int m = 0; m < MT; ++m)
          load_a<SMEM>(a[s & 1][m], cs.A, ld, r0 + 64 * (cs.wg + NCW * m), c0, cs.rows,
                       cs.lane);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < MT; ++m) wgmma_rs_k(acc[m], a[s & 1][m], bdesc + 2 * s);
        wgmma_commit();
        wgmma_wait<1>();             // the previous step's products are done ...
        fence_regs(a[(s + 1) & 1]);  // ... and its A registers free
        if (s == 0 && u > 0 && cs.lane == 0) mbar_arrive(&cs.ring->empty[prev]);
      }
      prev = stage;
      ++cs.it;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
    fence_regs(a[0]);
    fence_regs(a[1]);
    if (cs.lane == 0) mbar_arrive(&cs.ring->empty[prev]);
    if (SMEM) named_bar_sync<NCW * 128>(1);  // both warpgroups are done reading A

    // epilogue on the accumulator registers: register i of an m-tile holds
    // row g + 8 * ((i >> 1) & 1) of the warp's 16, column 8 * (i >> 2) + 2 * t4 + (i & 1).
    // A row's residual pairs are all loaded before any store.
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int mt = cs.wg + NCW * m;
      if (mt >= n_mt) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = lo + 64 * mt + 16 * cs.wq + g + 8 * r;
        if (j >= hi) continue;
        const int gpos = cs.g0 + j;
        const bool inside = gpos >= 0 && gpos < cs.L;
        const size_t base = (size_t)j * ld + co0 + 2 * t4;
        __nv_bfloat162* xrow = reinterpret_cast<__nv_bfloat162*>(cs.X + base);
        __nv_bfloat162* orow = reinterpret_cast<__nv_bfloat162*>(cs.O + base);
        __nv_bfloat162 xv[CO / 8];
        if (!FIRST) {
#pragma unroll
          for (int n = 0; n < CO / 8; ++n) xv[n] = xrow[4 * n];
        }
#pragma unroll
        for (int n = 0; n < CO / 8; ++n) {
          __nv_bfloat162 v = badd2(
              __floats2bfloat162_rn(acc[m][4 * n + 2 * r], acc[m][4 * n + 2 * r + 1]), bias2[n]);
          if (!inside) v = __floats2bfloat162_rn(0.f, 0.f);
          if (FIRST) {
            orow[4 * n] = lrelu2(v, cs.slope);
          } else {
            const __nv_bfloat162 sum = badd2(xv[n], v);
            xrow[4 * n] = sum;
            orow[4 * n] = lrelu2(sum, cs.slope);
          }
        }
      }
    }
  }
  named_bar_sync<NCW * 128>(1);  // this conv's output is visible to both warpgroups
  if (!SMEM) {
    bf16* t = cs.A;
    cs.A = cs.O;
    cs.O = t;
  }
}

// plan.ks[rb] and plan.dil[rb][i] by constant indices: indexing the
// parameter by a variable copies it to local memory, and ptxas then takes
// every value derived from it (loop bounds around the wgmma) as divergent
// and serialises the products
__device__ __forceinline__ int kernel_size(const MrfPlan& plan, int rb) {
  return rb == 0 ? plan.ks[0] : rb == 1 ? plan.ks[1] : plan.ks[2];
}

__device__ __forceinline__ int dilation(const MrfPlan& plan, int rb, int i) {
  const int d0 = rb == 0 ? plan.dil[0][0] : rb == 1 ? plan.dil[1][0] : plan.dil[2][0];
  const int d1 = rb == 0 ? plan.dil[0][1] : rb == 1 ? plan.dil[1][1] : plan.dil[2][1];
  const int d2 = rb == 0 ? plan.dil[0][2] : rb == 1 ? plan.dil[1][2] : plan.dil[2][2];
  return i == 0 ? d0 : i == 1 ? d1 : d2;
}

struct __align__(16) Pack8 {
  bf16 v[8];
};

template <int CO, int MT, bool SMEM>
__global__ void __launch_bounds__(NT, 1)
mrf_level_kernel(const __grid_constant__ CUtensorMap map_w, const bf16* __restrict__ x,
                 bf16* __restrict__ y, const bf16* __restrict__ bias, bf16* workspace,
                 MrfPlan plan, int B, int C_in, int L, int T, int rows, float slope) {
  constexpr int UNIT_BYTES = CO * ROW_BYTES;
  const int C = SMEM ? CO : C_in;  // one pass: a constant, which the index arithmetic uses
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  Ring* ring = reinterpret_cast<Ring*>(smem + STAGES * UNIT_BYTES);
  const int ld = C + 8;
  const size_t buf = (size_t)rows * ld;
  const int n_tiles = (L + T - 1) / T;
  const int n_work = B * n_tiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&ring->full[s], 1);
      mbar_init(&ring->empty[s], NCW * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCW * 128) {
    // producer: the weight units of every conv of every tile, in order
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == NCW * 128) {
      uint32_t it = 0;
      for (int work = blockIdx.x; work < n_work; work += gridDim.x)
        for (int rb = 0; rb < 3; ++rb)
          for (int i = 0; i < 6; ++i) {
            const int conv = rb * 6 + i, units = (kernel_size(plan, rb) * C + KU - 1) / KU;
            for (int co0 = 0; co0 < C; co0 += CO)
              for (int u = 0; u < units; ++u, ++it) {
                const int stage = it % STAGES;
                mbar_wait(&ring->empty[stage], ((it / STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(&ring->full[stage], UNIT_BYTES);
                tma_load_2d(smem + stage * UNIT_BYTES, &map_w, &ring->full[stage], u * KU,
                            conv * C + co0);
              }
          }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  Consumer cs;
  bf16* base = SMEM ? reinterpret_cast<bf16*>(smem + STAGES * UNIT_BYTES + BAR_BYTES)
                    : workspace + (size_t)blockIdx.x * 3 * buf;
  cs.X = base;
  cs.A = base + buf;
  cs.O = SMEM ? cs.A : base + 2 * buf;
  cs.ring = ring;
  cs.desc0 = wgmma_desc(smem_u32(smem), 16, 1024);
  cs.ld = ld;
  cs.rows = rows;
  cs.C = C;
  cs.L = L;
  cs.wg = threadIdx.x / 128;
  cs.wq = (threadIdx.x / 32) % 4;
  cs.lane = threadIdx.x % 32;
  cs.slope = slope;
  cs.it = 0;
  const int tid = threadIdx.x;
  constexpr int NC = NCW * 128;
  const bf16 zero = __float2bfloat16(0.f);
  const bool vec = L % 8 == 0;
  constexpr int UNROLL = 4;  // 16-byte loads of x or y in flight a thread

  for (int work = blockIdx.x; work < n_work; work += gridDim.x) {
    const int b = work / n_tiles;
    const int t0 = (work % n_tiles) * T;
    const bf16* xb = x + (size_t)b * C * L;
    bf16* yb = y + (size_t)b * C * L;
    const bf16* bconv = bias;
    for (int rb = 0; rb < 3; ++rb) {
      const int k = kernel_size(plan, rb);
      int hk = 0;
      for (int i = 0; i < 3; ++i) hk += (dilation(plan, rb, i) + 1) * (k - 1) / 2;
      const int E = T + 2 * hk;
      const int g0 = t0 - hk;
      cs.g0 = g0;
      // stage x[g0, g0 + E) transposed into X, and its leaky relu into A: a
      // thread takes 8 positions of one channel (a 16-byte load where they
      // lie inside an aligned x row), neighbouring threads neighbouring
      // channels, UNROLL loads in flight
      const int gs = g0 >= 0 ? g0 & ~7 : -((-g0 + 7) & ~7);
      const int n_chunks = (g0 + E - gs + 7) / 8 * C;
      for (int idx0 = tid; idx0 < n_chunks; idx0 += UNROLL * NC) {
        Pack8 v[UNROLL];
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) {
          const int idx = idx0 + q * NC;
          const int c = idx % C, g = gs + 8 * (idx / C);
          const bf16* src = xb + (size_t)c * L;
          if (idx >= n_chunks) {
          } else if (vec && g >= 0 && g + 8 <= L) {
            v[q] = *reinterpret_cast<const Pack8*>(src + g);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[q].v[e] = (g + e >= 0 && g + e < L) ? src[g + e] : zero;
          }
        }
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) {
          const int idx = idx0 + q * NC;
          if (idx >= n_chunks) break;
          const int c = idx % C, g = gs + 8 * (idx / C);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int j = g + e - g0;
            if (j >= 0 && j < E) {
              cs.X[(size_t)j * ld + c] = v[q].v[e];
              cs.A[(size_t)j * ld + c] = lrelu(v[q].v[e], slope);
            }
          }
        }
      }
      named_bar_sync<NC>(1);
      int lo = 0, hi = E;
      for (int i = 0; i < 3; ++i) {
        const int d = dilation(plan, rb, i);
        const int p1 = d * (k - 1) / 2, p2 = (k - 1) / 2;
        lo += p1;
        hi -= p1;
        conv_stage<CO, MT, true, SMEM>(cs, lo, hi, k, d, bconv);
        bconv += C;
        lo += p2;
        hi -= p2;
        conv_stage<CO, MT, false, SMEM>(cs, lo, hi, k, 1, bconv);
        bconv += C;
      }
      // rows [hk, hk + T) hold this ResBlock's output: add it into y, 8
      // positions of one channel a thread (T is a multiple of 8), the y
      // loads of UNROLL chunks in flight before any store
      const int n_out = (T / 8) * C;
      for (int idx0 = tid; idx0 < n_out; idx0 += UNROLL * NC) {
        Pack8 out[UNROLL];
        if (rb > 0) {
#pragma unroll
          for (int q = 0; q < UNROLL; ++q) {
            const int idx = idx0 + q * NC;
            const int c = idx % C, g = t0 + 8 * (idx / C);
            const bf16* dst = yb + (size_t)c * L + g;
            if (idx >= n_out || g >= L) {
            } else if (vec && g + 8 <= L) {
              out[q] = *reinterpret_cast<const Pack8*>(dst);
            } else {
#pragma unroll
              for (int e = 0; e < 8; ++e) out[q].v[e] = g + e < L ? dst[e] : zero;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < UNROLL; ++q) {
          const int idx = idx0 + q * NC;
          const int c = idx % C, j0 = 8 * (idx / C), g = t0 + j0;
          if (idx >= n_out) break;
          if (g >= L) continue;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const bf16 v = cs.X[(size_t)(hk + j0 + e) * ld + c];
            if (rb == 0) {
              out[q].v[e] = v;
            } else {
              bf16 sum = badd(out[q].v[e], v);
              if (rb == 2) sum = __float2bfloat16(__bfloat162float(sum) / 3.f);
              out[q].v[e] = sum;
            }
          }
          bf16* dst = yb + (size_t)c * L + g;
          if (vec && g + 8 <= L) {
            *reinterpret_cast<Pack8*>(dst) = out[q];
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (g + e < L) dst[e] = out[q].v[e];
          }
        }
      }
      named_bar_sync<NC>(1);  // X is free for the next ResBlock's staging
    }
  }
}

constexpr int SMEM_MAX = 232448;      // bytes of shared memory a block may use on Hopper
constexpr int ERR_NO_ENCODER = 2000;  // libcuda has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 3000;      // + the CUresult of a refused tensor map
constexpr int ERR_PLAN = 4000;        // a tile plan the kernel cannot run

// Output channels a pass and m-tiles a consumer warpgroup, by C.
__host__ __device__ constexpr int co_width(int C) { return C < 128 ? C : 128; }
__host__ __device__ constexpr int m_tiles(int C) { return C == 32 ? 6 : C == 64 ? 4 : 2; }

// Bytes of dynamic shared memory: the ring, its barriers, the two buffers
// when they live in shared memory, and the slack of the 1024-byte alignment.
int smem_bytes(int C, int rows, bool buffers_in_smem) {
  size_t bytes = (size_t)STAGES * co_width(C) * ROW_BYTES + BAR_BYTES + 1024;
  if (buffers_in_smem) bytes += (size_t)2 * rows * (C + 8) * 2;
  return (int)bytes;
}

template <int CO, int MT, bool SMEM>
int launch(const CUtensorMap& map, const void* x, void* y, const void* bias, void* workspace,
           MrfPlan plan, int B, int C, int L, int T, int rows, int grid, int smem, float slope,
           cudaStream_t stream) {
  auto kernel = mrf_level_kernel<CO, MT, SMEM>;
  // the largest block the card allows, set once per device and instantiation
  static bool allowed[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || !allowed[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    if (device < 64) allowed[device] = true;
  }
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  kernel<<<grid, NT, smem, stream>>>(map, static_cast<const bf16*>(x), static_cast<bf16*>(y),
                                     static_cast<const bf16*>(bias),
                                     static_cast<bf16*>(workspace), plan, B, C, L, T, rows,
                                     slope);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: [B, C, L] bf16, contiguous, 16-byte aligned. w: the 18 convs in
// chain order as [18 * C_out][kpad] bf16, row conv * C + c_out holding tap t,
// input channel c_in at column t * C + c_in and zeros after the last tap
// (ops/mrf.py:pack_weights; kpad a multiple of 64). bias: [18][C] bf16.
// workspace: null (buffers in shared memory, one block a tile) or grid * 2 *
// rows * (C + 8) bf16 (C >= 128 only). C is 32, 64 or a multiple of 64 from
// 128; T a multiple of 8 whose widest conv range fits the block's m-tiles.
extern "C" int mrf_level_fwd(const void* x, void* y, const void* w, const void* bias,
                             void* workspace, MrfPlan plan, int B, int C, int L, int T,
                             int rows, int grid, int kpad, float slope, void* stream) {
  if (!(C == 32 || C == 64 || (C >= 128 && C % 128 == 0)) || T % 8 || T < 8 || B < 1 ||
      L < 1 || grid < 1 || kpad % KU || (C <= 128) != (workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const int cover = NCW * m_tiles(C) * 64;
  for (int rb = 0; rb < 3; ++rb) {
    const int k = plan.ks[rb];
    int hk = 0;
    for (int i = 0; i < 3; ++i) hk += (plan.dil[rb][i] + 1) * (k - 1) / 2;
    const int first = plan.dil[rb][0] * (k - 1) / 2;
    if (k * C > kpad || k % 2 == 0 || T + 2 * hk > rows || T + 2 * hk - 2 * first > cover)
      return ERR_PLAN;
  }
  EncodeTiled encode = encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)kpad, (cuuint64_t)18 * C};
  const cuuint64_t strides[1] = {(cuuint64_t)kpad * 2};
  const cuuint32_t box[2] = {KU, (cuuint32_t)co_width(C)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  const bool in_smem = workspace == nullptr;
  const int smem = smem_bytes(C, rows, in_smem);
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 32)
    return launch<32, 6, true>(map, x, y, bias, workspace, plan, B, C, L, T, rows, grid, smem,
                               slope, s);
  if (C == 64)
    return launch<64, 4, true>(map, x, y, bias, workspace, plan, B, C, L, T, rows, grid, smem,
                               slope, s);
  if (in_smem)
    return launch<128, 2, true>(map, x, y, bias, workspace, plan, B, C, L, T, rows, grid, smem,
                                slope, s);
  return launch<128, 2, false>(map, x, y, bias, workspace, plan, B, C, L, T, rows, grid, smem,
                               slope, s);
}
