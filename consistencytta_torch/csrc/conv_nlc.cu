// Channels-last implicit-GEMM conv1d for Hopper (sm_90a): kernel K7 of the port.
//
// Replaces no kernel of the JAX package: there the vocoder's MRF levels wider
// than 128 channels run as plain ResBlocks (consistencytta_tpu/nn/hifigan.py),
// and here they ran as cuDNN convs with PyTorch's elementwise ops around each
// (ops/mrf.py:mrf_level_plain with phase-split dilated convs): per conv a
// layout transpose in and out, the phase split's pad and permute copies, a
// strided bias add, a three-kernel leaky ReLU and the residual add, each a
// pass over a 168-336 MB tensor at batch 32. K3 (csrc/mrf.cu) runs a whole
// level in one launch with a halo in shared memory, which at 512-1024 bytes a
// row leaves no room for useful rows; it keeps the levels of C <= 128.
//
// One launch computes one conv of a level's chain over the whole batch, in the
// [B, L, C] (channels-last) layout, as a GEMM: M = B * L positions, N = C_out,
// K = k * C_in. In that layout a dilated tap is a row offset, so
//   y[b, l, :] = sum_t x[b, l + (t - (k-1)/2) * d, :] @ w[:, :, t]^T
// with x zero outside [0, L): the "same" padding of the conv.
//
// What bounds it on the H100: operations. A tile of 128 positions x BN output
// channels does 2 * 128 * BN * 64 operations a k-step of 64 input channels
// and loads 128 + BN rows of 128 bytes for them, about 87 operations a byte
// from L2 at BN = 256; from device memory each position is read about once a
// tap-window (neighbouring tiles share their halo in L2). The level's
// elementwise work is folded into the epilogue, where the accumulators are
// already in registers, so that a level moves ~60 tensor passes of bytes
// (3-6 ms at 3.35 TB/s) against ~11 ms of tensor-core time at batch 32: the
// generate path's levels, C = 512 at L = 5,121 and C = 256 at L = 20,484,
// each need 1.08e13 operations.
//
// Design (hopper-kernels section 1):
//   - A persistent grid, one block an SM, walks tiles (m-tile, n-tile), the
//     n-tiles of one m-tile next to each other so that they share the
//     activation rows in L2. An m-tile is 128 positions of one batch item.
//   - A producer warpgroup (setmaxnreg: 40 registers a thread; the consumers
//     take 232). One thread TMA-loads, for each k-step (tap t, 64 input
//     channels kc), the activation box [64 channels, 128 rows] of a 3-d tensor
//     map (C, L, B) at row l0 + (t - (k-1)/2) * d, and the weights' box
//     [64, BN] of the conv's [C_out, k * C_in] K-major pack, both 128-byte
//     swizzled, into a ring of STAGES stages. Rows before 0 or past L of the
//     batch item come back as zeros: the conv's padding, with no pad copy and
//     no phase split. It runs ahead into the next tile while the consumers
//     finish this one's epilogue. A second thread TMA-loads the tile's
//     residual rows into the epilogue boxes (64 rows x 64 channels, 128-byte
//     swizzled; BM x BN in all) once the last tile's epilogue has left them,
//     so that the residual arrives during the tile's products.
//   - Two consumer warpgroups take 64 rows each and hold 64 x BN fp32
//     accumulators (wgmma m64nBNk16, both operands in shared memory); a stage
//     is freed once the next stage's products are issued.
//   - Epilogue, in fp32: + bias; + the residual (from the boxes); + the running
//     3-way sum (read from global memory in the accumulators' layout); times
//     `scale`; then y0 = leaky_relu(t) or t, and optionally y1 =
//     leaky_relu(t). Each output is rounded to bf16 once, written over the
//     residual in the boxes (each thread reads its elements before it writes
//     them) and leaves by TMA store, which clips rows past L.
//     The caller chains the level from these (ops/mrf.py:wide_plan): conv1
//     writes v = lrelu(conv(u) + b); conv2 writes xb' = xb + conv(v) + b and
//     u' = lrelu(xb'), or at a ResBlock's last dilation folds xb' into the
//     sum (the last one writes the mean).
// The layout passes at a level's two ends (x [B, C, L] -> x, lrelu(x) in
// [B, L, C], and the mean back to [B, C, L]) are the two small transpose
// kernels below.
//
// Limits: bf16; C a multiple of 64 and of BN (256, 128 or 64, chosen by the
// caller from C and the tile count, ops/mrf.py:wide_tile_n); odd k. The
// epilogue does not overlap the products of the next tile (the consumers run
// both); the halo rows of a tile are loaded again by its neighbours (from L2).
//
// Compile with -DFA_BOUNDED_WAIT to let a wait on an mbarrier give up after
// 2^24 polls: a wrong phase then gives wrong numbers instead of a hung card.

#include "hopper_async.cuh"

// d (64 x 256) = or += a (64 x 16, shared, K-major) * b (256 x 16, shared, K-major)^T
// (beside the header's overloads for N = 32, 64 and 128)
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WG_R128
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D128(d, 0)
      : "l"(a), "l"(b), "r"(acc));
}

namespace {

constexpr int BM = 128;              // positions a tile: two consumer warpgroups of 64
constexpr int BK = 64;               // input channels a k-step: one 128-byte swizzled row
constexpr int NT = 3 * 128;          // two consumer warpgroups and a producer warpgroup
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // setmaxnreg: 64,512 of 65,536
constexpr int BOX_BYTES = 64 * 128;  // one epilogue box: 64 rows x 64 channels
constexpr int BAR_BYTES = 256;       // the mbarriers
constexpr int SMEM_MAX = 232448;     // bytes of shared memory a block may use on Hopper
constexpr int LAYOUT_TILE = 64;      // positions and channels a block of the layout passes
constexpr int ERR_NO_ENCODER = 2000;  // libcuda has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 3000;      // + the CUresult of a refused tensor map
constexpr int ERR_PLAN = 4000;        // shapes or pointers the kernel does not take

template <int BN>
struct Tile {
  static constexpr int STAGES = BN == 256 ? 3 : BN == 128 ? 6 : 8;
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
  static constexpr int EPI_BYTES = BM * BN * 2;  // the tile's epilogue boxes
  // the ring, the epilogue boxes, the barriers and the slack of the
  // 1024-byte alignment
  static constexpr int SMEM = STAGES * STAGE_BYTES + EPI_BYTES + BAR_BYTES + 1024;
  static_assert(SMEM <= SMEM_MAX, "the block's shared memory");
  static_assert((2 * STAGES + 2) * 8 <= BAR_BYTES, "the barriers");
};

// What the epilogue adds to the conv and where it writes (see the note).
struct Epilogue {
  const float* bias;  // [C] fp32
  const bf16* sum;    // [B, L, C] or null
  float scale;        // t = (conv + bias + res + sum) * scale
  float slope;        // of the leaky ReLUs
  int has_res;        // the residual (map_res) is added
  int act0;           // y0 = lrelu(t) (else t)
  int has_y1;         // y1 = lrelu(t) too
};

__device__ __forceinline__ float lrelu(float v, float slope) { return v > 0.f ? v : v * slope; }

template <int BN>
__global__ void __launch_bounds__(NT, 1)
ctta_conv_nlc_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w,
                     const __grid_constant__ CUtensorMap map_res,
                     const __grid_constant__ CUtensorMap map_y0,
                     const __grid_constant__ CUtensorMap map_y1, const Epilogue ep, int L, int C,
                     int k, int d, int tiles_row, int n_tiles, int total) {
  using T = Tile<BN>;
  constexpr int NB = BN / 64;  // epilogue boxes a warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* epi = smem + T::STAGES * T::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + T::EPI_BYTES);
  uint64_t* empty = full + T::STAGES;
  uint64_t* epi_full = empty + T::STAGES;
  uint64_t* epi_empty = epi_full + 1;
  const int csteps = C / BK, ksteps = k * csteps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // every consumer warp reads every stage
    }
    mbar_init(epi_full, 1);
    mbar_init(epi_empty, 2);  // one arrival a consumer warpgroup
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      // the ring: per tile, per k-step, the tap's activation rows and the
      // weights' columns of that tap and channel block
      const int half = (k - 1) / 2;
      uint32_t it = 0;
      for (int g = blockIdx.x; g < total; g += gridDim.x) {
        const int n0 = (g % n_tiles) * BN, m = g / n_tiles;
        const int b = m / tiles_row, l0 = (m % tiles_row) * BM;
        for (int s = 0; s < ksteps; ++s, ++it) {
          const int slot = it % T::STAGES;
          mbar_wait(&empty[slot], ((it / T::STAGES) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[slot], T::STAGE_BYTES);
          unsigned char* st = smem + slot * T::STAGE_BYTES;
          const int t = s / csteps, kc = s - t * csteps;
          tma_load_3d(st, &map_x, &full[slot], kc * BK, l0 + (t - half) * d, b);
          tma_load_2d(st + T::A_BYTES, &map_w, &full[slot], s * BK, n0);
        }
      }
    } else if (threadIdx.x == 288) {
      // the epilogue boxes: per tile, once the last tile's epilogue is done
      // with them, the residual rows of the tile (or an empty arrival)
      uint32_t e = 0;
      for (int g = blockIdx.x; g < total; g += gridDim.x, ++e) {
        const int n0 = (g % n_tiles) * BN, m = g / n_tiles;
        const int b = m / tiles_row, l0 = (m % tiles_row) * BM;
        mbar_wait(epi_empty, (e & 1) ^ 1);
        if (ep.has_res) {
          const int halves = l0 + 64 < L ? 2 : 1;
          mbar_arrive_expect_tx(epi_full, halves * NB * BOX_BYTES);
          for (int h = 0; h < halves; ++h)
            for (int j = 0; j < NB; ++j)
              tma_load_3d(epi + (h * NB + j) * BOX_BYTES, &map_res, epi_full, n0 + 64 * j,
                          l0 + 64 * h, b);
        } else {
          mbar_arrive(epi_full);
        }
      }
    }
    return;
  }
  reg_alloc<CONSUMER_REGS>();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  unsigned char* boxes = epi + wg * NB * BOX_BYTES;
  // this thread's first row of the warpgroup's 64; its accumulator i holds
  // row rl + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane % 4) + (i & 1),
  // staged in box i >> 5 at row r, 16-byte chunk ((i >> 2) & 7) ^ (r & 7)
  const int rl = 16 * warp + (lane >> 2);
  const uint32_t a_off = wg * 64 * 128;
  uint32_t it = 0, e = 0;
  for (int g = blockIdx.x; g < total; g += gridDim.x, ++e) {
    const int n0 = (g % n_tiles) * BN, m = g / n_tiles;
    const int b = m / tiles_row, l0 = (m % tiles_row) * BM;
    float acc[BN / 2];
    uint32_t prev = 0;
    for (int s = 0; s < ksteps; ++s, ++it) {
      const uint32_t slot = it % T::STAGES;
      mbar_wait(&full[slot], (it / T::STAGES) & 1);
      const uint32_t st = smem_u32(smem + slot * T::STAGE_BYTES);
      const uint64_t da = wgmma_desc(st + a_off, 16, 1024);
      const uint64_t db = wgmma_desc(st + T::A_BYTES, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_ss(acc, da + 2 * kk, db + 2 * kk, s > 0 || kk > 0);
      wgmma_commit();
      // free the previous stage once its products are done (a warp's wait
      // covers its own products, so every warp arrives)
      wgmma_wait<1>();
      if (s > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = slot;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);
    mbar_wait(epi_full, e & 1);
    const int r0 = l0 + 64 * wg;  // the warpgroup's first position
    if (r0 < L) {
      // t = (conv + bias + res + sum) * scale in place, and y0 over the
      // residual in the boxes
#pragma unroll
      for (int j8 = 0; j8 < BN / 8; ++j8) {
        const int c = n0 + 8 * j8 + 2 * (lane & 3);
        const float2 bb = *reinterpret_cast<const float2*>(ep.bias + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rl + 8 * h;
          uint32_t* at = reinterpret_cast<uint32_t*>(
              boxes + (j8 >> 3) * BOX_BYTES + r * 128 + (((j8 & 7) ^ (r & 7)) << 4) +
              ((lane & 3) << 2));
          float v0 = acc[4 * j8 + 2 * h] + bb.x, v1 = acc[4 * j8 + 2 * h + 1] + bb.y;
          if (ep.has_res) {
            const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(at));
            v0 += q.x;
            v1 += q.y;
          }
          if (ep.sum && r0 + r < L) {
            const float2 q = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                ep.sum + ((size_t)b * L + r0 + r) * C + c));
            v0 += q.x;
            v1 += q.y;
          }
          v0 *= ep.scale;
          v1 *= ep.scale;
          acc[4 * j8 + 2 * h] = v0;
          acc[4 * j8 + 2 * h + 1] = v1;
          *at = ep.act0 ? pack_bf16(lrelu(v0, ep.slope), lrelu(v1, ep.slope)) : pack_bf16(v0, v1);
        }
      }
      fence_proxy_async();
      named_bar_sync<128>(1 + wg);
      if (tid == 0) {
        for (int j = 0; j < NB; ++j)
          tma_store_3d(&map_y0, boxes + j * BOX_BYTES, n0 + 64 * j, r0, b);
        bulk_commit();
      }
      if (ep.has_y1) {
        // y1 = lrelu(t) into the same boxes once the y0 stores have read them
        if (tid == 0) bulk_wait_read<0>();
        named_bar_sync<128>(1 + wg);
#pragma unroll
        for (int j8 = 0; j8 < BN / 8; ++j8)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rl + 8 * h;
            *reinterpret_cast<uint32_t*>(boxes + (j8 >> 3) * BOX_BYTES + r * 128 +
                                         (((j8 & 7) ^ (r & 7)) << 4) + ((lane & 3) << 2)) =
                pack_bf16(lrelu(acc[4 * j8 + 2 * h], ep.slope),
                          lrelu(acc[4 * j8 + 2 * h + 1], ep.slope));
          }
        fence_proxy_async();
        named_bar_sync<128>(1 + wg);
        if (tid == 0) {
          for (int j = 0; j < NB; ++j)
            tma_store_3d(&map_y1, boxes + j * BOX_BYTES, n0 + 64 * j, r0, b);
          bulk_commit();
        }
      }
      // the boxes are free once the stores have read them
      if (tid == 0) bulk_wait_read<0>();
    }
    if (tid == 0) mbar_arrive(epi_empty);
  }
  if (tid == 0) bulk_wait<0>();
}

// x [B, C, L] -> xt = x and u = lrelu(x), both [B, L, C]: a block transposes
// 64 channels x 64 positions through shared memory, reading rows of x and
// writing rows of xt and u.
__global__ void __launch_bounds__(256)
ctta_conv_nlc_enter_kernel(const bf16* __restrict__ x, bf16* __restrict__ xt,
                           bf16* __restrict__ u, int C, int L, float slope) {
  __shared__ bf16 tile[LAYOUT_TILE][LAYOUT_TILE + 2];  // [channel][position]
  const int l0 = blockIdx.x * LAYOUT_TILE, c0 = blockIdx.y * LAYOUT_TILE, b = blockIdx.z;
  const int tx = threadIdx.x % 64, ty = threadIdx.x / 64;
  const bf16* xb = x + (size_t)b * C * L;
  for (int i = ty; i < LAYOUT_TILE; i += 4)
    tile[i][tx] = l0 + tx < L ? xb[(size_t)(c0 + i) * L + l0 + tx] : __float2bfloat16(0.f);
  __syncthreads();
  for (int i = ty; i < LAYOUT_TILE && l0 + i < L; i += 4) {
    const bf16 v = tile[tx][i];
    const size_t off = ((size_t)b * L + l0 + i) * C + c0 + tx;
    xt[off] = v;
    u[off] = __float2bfloat16(lrelu(__bfloat162float(v), slope));
  }
}

// y [B, L, C] -> out [B, C, L], the same tiles the other way.
__global__ void __launch_bounds__(256)
ctta_conv_nlc_leave_kernel(const bf16* __restrict__ y, bf16* __restrict__ out, int C, int L) {
  __shared__ bf16 tile[LAYOUT_TILE][LAYOUT_TILE + 2];  // [position][channel]
  const int l0 = blockIdx.x * LAYOUT_TILE, c0 = blockIdx.y * LAYOUT_TILE, b = blockIdx.z;
  const int tx = threadIdx.x % 64, ty = threadIdx.x / 64;
  for (int i = ty; i < LAYOUT_TILE && l0 + i < L; i += 4)
    tile[i][tx] = y[((size_t)b * L + l0 + i) * C + c0 + tx];
  __syncthreads();
  if (l0 + tx < L)
    for (int i = ty; i < LAYOUT_TILE; i += 4)
      out[((size_t)b * C + c0 + i) * L + l0 + tx] = tile[tx][i];
}

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes of the
// outer dims), 128-byte swizzled, zero fill.
int make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// A [B, L, C] tensor as a (C, L, B) map whose box is 64 channels x `rows`.
int nlc_map(CUtensorMap* map, const void* base, int B, int L, int C, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)L * C * 2};
  const cuuint32_t box[3] = {BK, (cuuint32_t)rows, 1};
  return make_map(map, base, 3, dims, strides, box);
}

// Per device: the largest block allowed (set once per instantiation) and the
// number of SMs.
template <int BN>
int prepare(int* sms) {
  static bool allowed[64] = {};
  static int count[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(ctta_conv_nlc_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<BN>::SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed[device] = true;
  }
  if (!count[device]) {
    err = cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = count[device];
  return 0;
}

template <int BN>
int launch(const void* x, const void* w, const void* res, const Epilogue& ep, void* y0, void* y1,
           int B, int L, int C, int k, int d, cudaStream_t stream) {
  CUtensorMap mx, mw, mres, my0, my1;
  if (int err = nlc_map(&mx, x, B, L, C, BM)) return err;
  if (int err = nlc_map(&mres, res ? res : y0, B, L, C, 64)) return err;
  const cuuint64_t wdims[2] = {(cuuint64_t)k * C, (cuuint64_t)C};
  const cuuint64_t wstrides[1] = {(cuuint64_t)k * C * 2};
  const cuuint32_t wbox[2] = {BK, (cuuint32_t)BN};
  if (int err = make_map(&mw, w, 2, wdims, wstrides, wbox)) return err;
  if (int err = nlc_map(&my0, y0, B, L, C, 64)) return err;
  if (int err = nlc_map(&my1, y1 ? y1 : y0, B, L, C, 64)) return err;
  int sms = 0;
  if (int err = prepare<BN>(&sms)) return err;
  const int tiles_row = (L + BM - 1) / BM, n_tiles = C / BN;
  const long long total = (long long)B * tiles_row * n_tiles;
  if (total > (1LL << 30)) return ERR_PLAN;
  const int grid = total < sms ? (int)total : sms;
  ctta_conv_nlc_kernel<BN><<<grid, NT, Tile<BN>::SMEM, stream>>>(
      mx, mw, mres, my0, my1, ep, L, C, k, d, tiles_row, n_tiles, (int)total);
  return (int)cudaGetLastError();
}

bool aligned(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// One conv of an MRF level, channels-last. x, res, sum, y0, y1: [B, L, C] bf16,
// contiguous, 16-byte aligned (res, sum, y1 may be null); w: the conv's
// [C_out, k * C_in] bf16 pack (ops/mrf.py:pack_nlc_weights); bias: [C] fp32.
// y0 and y1 may be res or sum (each element is read before it is written, by
// the same thread) but never x. bn: output channels a tile (256, 128 or 64,
// dividing C).
extern "C" int conv_nlc_fwd(const void* x, const void* w, const void* bias, const void* res,
                            const void* sum, void* y0, void* y1, int B, int L, int C, int k,
                            int d, int bn, int act0, float scale, float slope, void* stream) {
  if (B < 1 || L < 1 || C < BK || C % BK || k < 1 || k % 2 == 0 || d < 1 || !bias ||
      (bn != 64 && bn != 128 && bn != 256) || C % bn || !aligned(x) || !aligned(w) ||
      !aligned(y0) || (res && !aligned(res)) || (sum && !aligned(sum)) ||
      (y1 && !aligned(y1)) || (uintptr_t)bias % 8 || x == y0 || x == y1)
    return ERR_PLAN;
  const Epilogue ep = {static_cast<const float*>(bias), static_cast<const bf16*>(sum), scale,
                       slope, res != nullptr, act0, y1 != nullptr};
  cudaStream_t s = (cudaStream_t)stream;
  if (bn == 256) return launch<256>(x, w, res, ep, y0, y1, B, L, C, k, d, s);
  if (bn == 128) return launch<128>(x, w, res, ep, y0, y1, B, L, C, k, d, s);
  return launch<64>(x, w, res, ep, y0, y1, B, L, C, k, d, s);
}

// The level's layout passes: enter (src [B, C, L] -> dst = src and dst_act =
// lrelu(src), [B, L, C]) or leave (src [B, L, C] -> dst [B, C, L]).
extern "C" int conv_nlc_layout(const void* src, void* dst, void* dst_act, int B, int C, int L,
                               int enter, float slope, void* stream) {
  if (B < 1 || L < 1 || C < LAYOUT_TILE || C % LAYOUT_TILE || B > 65535 || (enter && !dst_act))
    return ERR_PLAN;
  const dim3 grid((L + LAYOUT_TILE - 1) / LAYOUT_TILE, C / LAYOUT_TILE, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (enter)
    ctta_conv_nlc_enter_kernel<<<grid, 256, 0, s>>>(static_cast<const bf16*>(src),
                                                   static_cast<bf16*>(dst),
                                                   static_cast<bf16*>(dst_act), C, L, slope);
  else
    ctta_conv_nlc_leave_kernel<<<grid, 256, 0, s>>>(static_cast<const bf16*>(src),
                                                   static_cast<bf16*>(dst), C, L);
  return (int)cudaGetLastError();
}
