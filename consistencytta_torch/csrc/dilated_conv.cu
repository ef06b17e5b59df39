// Dilated conv1d for Hopper (sm_90a): kernel K5 of the port.
//
// Replaces the JAX package's Pallas kernel
//   consistencytta_tpu/ops/pallas_blockconv.py:blockconv1d_dense (_kernel_body),
// a standalone kernel for the vocoder's dilated ResBlock convs that nothing
// dispatches there, and nothing dispatches here. It computes
//   y[b, co, j] = sum_t sum_ci w[co, ci, t] * x[b, ci, j - p + t*d]
// with x zero outside [0, L), bf16 in, fp32 accumulation, bf16 out, in the
// natural [B, C, L] layout. The TPU kernel's phase-lattice packing exists to
// skip the zeros of its [B, M, 2*64] block layout; here there are none, and
// the conv is k shifted [C, C] products over a tile of positions.
//
// What bounds it on the H100: x read once and y written once, 4 bytes a
// position and channel, against 2 * C * k operations: at C = 64 the bytes
// bound it up to k = 7 and the operations at k = 11.
//
// Design: a persistent kernel, one block an SM, walking tiles of N output
// positions of one batch row (N = 128; 64 at C = 128).
//   - Weights. The host packs them once per weight version
//     (ops/dilated_conv.py:pack_weights) as [k][C/8][MP][8] bf16, MP =
//     max(C, 64) output channels (zero rows below 64): each tap is an
//     unswizzled K-major wgmma A operand. Where all k taps fit (every C <= 64
//     conv with a small halo, C = 128 up to k = 3) a block copies them once
//     into shared memory and keeps them; otherwise they stream through a ring
//     of three tap slots, refilled per tap and round of tiles, a slot freed
//     once the next tap's products are issued (with one slot, the last resort
//     of the widest windows at C = 128, once its own products are done).
//   - x. One producer warp TMA-loads each tile's window x[b, :, s0, s0 + WR)
//     (boxes of C x 64 positions, 128-byte swizzled; TMA's zero fill gives
//     the padding at both edges) into a ring of XS stages per consumer
//     warpgroup. s0 = t0 - p - ((-p) mod 8) is t0 - p rounded down to a
//     multiple of 8: a tiled TMA load must start on 16 bytes. Rows whose
//     stride TMA cannot take (L % 8 != 0, or x not 16-byte aligned), or plans
//     without room for the ring, have the consumers gather the window from
//     global memory instead, with the same zero fill.
//   - Two consumer warpgroups, one tile each, so that one's staging and
//     epilogue overlap the other's products. A consumer transposes its
//     window with ldmatrix.trans into [C/8][WB][8] (8 channels of a position
//     in 16 bytes): an unswizzled K-major B operand whose start can move by
//     one position, 16 bytes, so tap t's shifted window x[.. + t*d] is the
//     same buffer at a descriptor offset of (t0 - p - s0) + t*d, whatever its
//     value mod 8. Then k * C/16 wgmma m64nNk16 (per 64 output channels), A
//     the tap's weights and B the shifted window, accumulate [co][pos] in
//     fp32 registers: already y's layout.
//   - Epilogue. The accumulators are rounded to bf16 into the window buffer
//     as 128-byte-swizzled boxes of C x 64 positions and leave by TMA store,
//     which clips the ragged last tile; where y's rows are not TMA's (L_out %
//     8 != 0), the warpgroup stores them from there with bounds.
// Limits: the window of a tile, N + (k-1)*d positions, must fit a consumer's
// buffer beside one weight slot; where two buffers do not fit, one consumer
// warpgroup runs (ops/dilated_conv.py:tile_plan, which refuses (k-1)*d above
// 3385, 1593, 697 at C = 32, 64, 128). At C = 32 the products run at M = 64,
// half of them on zero weights. The halo, (k-1)*d positions a tile, is loaded
// and transposed again by the tile beside it.
//
// Compile with -DFA_BOUNDED_WAIT to let a wait on an mbarrier give up after
// 2^24 polls: a wrong phase then gives wrong numbers instead of a hung card.

#include "hopper_async.cuh"

namespace {

constexpr int NCW = 2;              // consumer warpgroups, one tile each (at most)
constexpr int NT = NCW * 128 + 32;  // and one producer warp
constexpr int MAX_XS = 2;           // x stages a consumer warpgroup
constexpr int MAX_WS = 3;           // slots of a streamed weight ring
constexpr int BAR_BYTES = 128;      // the rings' mbarriers
constexpr int SMEM_MAX = 232448;    // bytes of shared memory a block may use on Hopper
constexpr int ERR_NO_ENCODER = 2000;  // libcuda has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 3000;      // + the CUresult of a refused tensor map
constexpr int ERR_PLAN = 4000;        // a tile plan the kernel cannot run

struct Bars {
  uint64_t xfull[NCW * MAX_XS], xempty[NCW * MAX_XS], wfull[MAX_WS], wempty[MAX_WS];
};

// The shapes that follow from C.
template <int C>
struct Shape {
  static constexpr int MP = C < 64 ? 64 : C;       // weight rows a tap (wgmma M >= 64)
  static constexpr int MT = MP / 64;                // m64 tiles
  static constexpr int N = C == 128 ? 64 : 128;     // output positions a tile
  static constexpr int UNIT = C * MP * 2;           // bytes of one tap's weights
};

// Bytes of dynamic shared memory (mirrors ops/dilated_conv.py:smem_bytes):
// the consumers' x rings, the weight slots, a window buffer per consumer, the
// barriers and the slack of the 1024-byte alignment.
size_t smem_bytes(int C, int wb, int wr, int xs, int ws, int ncw) {
  const int mp = C < 64 ? 64 : C;
  return (size_t)ncw * xs * C * wr * 2 + (size_t)ws * C * mp * 2 + (size_t)ncw * C * wb * 2 +
         BAR_BYTES + 1024;
}

// raw: one x stage, WR / 64 boxes of C rows x 64 positions, 128-byte
// swizzled. buf: [C/8][wb][8]. A warp takes 8 channels x 32 positions at a
// time: ldmatrix.trans of four 8 x 8 blocks (channel rows, whose 16-byte
// chunks the swizzle spreads over the banks), then 4-byte stores that fill
// 128 contiguous bytes a block.
template <int C>
__device__ __forceinline__ void transpose_window(const unsigned char* raw, bf16* buf, int wb,
                                                 int warp, int lane) {
  const int units = (C / 8) * (wb / 32);
  const int m = lane >> 3, i = lane & 7;
  for (int u = warp; u < units; u += 4) {
    const int cg = u % (C / 8), p0 = (u / (C / 8)) * 32;
    const int pg = p0 / 8 + m, c = 8 * cg + i;
    uint32_t r[4];
    ldsm_x4_trans(r, raw + (size_t)(pg >> 3) * C * 128 + c * 128 + (((pg & 7) ^ i) << 4));
#pragma unroll
    for (int mm = 0; mm < 4; ++mm)
      *reinterpret_cast<uint32_t*>(buf + ((size_t)cg * wb + p0 + 8 * mm + (lane >> 2)) * 8 +
                                   2 * (lane & 3)) = r[mm];
  }
}

// The same window from global memory: x[b, :, g0 + n] for n < wb, zero
// outside [0, L); a thread takes 8 channels of one position, neighbouring
// threads neighbouring positions.
template <int C>
__device__ __forceinline__ void gather_window(const bf16* __restrict__ xb, bf16* buf, int wb,
                                              int g0, int L, int tid) {
  for (int i = tid; i < (C / 8) * wb; i += 128) {
    const int cg = i / wb, gp = g0 + i % wb;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gp >= 0 && gp < L) {
      const unsigned short* src =
          reinterpret_cast<const unsigned short*>(xb) + (size_t)(8 * cg) * L + gp;
      uint32_t e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = (uint32_t)__ldg(src + (size_t)(2 * j) * L) |
               ((uint32_t)__ldg(src + (size_t)(2 * j + 1) * L) << 16);
      v = make_uint4(e[0], e[1], e[2], e[3]);
    }
    *reinterpret_cast<uint4*>(buf + (size_t)i * 8) = v;
  }
}

// Element (co, n) of a y tile staged as 128-byte-swizzled boxes of C x 64.
template <int C>
__device__ __forceinline__ int staged(int co, int n) {
  return (n >> 6) * C * 64 + co * 64 + ((((n >> 3) & 7) ^ (co & 7)) << 3) + (n & 7);
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
dilated_conv_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_y, const bf16* __restrict__ x,
                    const bf16* __restrict__ w, bf16* __restrict__ y, int L, int L_out, int k,
                    int d, int p, int n_tiles, int tiles_row, int wb, int wr, int xs, int ws,
                    int ncw, int tma_y) {
  using S = Shape<C>;
  constexpr int N = S::N, MP = S::MP, MT = S::MT;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* raw = aligned_smem(smem_raw);
  unsigned char* wts = raw + (size_t)ncw * xs * C * wr * 2;
  bf16* bufs = reinterpret_cast<bf16*>(wts + (size_t)ws * S::UNIT);
  Bars* bars = reinterpret_cast<Bars*>(bufs + (size_t)ncw * C * wb);
  // this block's tiles are blockIdx.x + q * gridDim.x, q < nq; consumer wg
  // (of ncw: 2, or 1 where two windows do not fit) takes q = wg, wg + ncw,
  // ... The last round's missing tile, if nq is odd, recomputes the block's
  // last tile and stores nothing, so that every warpgroup runs the same
  // rounds (its products under no branch).
  const int nq = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int rounds = (nq + ncw - 1) / ncw;
  const bool resident = ws == k;
  // a window starts at the 8-aligned position at or before t0 - p (TMA takes
  // only 16-byte-aligned starts); output position 0 of a tile is its row off
  const int off = ((-p) % 8 + 8) % 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NCW * MAX_XS; ++s) {
      mbar_init(&bars->xfull[s], 1);
      mbar_init(&bars->xempty[s], 4);  // the warps of the consumer it belongs to
    }
    for (int s = 0; s < MAX_WS; ++s) {
      mbar_init(&bars->wfull[s], 1);
      mbar_init(&bars->wempty[s], ncw * 4);  // every consumer warp reads every tap
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCW * 128) {
    // producer: resident weights once; per round, the x windows of its tiles
    // (each consumer has a ring of its own: a wait on an mbarrier's parity
    // may run at most one phase ahead of the waiter's last one), then
    // (streamed) the round's k weight units
    if (threadIdx.x == NCW * 128) {
      if (resident) {
        mbar_arrive_expect_tx(&bars->wfull[0], (uint32_t)k * S::UNIT);
        for (int t = 0; t < k; ++t)
          bulk_load(wts + (size_t)t * S::UNIT, w + (size_t)t * S::UNIT / 2, S::UNIT,
                    &bars->wfull[0]);
      }
      uint32_t it = 0;
      for (int q = 0; q < rounds * ncw; ++q) {
        if (xs > 0) {
          const int g = blockIdx.x + min(q, nq - 1) * gridDim.x;
          const int b = g / tiles_row, t0 = (g % tiles_row) * N;
          const int j = q / ncw, s = (q % ncw) * xs + j % xs;
          mbar_wait(&bars->xempty[s], ((j / xs) & 1) ^ 1);
          mbar_arrive_expect_tx(&bars->xfull[s], (uint32_t)C * wr * 2);
          for (int box = 0; box < wr / 64; ++box)
            tma_load_3d(raw + ((size_t)s * wr + 64 * box) * C * 2, &map_x, &bars->xfull[s],
                        t0 - p - off + 64 * box, 0, b);
        }
        if (!resident && q % ncw == ncw - 1) {
          for (int t = 0; t < k; ++t, ++it) {
            const int s = it % ws;
            mbar_wait(&bars->wempty[s], ((it / ws) & 1) ^ 1);
            mbar_arrive_expect_tx(&bars->wfull[s], S::UNIT);
            bulk_load(wts + (size_t)s * S::UNIT, w + (size_t)t * S::UNIT / 2, S::UNIT,
                      &bars->wfull[s]);
          }
        }
      }
    }
    return;
  }
  if (threadIdx.x >= ncw * 128) return;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  bf16* buf = bufs + (size_t)wg * C * wb;
  // B: the window, rows = positions, 16-byte rows of 8 channels; A: a tap's
  // weights, rows = output channels. Both unswizzled K-major.
  const uint64_t bdesc0 = wgmma_desc(smem_u32(buf), wb * 16, 128, WGMMA_NO_SWIZZLE);
  const uint64_t adesc0 = wgmma_desc(smem_u32(wts), MP * 16, 128, WGMMA_NO_SWIZZLE);
  if (resident) mbar_wait(&bars->wfull[0], 0);
  uint32_t it = 0;
  for (int r = 0; r < rounds; ++r) {
    const int q = r * ncw + wg;
    const int g = blockIdx.x + min(q, nq - 1) * gridDim.x;
    const int b = g / tiles_row, t0 = (g % tiles_row) * N;
    if (tid == 0) bulk_wait_read<0>();  // the last tile's y store has read buf
    named_bar_sync<128>(1 + wg);
    if (xs > 0) {
      const int s = wg * xs + r % xs;
      mbar_wait(&bars->xfull[s], (r / xs) & 1);
      transpose_window<C>(raw + (size_t)s * C * wr * 2, buf, wb, warp, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bars->xempty[s]);
    } else {
      gather_window<C>(x + (size_t)b * C * L, buf, wb, t0 - p - off, L, tid);
    }
    fence_proxy_async();
    named_bar_sync<128>(1 + wg);

    float acc[MT][N / 2];
    uint32_t prev = 0;
    for (int t = 0; t < k; ++t) {
      uint32_t slot = t;
      if (!resident) {
        slot = it % ws;
        mbar_wait(&bars->wfull[slot], (it / ws) & 1);
      }
      const uint64_t adesc = adesc0 + ((slot * S::UNIT) >> 4);
      const uint64_t bdesc = bdesc0 + (uint64_t)(off + t * d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_ss(acc[mt], adesc + (uint64_t)(2 * ks * MP + 64 * mt),
                   bdesc + (uint64_t)(2 * ks * wb), t > 0 || ks > 0);
      wgmma_commit();
      if (!resident) {
        // free the slot of the previous tap once its products are done; a
        // single slot is the next tap's too, so it is freed at once
        if (ws > 1) {
          wgmma_wait<1>();
          if (t > 0 && lane == 0) mbar_arrive(&bars->wempty[prev]);
        } else {
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(&bars->wempty[slot]);
        }
        prev = slot;
        ++it;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    if (!resident && ws > 1 && lane == 0) mbar_arrive(&bars->wempty[prev]);
    if (q >= nq) continue;  // the recomputed tile of an odd count
    // a wait covers only this warp's products: the others may still read buf
    named_bar_sync<128>(1 + wg);

    // epilogue: register i of an m-tile holds output channel 16 warp + lane/4
    // + 8 ((i >> 1) & 1), position 8 (i >> 2) + 2 (lane % 4) + (i & 1)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = 64 * mt + 16 * warp + (lane >> 2) + 8 * h;
        if (co >= C) continue;  // the zero rows of C = 32
#pragma unroll
        for (int n8 = 0; n8 < N / 8; ++n8)
          *reinterpret_cast<uint32_t*>(buf + staged<C>(co, 8 * n8 + 2 * (lane & 3))) =
              pack_bf16(acc[mt][4 * n8 + 2 * h], acc[mt][4 * n8 + 2 * h + 1]);
      }
    if (tma_y) {
      fence_proxy_async();
      named_bar_sync<128>(1 + wg);
      if (tid == 0) {
        for (int j = 0; j < N / 64; ++j)
          if (t0 + 64 * j < L_out)
            tma_store_3d(&map_y, buf + (size_t)j * C * 64, t0 + 64 * j, 0, b);
        bulk_commit();
      }
    } else {
      named_bar_sync<128>(1 + wg);
      bf16* yb = y + (size_t)b * C * L_out;
      for (int i = tid; i < C * N; i += 128) {
        const int co = i / N, n = i % N;
        if (t0 + n < L_out) yb[(size_t)co * L_out + t0 + n] = buf[staged<C>(co, n)];
      }
    }
  }
  if (tid == 0) bulk_wait<0>();
}

// A [B, C, length] bf16 tensor as a (length, C, B) tensor map whose box is 64
// positions x C channels, 128-byte swizzled, zero fill.
int make_map(CUtensorMap* map, const void* base, int length, int C, int B) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)length, (cuuint64_t)C, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)length * 2, (cuuint64_t)length * 2 * C};
  const cuuint32_t box[3] = {64, (cuuint32_t)C, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// Per device: the largest block allowed (set once per instantiation) and the
// number of SMs.
template <int C>
int prepare(int* sms) {
  static bool allowed[64] = {};
  static int count[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(dilated_conv_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
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

template <int C>
int launch(const void* x, const void* w, void* y, int B, int L, int L_out, int k, int d, int p,
           int wb, int wr, int xs, int ws, int ncw, cudaStream_t stream) {
  using S = Shape<C>;
  const long long halo = (long long)(k - 1) * d + 7;  // + the window's alignment
  if (wb % 32 || wb < S::N + halo || xs < 0 || xs > MAX_XS ||
      (xs > 0 && (wr % 64 || wr < wb || L % 8 || (uintptr_t)x % 16)) || ws < 1 ||
      (ws != k && ws > MAX_WS) || ws > k || ncw < 1 || ncw > NCW)
    return ERR_PLAN;
  const size_t smem = smem_bytes(C, wb, xs > 0 ? wr : 0, xs, ws, ncw);
  if (smem > SMEM_MAX) return ERR_PLAN;
  CUtensorMap mx = {}, my = {};
  if (xs > 0)
    if (int err = make_map(&mx, x, L, C, B)) return err;
  const int tma_y = L_out % 8 == 0 && (uintptr_t)y % 16 == 0;
  if (tma_y)
    if (int err = make_map(&my, y, L_out, C, B)) return err;
  int sms = 0;
  if (int err = prepare<C>(&sms)) return err;
  const int tiles_row = (L_out + S::N - 1) / S::N, n_tiles = B * tiles_row;
  const int grid = n_tiles < sms ? n_tiles : sms;
  dilated_conv_kernel<C><<<grid, NT, smem, stream>>>(mx, my, static_cast<const bf16*>(x),
                                     static_cast<const bf16*>(w), static_cast<bf16*>(y), L, L_out,
                                     k, d, p, n_tiles, tiles_row, wb, xs > 0 ? wr : 0, xs, ws,
                                     ncw, tma_y);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, C, L] bf16, contiguous. w: [k][C/8][max(C, 64)][8] bf16
// (ops/dilated_conv.py:pack_weights), 16-byte aligned. y: [B, C, L_out] bf16,
// contiguous, with L_out = L + 2p - d(k-1) >= 1. C is 32, 64 or 128. The plan
// (ops/dilated_conv.py:tile_plan): wb window positions a consumer buffer, wr
// a TMA stage, xs TMA stages a consumer (0: the consumers gather x; then wr
// is unused),
// ws weight slots (k: resident), ncw consumer warpgroups (1 or 2).
extern "C" int dilated_conv1d_fwd(const void* x, const void* w, void* y, int B, int C, int L,
                                  int L_out, int k, int d, int p, int wb, int wr, int xs, int ws,
                                  int ncw, void* stream) {
  if (B < 1 || L < 1 || L_out < 1 || k < 1 || d < 1 || p < 0 ||
      L_out != L + 2 * p - d * (k - 1) || (uintptr_t)w % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 32) return launch<32>(x, w, y, B, L, L_out, k, d, p, wb, wr, xs, ws, ncw, s);
  if (C == 64) return launch<64>(x, w, y, B, L, L_out, k, d, p, wb, wr, xs, ws, ncw, s);
  if (C == 128) return launch<128>(x, w, y, B, L, L_out, k, d, p, wb, wr, xs, ws, ncw, s);
  return (int)cudaErrorInvalidValue;
}
