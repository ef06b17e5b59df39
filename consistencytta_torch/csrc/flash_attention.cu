// Flash self-attention for Hopper (sm_90a): kernels K1 and K2 of the port.
//
// Replaces the JAX package's Pallas kernels
//   K1  consistencytta_tpu/ops/pallas_attention.py:flash_mha_packed
//       (_flash_packed_kernel, UNet self-attention on the packed
//       [B, S, H*64] projection layout), and
//   K2  consistencytta_tpu/ops/pallas_attention.py:flash_self_attention
//       (_flash_kernel, VAE mid-block attention, one head of width 512).
// Both compute non-causal, unmasked softmax(q k^T * scale) v with an fp32
// online softmax in base 2, and never write the [S, S] logits to memory.
//
// What bounds it on the H100: at the main path's shapes (S = 4096, 1024,
// 256, 64) the work is 4*S^2*d operations against ~4*S*d bytes, far above
// the card's ~295 operations per byte, so it is bound by operations, and
// only wgmma reaches the tensor cores' full rate. The design, both kernels:
//
//   - q, k, v are strided views of one fused projection. The C entry point
//     describes each as a 3-d tensor map (features, S, B; row and batch
//     strides in bytes) and TMA copies 64-column boxes of it into shared
//     memory in the 128-byte-swizzled layout wgmma reads. Rows at or beyond
//     S arrive as zeros; their logits are set to -1e30 before the max, and
//     query rows at or beyond S are never stored.
//   - A block is one to three consumer warpgroups and, last, the producer's:
//     one thread of it starts the q load once and keeps a ring of K/V stages
//     full, waiting on an "empty" mbarrier and completing a "full" one per
//     stage; it gives its registers away (setmaxnreg).
//   - Both products are wgmma with fp32 accumulators in registers. The
//     logits stay in the accumulator registers, the online softmax runs on
//     them there (row max and sum across the 4 lanes of a row by shuffles),
//     and the same registers, rounded to bf16, are the register A operand
//     of p v. V is read from its row-major tile through the MN-major
//     descriptor; there is no transposed copy.
//
// K1 (mha_packed_kernel, head width 64 = one 128-byte swizzle row): a block
// takes 64 query rows of one head per consumer warpgroup. Two shapes of the
// one kernel: S > 1024 goes to three consumer warpgroups (192 rows) against
// key tiles of 128 rows, one block an SM, grid (ceil(S / 192), H, B);
// S <= 1024 to one consumer warpgroup against key tiles of 64 rows, three
// blocks an SM, grid (ceil(S / 64), H, B). A warpgroup whose 64 rows all lie
// beyond S leaves at once. What is left between it and the bound: the
// softmax's exp2 (64 a thread and tile on 16 special-function lanes an SM)
// takes as many cycles as the two products, and they overlap only in part.
//
// K2 (self_attention_kernel, one head, D = 512): a block takes 64 query
// rows; q stays in shared memory (64 KB) and K/V tiles are 32 rows, two
// stages (32 KB each). The 64 x 512 fp32 output is split by columns over the
// two consumer warpgroups (128 registers a thread). Each warpgroup reduces
// q k^T over its half of D, the two exchange their partial logits through
// shared memory (double-buffered, one named barrier a tile) and add them, so
// q k^T is computed once; both then hold the same probabilities and multiply
// them by their half of V's columns. What is left between it and the bound,
// by count: q k^T re-reads the 64 KB q tile from shared memory for every
// 32-key tile, 96 KB of operand reads a tile, 768 cycles at 128 B a cycle
// against 512 on the tensor cores, and a wider key tile does not fit beside
// q; both warpgroups meet at the exchange every tile, so neither's softmax
// runs under the other's products; and with 64 query rows a block every key
// costs 2 KB of K and V from L2 (128 rows of 512 fp32 columns would be the
// whole register file).
//
// Schedule of a consumer warpgroup, both kernels: tile j's q k^T and tile
// j - 1's p v are started together; the softmax of tile j runs while p v is
// still in flight, and the K tile goes back to the producer as soon as
// q k^T has read it (K and V have barriers of their own).
//
// Compile with -DFA_BOUNDED_WAIT to let a wait on an mbarrier give up after
// 2^24 polls: a wrong phase then gives wrong numbers instead of a hung card.

#include "hopper_async.cuh"  // with cuda.h's CUtensorMap and encode_tiled

namespace {

constexpr float NEG = -1e30f;
constexpr int ROW_BYTES = 128; // one 64-column bf16 row of a tile

// One step of the online softmax (base 2) on a warpgroup's logits of one key
// tile. Accumulator register i of a thread holds row (i >> 1) & 1 (rows g and
// g + 8 of its warp's 16) and key column 8 * (i >> 2) + 2 * t4 + (i & 1).
// With MASKED, only `valid` keys of the tile exist and the others get -1e30.
// On return s holds the probabilities exp2(logit * scale - m) and l the
// running sums of this lane. The reference maxima m (already scaled) move
// only when some row of the warp found a logit more than 8 above its m, so
// a probability stays below 2^8 and what was accumulated so far is rescaled
// (by alpha, when the function returns true; the same for all of a warp)
// on few tiles instead of all: the result is the same softmax, o / l.
constexpr float M_SLACK = 8.f;

template <bool MASKED, int NS>
__device__ __forceinline__ bool softmax_tile(float (&s)[NS], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2,
                                             int valid, int t4) {
  if (MASKED) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (8 * (i >> 2) + 2 * t4 + (i & 1) >= valid) s[i] = NEG;
  }
  // four partial maxima (and sums, below) a row: short dependency chains
  float part[2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) part[(i >> 1) & 1][i >> 2 | (i & 1) << 1] = s[i];
#pragma unroll
  for (int i = 8; i < NS; ++i) {
    float& a = part[(i >> 1) & 1][((i >> 2) & 1) | (i & 1) << 1];
    a = fmaxf(a, s[i]);
  }
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] *= scale_log2;
  }
  const bool moved =
      __any_sync(0xffffffffu, mx[0] > m[0] + M_SLACK || mx[1] > m[1] + M_SLACK);
  if (moved) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2(m[r] - mx[r]);
      l[r] *= alpha[r];
      m[r] = mx[r];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[r][c] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    s[i] = fast_exp2(fmaf(s[i], scale_log2, -m[(i >> 1) & 1]));
    part[(i >> 1) & 1][((i >> 2) & 1) | (i & 1) << 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] += (part[r][0] + part[r][1]) + (part[r][2] + part[r][3]);
  return moved;
}

// The ragged last tile takes the masked form; it is a branch of its own so
// that full tiles carry no compare and select per logit.
template <int NS>
__device__ __forceinline__ bool softmax_step(float (&s)[NS], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale_log2,
                                             int valid, int t4) {
  if (valid < 2 * NS) return softmax_tile<true>(s, m, l, alpha, scale_log2, valid, t4);
  return softmax_tile<false>(s, m, l, alpha, scale_log2, valid, t4);
}

// The probabilities of 16 keys as the register A operand of p v.
template <int NS>
__device__ __forceinline__ void pack_p(const float (&s)[NS], int kk, uint32_t (&p)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) p[e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// Divide a warpgroup's output accumulator by the row sums and store it.
// `ob` points at the block's first row and the warpgroup's first column.
template <int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO], float (&l)[2], bf16* ob,
                                           long long ldo, int row0, int S, int warp,
                                           int g, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row0 + row >= S) continue;
    bf16* dst = ob + (long long)row * ldo + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO / 4; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] * l[r], o[4 * n + 2 * r + 1] * l[r]);
  }
}

// ---------------------------------------------------------------------------
// The K/V ring: a "full" and an "empty" mbarrier for K and for V of every
// stage, so that a K tile is given back as soon as q k^T has read it. Use u
// of a stage (u = tile / STAGES) is the barrier's phase u: a consumer waits
// for full with parity u & 1, the producer for empty with parity (u & 1) ^ 1,
// which passes at once on the first use.

template <int STAGES>
struct Ring {
  uint64_t q;
  uint64_t full_k[STAGES], full_v[STAGES], empty_k[STAGES], empty_v[STAGES];

  __device__ void init(int consumer_warps) {
    mbar_init(&q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], consumer_warps);
      mbar_init(&empty_v[s], consumer_warps);
    }
    mbar_fence_init();
  }
};

// ---------------------------------------------------------------------------
// A consumer warpgroup's loop over the key tiles, shared by K1 and K2.
//   start_qk(s, stage)  starts s = q k^T against the K tile of `stage`
//   start_pv(p, stage)  starts oacc += p v against the V tile of `stage`
//   exchange(s, j)      completes tile j's logits (K2 adds the other half)
// Each start leaves one committed group in flight. Tile j's q k^T and tile
// j - 1's p v are started together; the softmax of tile j runs while that p v
// is still in flight. On return oacc holds the unnormalised output and l this
// lane's row sums.

template <int BK, int STAGES, int NO, class QK, class PV, class X>
__device__ __forceinline__ void attend(Ring<STAGES>& ring, int n_tiles, int S,
                                       float scale_log2, int lane, float (&oacc)[NO],
                                       float (&l)[2], QK start_qk, PV start_pv, X exchange) {
  const int t4 = lane & 3;
  float s[BK / 2];
  uint32_t p[BK / 16][4];
  float m[2] = {NEG, NEG}, alpha[2];

  mbar_wait(&ring.q, 0);
  mbar_wait(&ring.full_k[0], 0);
  wgmma_fence();
  start_qk(s, 0);
  wgmma_wait<0>();
  fence_regs(s);
  if (lane == 0) mbar_arrive(&ring.empty_k[0]);
  exchange(s, 0);
  softmax_step(s, m, l, alpha, scale_log2, S, t4);  // oacc is still zero
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) pack_p(s, kk, p[kk]);

  for (int j = 1; j < n_tiles; ++j) {
    const int stage = j % STAGES, prev = (j - 1) % STAGES;
    mbar_wait(&ring.full_k[stage], (j / STAGES) & 1);
    wgmma_fence();
    start_qk(s, stage);
    mbar_wait(&ring.full_v[prev], ((j - 1) / STAGES) & 1);
    start_pv(p, prev);
    wgmma_wait<1>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&ring.empty_k[stage]);
    exchange(s, j);
    const bool moved = softmax_step(s, m, l, alpha, scale_log2, S - j * BK, t4);
    wgmma_wait<0>();
    fence_regs(oacc);
    fence_regs(p);
    if (lane == 0) mbar_arrive(&ring.empty_v[prev]);
    if (moved) {
#pragma unroll
      for (int i = 0; i < NO; ++i) oacc[i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) pack_p(s, kk, p[kk]);
  }
  const int last = (n_tiles - 1) % STAGES;
  mbar_wait(&ring.full_v[last], ((n_tiles - 1) / STAGES) & 1);
  wgmma_fence();
  start_pv(p, last);
  wgmma_wait<0>();
  fence_regs(oacc);
}

// ---------------------------------------------------------------------------
// K1: packed multi-head attention, head width 64. NC consumer warpgroups of
// 64 query rows each, key tiles of BK rows, MIN_BLOCKS blocks an SM; the
// producer keeps PRODUCER_REGS registers a thread, a consumer CONSUMER_REGS.

template <int BK, int STAGES, int NC>
struct K1Smem {
  static constexpr int q = 0;                                // 64 * NC rows
  static constexpr int k = q + 64 * NC * ROW_BYTES;          // STAGES tiles of BK rows
  static constexpr int v = k + STAGES * BK * ROW_BYTES;
  static constexpr int ring = v + STAGES * BK * ROW_BYTES;
  static constexpr int bytes = ring + (int)sizeof(Ring<STAGES>) + 1024;
};

template <int BK, int STAGES, int NC, int MIN_BLOCKS, int PRODUCER_REGS, int CONSUMER_REGS>
__global__ void __launch_bounds__((NC + 1) * 128, MIN_BLOCKS)
mha_packed_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, int S,
                  long long ldo, long long bso, float scale_log2) {
  using L = K1Smem<BK, STAGES, NC>;
  constexpr int TILE = BK * ROW_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  Ring<STAGES>& ring = *reinterpret_cast<Ring<STAGES>*>(smem + L::ring);

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * (64 * NC);
  const int head = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (S + BK - 1) / BK;
  // consumer warpgroups with a row below S; the others leave at once
  const int consumers = min(NC, (S - q0 + 63) / 64);

  if (threadIdx.x == 0) ring.init(4 * consumers);
  __syncthreads();

  if (wg == NC) {
    reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == NC * 128) {
      mbar_arrive_expect_tx(&ring.q, 64 * NC * ROW_BYTES);
      tma_load_3d(smem + L::q, &map_q, &ring.q, head * 64, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int stage = j % STAGES, parity = ((j / STAGES) & 1) ^ 1;
        mbar_wait(&ring.empty_k[stage], parity);
        mbar_arrive_expect_tx(&ring.full_k[stage], TILE);
        tma_load_3d(smem + L::k + stage * TILE, &map_k, &ring.full_k[stage], head * 64,
                    j * BK, b);
        mbar_wait(&ring.empty_v[stage], parity);
        mbar_arrive_expect_tx(&ring.full_v[stage], TILE);
        tma_load_3d(smem + L::v + stage * TILE, &map_v, &ring.full_v[stage], head * 64,
                    j * BK, b);
      }
    }
  } else {
    reg_alloc<CONSUMER_REGS>();
    const int row0 = q0 + wg * 64;
    if (row0 >= S) return;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;

    float oacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
    float l[2] = {0.f, 0.f};
    const uint64_t dq = wgmma_desc(smem_u32(smem + L::q) + wg * 64 * ROW_BYTES, 16, 1024);
    const uint64_t dk0 = wgmma_desc(smem_u32(smem + L::k), 16, 1024);
    const uint64_t dv0 = wgmma_desc(smem_u32(smem + L::v), 16, 1024);

    auto start_qk = [&](float (&s)[BK / 2], int stage) {
      const uint64_t dk = dk0 + stage * (TILE >> 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
      wgmma_commit();
    };
    auto start_pv = [&](const uint32_t (&p)[BK / 16][4], int stage) {
      const uint64_t dv = dv0 + stage * (TILE >> 4);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_n64(oacc, p[kk], dv + kk * (16 * ROW_BYTES >> 4));
      wgmma_commit();
    };
    attend<BK>(ring, n_tiles, S, scale_log2, lane, oacc, l, start_qk, start_pv,
               [](float (&)[BK / 2], int) {});
    store_rows(oacc, l, o + (long long)b * bso + (long long)row0 * ldo + head * 64, ldo,
               row0, S, warp, g, t4);
  }
}

// ---------------------------------------------------------------------------
// K2: one head of width 512

constexpr int K2_D = 512, K2_BK = 32, K2_STAGES = 2, K2_CHUNKS = K2_D / 64;
constexpr int K2_Q_CHUNK = 64 * ROW_BYTES;      // one 64-column chunk of the q tile
constexpr int K2_KV_CHUNK = K2_BK * ROW_BYTES;  // ... of a K or V tile
constexpr int K2_KV_TILE = K2_CHUNKS * K2_KV_CHUNK;

struct K2Smem {
  static constexpr int q = 0;
  static constexpr int k = q + K2_CHUNKS * K2_Q_CHUNK;
  static constexpr int v = k + K2_STAGES * K2_KV_TILE;
  static constexpr int x = v + K2_STAGES * K2_KV_TILE;  // partial logits [2][2][16][128] fp32
  static constexpr int ring = x + 2 * 2 * 16 * 128 * 4;
  static constexpr int bytes = ring + (int)sizeof(Ring<K2_STAGES>) + 1024;
};

constexpr int K2_THREADS = 384;  // two consumer warpgroups and the producer's

__global__ void __launch_bounds__(K2_THREADS, 1)
self_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                      int S, long long ldo, long long bso, float scale_log2) {
  using L = K2Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  Ring<K2_STAGES>& ring = *reinterpret_cast<Ring<K2_STAGES>*>(smem + L::ring);

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * 64, b = blockIdx.y;
  const int n_tiles = (S + K2_BK - 1) / K2_BK;

  if (threadIdx.x == 0) ring.init(8);
  __syncthreads();

  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == 256) {
      mbar_arrive_expect_tx(&ring.q, K2_CHUNKS * K2_Q_CHUNK);
      for (int c = 0; c < K2_CHUNKS; ++c)
        tma_load_3d(smem + L::q + c * K2_Q_CHUNK, &map_q, &ring.q, c * 64, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int stage = j % K2_STAGES, parity = ((j / K2_STAGES) & 1) ^ 1;
        mbar_wait(&ring.empty_k[stage], parity);
        mbar_arrive_expect_tx(&ring.full_k[stage], K2_KV_TILE);
        for (int c = 0; c < K2_CHUNKS; ++c)
          tma_load_3d(smem + L::k + stage * K2_KV_TILE + c * K2_KV_CHUNK, &map_k,
                      &ring.full_k[stage], c * 64, j * K2_BK, b);
        mbar_wait(&ring.empty_v[stage], parity);
        mbar_arrive_expect_tx(&ring.full_v[stage], K2_KV_TILE);
        for (int c = 0; c < K2_CHUNKS; ++c)
          tma_load_3d(smem + L::v + stage * K2_KV_TILE + c * K2_KV_CHUNK, &map_v,
                      &ring.full_v[stage], c * 64, j * K2_BK, b);
      }
    }
  } else {
    reg_alloc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    constexpr int HALF = K2_CHUNKS / 2;  // this warpgroup's chunks of D

    float oacc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) oacc[i] = 0.f;
    float l[2] = {0.f, 0.f};
    // descriptors of this warpgroup's half of q, of K and of V (stage 0); every
    // other one is a constant away. V: 4 chunks of 64 columns, a chunk apart.
    const uint64_t dq0 =
        wgmma_desc(smem_u32(smem + L::q) + wg * HALF * K2_Q_CHUNK, 16, 1024);
    const uint64_t dk0 =
        wgmma_desc(smem_u32(smem + L::k) + wg * HALF * K2_KV_CHUNK, 16, 1024);
    const uint64_t dv0 =
        wgmma_desc(smem_u32(smem + L::v) + wg * HALF * K2_KV_CHUNK, K2_KV_CHUNK, 1024);
    float* xbuf = reinterpret_cast<float*>(smem + L::x);

    // s = this warpgroup's half of the reduction over D
    auto start_qk = [&](float (&s)[K2_BK / 2], int stage) {
      const uint64_t dk = dk0 + stage * (K2_KV_TILE >> 4);
#pragma unroll
      for (int c = 0; c < HALF; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss(s, dq0 + (c * (K2_Q_CHUNK >> 4) + 2 * kk),
                   dk + (c * (K2_KV_CHUNK >> 4) + 2 * kk), (c | kk) != 0);
      wgmma_commit();
    };
    auto start_pv = [&](const uint32_t (&p)[K2_BK / 16][4], int stage) {
      const uint64_t dv = dv0 + stage * (K2_KV_TILE >> 4);
#pragma unroll
      for (int kk = 0; kk < K2_BK / 16; ++kk)
        wgmma_rs_n256(oacc, p[kk], dv + kk * (16 * ROW_BYTES >> 4));
      wgmma_commit();
    };
    // add the other warpgroup's half: the same thread there holds the same
    // rows and keys, and a + b == b + a, so both get the same logits. Two
    // buffers in turn, so one named barrier a tile is enough.
    auto exchange = [&](float (&s)[K2_BK / 2], int j) {
      float* mine = xbuf + ((j & 1) * 2 + wg) * (16 * 128) + tid;
      const float* theirs = xbuf + ((j & 1) * 2 + (wg ^ 1)) * (16 * 128) + tid;
#pragma unroll
      for (int i = 0; i < K2_BK / 2; ++i) mine[i * 128] = s[i];
      named_bar_sync<256>(1);
#pragma unroll
      for (int i = 0; i < K2_BK / 2; ++i) s[i] += theirs[i * 128];
    };
    attend<K2_BK>(ring, n_tiles, S, scale_log2, lane, oacc, l, start_qk, start_pv, exchange);
    store_rows(oacc, l, o + (long long)b * bso + (long long)q0 * ldo + wg * 256, ldo, q0, S,
               warp, g, t4);
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launches

constexpr int ERR_NO_ENCODER = 2000;  // libcuda has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 3000;      // + the CUresult of a refused tensor map

// A [B, S, width] bf16 view with strides in bytes as a (width, S, B) tensor
// map whose box is 64 columns x `box_rows` rows, 128-byte swizzled, zero fill.
int make_map(CUtensorMap* map, const void* base, int width, int S, int B, long long row_bytes,
             long long batch_bytes, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)batch_bytes};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

// Lets a kernel take `bytes` of dynamic shared memory: an attribute of the
// kernel on one device, so it is set once per device, not once per process.
struct SmemOnce {
  bool done[64] = {};
  template <class Kernel>
  cudaError_t allow(Kernel kernel, int bytes) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess || (device < 64 && done[device])) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && device < 64) done[device] = true;
    return err;
  }
};

template <int BK, int STAGES, int NC, int MIN_BLOCKS, int PRODUCER_REGS, int CONSUMER_REGS>
struct K1Config {
  static constexpr auto kernel =
      mha_packed_kernel<BK, STAGES, NC, MIN_BLOCKS, PRODUCER_REGS, CONSUMER_REGS>;
  static constexpr int smem = K1Smem<BK, STAGES, NC>::bytes;
  static constexpr int rows = 64 * NC, keys = BK, threads = (NC + 1) * 128;
};
// Long S: three consumer warpgroups (192 query rows) against 128-key tiles,
// one block an SM; the register file is 128 * 24 + 384 * 160 = 64512. Three
// warpgroups, not two, so that two can be in their softmax while the third
// has the tensor cores. Short S: one consumer warpgroup (64 query rows)
// against 64-key tiles, three blocks an SM (256 * 80 registers each), so that
// one block's start and end hide behind the others' work.
using K1Long = K1Config<128, 2, 3, 1, 24, 160>;
using K1Short = K1Config<64, 2, 1, 3, 24, 136>;
constexpr int K1_SHORT_MAX = 1024;  // the longest S that goes to K1Short

template <class C>
int launch_mha_packed(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int heads, const long long* row_bytes, const long long* batch_bytes,
                      float scale_log2, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, heads * 64, S, B, row_bytes[0], batch_bytes[0], C::rows);
  if (!err) err = make_map(&mk, k, heads * 64, S, B, row_bytes[1], batch_bytes[1], C::keys);
  if (!err) err = make_map(&mv, v, heads * 64, S, B, row_bytes[2], batch_bytes[2], C::keys);
  if (err) return err;
  static SmemOnce once;  // per instantiation
  if (cudaError_t cerr = once.allow(C::kernel, C::smem)) return (int)cerr;
  dim3 grid((S + C::rows - 1) / C::rows, heads, B);
  auto kernel = C::kernel;
  kernel<<<grid, C::threads, C::smem, stream>>>(mq, mk, mv, static_cast<bf16*>(o), S,
                                                row_bytes[3] / 2, batch_bytes[3] / 2, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: packed multi-head layout. q/k/v/o rows hold `heads` heads of width
// d == 64. row_bytes and batch_bytes: the strides of q, k, v, o in bytes.
extern "C" int flash_mha_packed_fwd(const void* q, const void* k, const void* v, void* o,
                                    int B, int S, int heads, int d,
                                    const long long* row_bytes, const long long* batch_bytes,
                                    float scale_log2, void* stream) {
  if (d != 64 || B < 1 || S < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  if (S <= K1_SHORT_MAX)
    return launch_mha_packed<K1Short>(q, k, v, o, B, S, heads, row_bytes, batch_bytes,
                                      scale_log2, (cudaStream_t)stream);
  return launch_mha_packed<K1Long>(q, k, v, o, B, S, heads, row_bytes, batch_bytes, scale_log2,
                                   (cudaStream_t)stream);
}

// K2: one head of width D == 512.
extern "C" int flash_self_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int B, int S, int D, const long long* row_bytes,
                                        const long long* batch_bytes, float scale_log2,
                                        void* stream) {
  if (D != K2_D || B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, D, S, B, row_bytes[0], batch_bytes[0], 64);
  if (!err) err = make_map(&mk, k, D, S, B, row_bytes[1], batch_bytes[1], K2_BK);
  if (!err) err = make_map(&mv, v, D, S, B, row_bytes[2], batch_bytes[2], K2_BK);
  if (err) return err;
  static SmemOnce once;
  if (cudaError_t cerr = once.allow(self_attention_kernel, K2Smem::bytes)) return (int)cerr;
  dim3 grid((S + 63) / 64, B);
  self_attention_kernel<<<grid, K2_THREADS, K2Smem::bytes, (cudaStream_t)stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), S, row_bytes[3] / 2, batch_bytes[3] / 2, scale_log2);
  return (int)cudaGetLastError();
}

// What the build gave each kernel, for the record: per kernel (K1 long, K1
// short, K2) registers a thread, bytes of local memory a thread (spills),
// static and dynamic shared memory a block, threads a block: 15 ints.
extern "C" int flash_attention_resources(int* out) {
  const void* kernels[3] = {(const void*)K1Long::kernel, (const void*)K1Short::kernel,
                            (const void*)self_attention_kernel};
  const int dynamic[3] = {K1Long::smem, K1Short::smem, K2Smem::bytes};
  const int threads[3] = {K1Long::threads, K1Short::threads, K2_THREADS};
  for (int i = 0; i < 3; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernels[i]);
    if (err != cudaSuccess) return (int)err;
    out[5 * i + 0] = attr.numRegs;
    out[5 * i + 1] = (int)attr.localSizeBytes;
    out[5 * i + 2] = (int)attr.sharedSizeBytes;
    out[5 * i + 3] = dynamic[i];
    out[5 * i + 4] = threads[i];
  }
  return 0;
}
