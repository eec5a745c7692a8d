// Positional block attention for NVIDIA Hopper (sm_90a), bf16, on the
// tensor cores: block_attn_fwd_sm90, block_attn_dq_sm90 and
// block_attn_dkv_sm90, with wgmma products, TMA loads and an mbarrier ring.
//
// Replaces, for bfloat16 inputs, the TPU kernels of
// distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py that
// ring attention runs for every (Q-chunk, KV-chunk) block:
// `_pos_fwd_kernel` (:810, via `_block_fwd_call` :974), `_pos_dq_kernel`
// (:850, launched at :1030) and `_pos_dkv_kernel` (:878, launched at
// :1056); block_attn.cu keeps the f32 route. The function is
// block_attn.cu's, step for step:
//   * q (b*hq, tq, D), k, v (b*hkv, tk, D), q_pos (b, tq), kv_pos (b, tk)
//     int32 global positions; query row r of batch row n sees key c iff
//     q_pos[n, r] >= kv_pos[n, c];
//   * forward: s = q k^T * scale in f32, dead entries MASK (-1e30), online
//     softmax with m_safe = max(m_new, MASK/2), p rounded to bf16 before
//     p v (dead entries come out exactly 0: exp(<= MASK/2) underflows); o
//     normalized within the block, lse the f32 row logsumexp; a row that
//     sees no key gets o = 0 and lse = MASK;
//   * backward, given do and the f32 cotangent dlse of lse:
//     p = live ? exp(s - lse) : 0, ds = bf16(p (dp - delta + dlse) scale)
//     in that order, dq += ds k, dk += ds^T q, dv += bf16(p)^T do, with
//     delta = rowsum(do * o) from the caller;
//   * grouped-query attention by index: q row bh reads kv row
//     (bh / hq) * hkv + (bh % hq) / (hq / hkv) and position row bh / hq;
//     dk/dv of a kv head sum over its group inside one CTA: no atomics, the
//     same bits from run to run.
//
// Bound on the H100 at the 45m cp=2 path's shape, q and k halves
// (8, 8, 250, 64): a fully visible forward block moves ~8.3 MB, 2.5 us at
// 3.35 TB/s, against 1.02 GFLOP, 1.0 us at 989 TFLOP/s; the backward pair
// moves ~14.5 MB (4.3 us) for 2.6 GFLOP (2.6 us). All three are bound by
// bytes, and a block is small: 256 CTAs of 64 rows, one wave on 132 SMs,
// each walking four 64-key tiles. So the design spends little per CTA:
// tensor maps are encoded once per call in the C entry point (passed as
// __grid_constant__), Q (and dO) and the first two K/V stages are in
// flight at once, and nothing of size tq x tk reaches device memory.
//
// Design: flash_fwd_sm90.cu / flash_bwd_sm90.cu's CTA (160 threads: warp 4
// produces, warps 0-3 are one consumer warpgroup; 64-row TMA tiles through
// a 2-stage ring of `full` / `empty` mbarriers; S and dP by wgmma from
// shared memory, P and dS in registers as the A operand of the next
// product), plus a position skip decided once for both sides. The
// producer's 32 lanes copy the streamed tile's 64 positions (and, in
// dk/dv, its rows' lse, delta and dlse) into the stage, reduce them to
// [min, max] by shuffles and set the stage's mode against the CTA's own
// [min, max]:
//   dead  -- no row sees any key: no TMA is issued (0 bytes announced),
//            the consumers release the stage at once;
//   live  -- every row sees every key: no mask;
//   mixed -- the per-element position mask.
// All 32 lanes arrive on `full` (lane 0 with the TMA bytes, if any), so
// the consumers read the positions and the mode after the `full` wait and
// both sides walk the same tile list. Ragged edges: TMA zero-fills rows
// past tq and keys past tk; their positions are sentinels (pad rows
// INT_MIN, pad keys INT_MAX) that the mask reads as dead and that keep a
// ragged tile off the unmasked path, and their outputs are not stored.

#include <climits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlock = kTileRows;  // rows per tile
constexpr int kStages = 2;
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;
constexpr float kMask = -1e30f;
constexpr int kPadRow = INT_MIN;  // position of a query row past tq
constexpr int kPadKey = INT_MAX;  // position of a key past tk

enum Mode : int { kDead = 0, kMixed = 1, kLive = 2 };

// what a tile of rows with positions [q_lo, q_hi] sees of keys [k_lo, k_hi]
__device__ __forceinline__ int tile_mode(int q_lo, int q_hi, int k_lo,
                                         int k_hi) {
  if (q_hi < k_lo) return kDead;
  if (q_lo >= k_hi) return kLive;
  return kMixed;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// the producer lanes' [min, max] of the 64 positions from `pos` (n real
// entries, `pad` past them), each lane reading two; stored into `out` when
// given
__device__ __forceinline__ void tile_positions(const int* pos, int n, int pad,
                                               int lane, int* out, int* lo,
                                               int* hi) {
  int a = INT_MAX, z = INT_MIN;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = lane + 32 * e;
    const int p = c < n ? pos[c] : pad;
    if (out != nullptr) out[c] = p;
    a = min(a, p);
    z = max(z, p);
  }
  *lo = warp_min(a);
  *hi = warp_max(z);
}

// thread (warp w, lane l) of the consumer warpgroup holds accumulator rows
// 16 w + l / 4 + {0, 8} and columns 8 c + 2 (l % 4) + {0, 1}
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
}

// rows +0 and +8 of this thread's accumulator, bf16, into out (row-major,
// D columns); rows >= t are skipped
template <int D>
__device__ __forceinline__ void store_rows(const float* acc,
                                           __nv_bfloat16* out, int row0,
                                           int t, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= t) continue;
    __nv_bfloat16* p = out + (size_t)row * D + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(p + 8 * c) =
          pack_bf16(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
  }
}

// Per stage, beside its tiles: the streamed tile's positions, its mode and
// (dk/dv) its rows' lse, delta and dlse.
struct Meta {
  int pos[kBlock];
  float lse[kBlock];
  float delta[kBlock];
  float dlse[kBlock];
  int mode;
  int pad[3];
};

// `tiles` 64-row tiles, then the stages' Meta, then 1 + 2 kStages
// barriers; +1024 to align the base
constexpr int smem_bytes(int tile_bytes, int tiles) {
  return tile_bytes * tiles + static_cast<int>(sizeof(Meta)) * kStages +
         8 * (1 + 2 * kStages) + 1024;
}

struct Smem {
  uint8_t* base;
  Meta* meta;
  uint64_t* once;  // the tiles loaded once (Q [+ dO], or K + V)
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Smem carve(uint8_t* raw, int tile_bytes,
                                      int tiles) {
  Smem s;
  s.base = align1024(raw);
  s.meta = reinterpret_cast<Meta*>(s.base + tile_bytes * tiles);
  s.once = reinterpret_cast<uint64_t*>(s.meta + kStages);
  s.full = s.once + 1;
  s.empty = s.once + 1 + kStages;
  return s;
}

// barrier init by thread 0: `once` and the consumers' `empty` as usual;
// `full` takes the producer warp's 32 arrivals
__device__ __forceinline__ void init_barriers(const Smem& s) {
  if (threadIdx.x == 0) {
    mbar_init(s.once, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], 32);
      mbar_init(&s.empty[i], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// Producer of the kernels whose CTA owns 64 query rows (forward, dq): the
// rows' Q tile (and dO tile, when do_map is given) once, at the base, then
// every key tile through the ring with its positions and mode.
template <int D>
__device__ __forceinline__ void produce_keys(
    const Smem& sm, const CUtensorMap* q_map, const CUtensorMap* do_map,
    int q0, int bh, const CUtensorMap* k_map, const CUtensorMap* v_map,
    int kv_bh, const int* qp_b, int tq, const int* kp_b, int tk, int lane) {
  constexpr int kTile = Tile<D>::kBytes;
  const int once = do_map != nullptr ? 2 : 1;  // tiles before the ring
  int q_lo, q_hi;
  tile_positions(qp_b + q0, tq - q0, kPadRow, lane, nullptr, &q_lo, &q_hi);
  if (lane == 0) {
    mbar_arrive_tx(sm.once, once * kTile);
    tma_tile<D>(sm.base, q_map, sm.once, q0, bh);
    if (do_map != nullptr)
      tma_tile<D>(sm.base + kTile, do_map, sm.once, q0, bh);
  }
  const int n_kv = (tk + kBlock - 1) / kBlock;
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(&sm.empty[s], (j / kStages - 1) & 1);
    Meta* meta = &sm.meta[s];
    int k_lo, k_hi;
    tile_positions(kp_b + j * kBlock, tk - j * kBlock, kPadKey, lane,
                   meta->pos, &k_lo, &k_hi);
    const int mode = tile_mode(q_lo, q_hi, k_lo, k_hi);
    if (lane == 0) {
      meta->mode = mode;
      if (mode != kDead) {
        uint8_t* k_tile = sm.base + kTile * (once + 2 * s);
        mbar_arrive_tx(&sm.full[s], 2 * kTile);
        tma_tile<D>(k_tile, k_map, &sm.full[s], j * kBlock, kv_bh);
        tma_tile<D>(k_tile + kTile, v_map, &sm.full[s], j * kBlock, kv_bh);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    } else {
      mbar_arrive(&sm.full[s]);
    }
  }
}

template <int D>
constexpr int fwd_smem_bytes() {
  return smem_bytes(Tile<D>::kBytes, 1 + 2 * kStages);  // Q; K, V per stage
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    block_attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const int* __restrict__ q_pos,
                               const int* __restrict__ kv_pos,
                               __nv_bfloat16* __restrict__ o,
                               float* __restrict__ lse, int hq, int hkv,
                               int tq, int tk, float scale) {
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve(smem_raw, kTile, 1 + 2 * kStages);
  const int q0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int batch = bh / hq;
  const int kv_bh = batch * hkv + (bh % hq) / (hq / hkv);
  const int* qp_b = q_pos + (size_t)batch * tq;
  const int* kp_b = kv_pos + (size_t)batch * tk;
  init_barriers(sm);

  if (threadIdx.x >= kConsumers) {
    produce_keys<D>(sm, &q_map, nullptr, q0, bh, &k_map, &v_map, kv_bh,
                    qp_b, tq, kp_b, tk, threadIdx.x - kConsumers);
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp + lane / 4;  // this thread's rows: +0, +8
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qp[h] = row0 + 8 * h < tq ? qp_b[row0 + 8 * h] : kPadRow;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};

  mbar_wait(sm.once, 0);
  const uint8_t* q_tile = sm.base;
  const int n_kv = (tk + kBlock - 1) / kBlock;
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    const Meta* meta = &sm.meta[s];
    const int mode = meta->mode;
    if (mode == kDead) {
      mbar_arrive(&sm.empty[s]);
      continue;
    }
    const uint8_t* k_tile = sm.base + kTile * (1 + 2 * s);
    const uint8_t* v_tile = k_tile + kTile;
    float sc[32];
    wgmma_fence();
    mma_ss_tiles<D>(sc, smem_u32(q_tile), smem_u32(k_tile));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float x = sc[i] * scale;
      if (mode == kMixed && qp[h] < meta->pos[acc_col(i, lane)]) x = kMask;
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float m_safe[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      // rows that saw nothing yet keep MASK; the clamp stops
      // exp(MASK - MASK) = 1 from resurrecting their masked entries, and
      // alpha = exp(MASK - m_safe) is 0 for them
      m_safe[h] = fmaxf(mx[h], 0.5f * kMask);
      alpha[h] = expf(m[h] - m_safe[h]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      sc[i] = expf(sc[i] - m_safe[h]);
      psum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = alpha[h] * l[h] + quad_sum(psum[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[16];  // p in bf16, the A fragments of the 4 key k-steps
    to_a_frags(sc, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_tile<D>(acc, pa + 4 * kk, smem_u32(v_tile), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(acc);
    fence_regs<16>(pa);
    mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= tq) continue;
    const bool dead = l[h] == 0.f;  // the row sees no key of this block
    const float l_safe = dead ? 1.f : l[h];
    __nv_bfloat16* o_row = o + ((size_t)bh * tq + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(o_row + 8 * c) = pack_bf16(
          acc[4 * c + 2 * h] / l_safe, acc[4 * c + 2 * h + 1] / l_safe);
    if (lane % 4 == 0)
      lse[(size_t)bh * tq + row] = dead ? kMask : m[h] + logf(l_safe);
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  return smem_bytes(Tile<D>::kBytes, 2 + 2 * kStages);  // Q, dO; K, V
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    block_attn_dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const int* __restrict__ q_pos,
                              const int* __restrict__ kv_pos,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const float* __restrict__ dlse,
                              __nv_bfloat16* __restrict__ dq, int hq, int hkv,
                              int tq, int tk, float scale) {
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve(smem_raw, kTile, 2 + 2 * kStages);
  const int q0 = blockIdx.x * kBlock;
  const int bh = blockIdx.y;
  const int batch = bh / hq;
  const int kv_bh = batch * hkv + (bh % hq) / (hq / hkv);
  const int* qp_b = q_pos + (size_t)batch * tq;
  const int* kp_b = kv_pos + (size_t)batch * tk;
  init_barriers(sm);

  if (threadIdx.x >= kConsumers) {
    produce_keys<D>(sm, &q_map, &do_map, q0, bh, &k_map, &v_map, kv_bh,
                    qp_b, tq, kp_b, tk, threadIdx.x - kConsumers);
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp + lane / 4;
  int qp[2];
  float lse_r[2], delta_r[2], dlse_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool in = row < tq;
    const size_t r = (size_t)bh * tq + row;
    qp[h] = in ? qp_b[row] : kPadRow;
    lse_r[h] = in ? lse[r] : 0.f;
    delta_r[h] = in ? delta[r] : 0.f;
    dlse_r[h] = in ? dlse[r] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(sm.once, 0);
  const uint8_t* q_tile = sm.base;
  const uint8_t* do_tile = sm.base + kTile;
  const int n_kv = (tk + kBlock - 1) / kBlock;
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    mbar_wait(&sm.full[s], (j / kStages) & 1);
    const Meta* meta = &sm.meta[s];
    const int mode = meta->mode;
    if (mode == kDead) {
      mbar_arrive(&sm.empty[s]);
      continue;
    }
    const uint8_t* k_tile = sm.base + kTile * (2 + 2 * s);
    const uint8_t* v_tile = k_tile + kTile;
    float sc[32], dp[32];
    wgmma_fence();
    mma_ss_tiles<D>(sc, smem_u32(q_tile), smem_u32(k_tile));
    mma_ss_tiles<D>(dp, smem_u32(do_tile), smem_u32(v_tile));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);
    fence_regs<32>(dp);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const bool live =
          mode == kLive || qp[h] >= meta->pos[acc_col(i, lane)];
      const float p = live ? expf(sc[i] * scale - lse_r[h]) : 0.f;
      // ds, rounded below
      dp[i] = p * (dp[i] - delta_r[h] + dlse_r[h]) * scale;
    }
    uint32_t ds[16];
    to_a_frags(dp, ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_tile<D>(acc, ds + 4 * kk, smem_u32(k_tile), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(acc);
    fence_regs<16>(ds);
    mbar_arrive(&sm.empty[s]);
  }
  store_rows<D>(acc, dq + (size_t)bh * tq * D, row0, tq, lane);
}

template <int D>
constexpr int dkv_smem_bytes() {
  return smem_bytes(Tile<D>::kBytes, 2 + 2 * kStages);  // K, V; Q, dO
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    block_attn_dkv_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                               const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map,
                               const __grid_constant__ CUtensorMap do_map,
                               const int* __restrict__ q_pos,
                               const int* __restrict__ kv_pos,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const float* __restrict__ dlse,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int hq,
                               int hkv, int tq, int tk, float scale) {
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  const Smem sm = carve(smem_raw, kTile, 2 + 2 * kStages);
  const int k0 = blockIdx.x * kBlock;
  const int bkv = blockIdx.y;
  const int batch = bkv / hkv;
  const int group = hq / hkv;
  // query heads of this kv head: b*hq + hk*group + g (the TPU `_q_row`)
  const int bh0 = batch * hq + (bkv % hkv) * group;
  const int* qp_b = q_pos + (size_t)batch * tq;
  const int* kp_b = kv_pos + (size_t)batch * tk;
  const int n_q = (tq + kBlock - 1) / kBlock;
  const int n_items = n_q * group;  // every query tile of every group head
  init_barriers(sm);

  if (threadIdx.x >= kConsumers) {  // producer warp
    const int lane = threadIdx.x - kConsumers;
    int k_lo, k_hi;
    tile_positions(kp_b + k0, tk - k0, kPadKey, lane, nullptr, &k_lo, &k_hi);
    if (lane == 0) {
      mbar_arrive_tx(sm.once, 2 * kTile);
      tma_tile<D>(sm.base, &k_map, sm.once, k0, bkv);
      tma_tile<D>(sm.base + kTile, &v_map, sm.once, k0, bkv);
    }
    for (int n = 0; n < n_items; ++n) {
      const int s = n % kStages;
      const int bh = bh0 + n / n_q;
      const int r0 = (n % n_q) * kBlock;
      if (n >= kStages) mbar_wait(&sm.empty[s], (n / kStages - 1) & 1);
      Meta* meta = &sm.meta[s];
      int q_lo, q_hi;
      tile_positions(qp_b + r0, tq - r0, kPadRow, lane, meta->pos, &q_lo,
                     &q_hi);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lane + 32 * e;
        const bool in = r0 + c < tq;
        const size_t r = (size_t)bh * tq + r0 + c;
        meta->lse[c] = in ? lse[r] : 0.f;
        meta->delta[c] = in ? delta[r] : 0.f;
        meta->dlse[c] = in ? dlse[r] : 0.f;
      }
      const int mode = tile_mode(q_lo, q_hi, k_lo, k_hi);
      if (lane == 0) {
        meta->mode = mode;
        if (mode != kDead) {
          uint8_t* q_tile = sm.base + kTile * (2 + 2 * s);
          mbar_arrive_tx(&sm.full[s], 2 * kTile);
          tma_tile<D>(q_tile, &q_map, &sm.full[s], r0, bh);
          tma_tile<D>(q_tile + kTile, &do_map, &sm.full[s], r0, bh);
        } else {
          mbar_arrive(&sm.full[s]);
        }
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int key0 = k0 + 16 * warp + lane / 4;  // this thread's keys: +0, +8
  int kp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    kp[h] = key0 + 8 * h < tk ? kp_b[key0 + 8 * h] : kPadKey;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }

  mbar_wait(sm.once, 0);
  const uint8_t* k_tile = sm.base;
  const uint8_t* v_tile = sm.base + kTile;
  for (int n = 0; n < n_items; ++n) {
    const int s = n % kStages;
    mbar_wait(&sm.full[s], (n / kStages) & 1);
    const Meta* meta = &sm.meta[s];
    const int mode = meta->mode;
    if (mode == kDead) {
      mbar_arrive(&sm.empty[s]);
      continue;
    }
    const uint8_t* q_tile = sm.base + kTile * (2 + 2 * s);
    const uint8_t* do_tile = q_tile + kTile;
    float st[32], dpt[32];  // S^T and dP^T: rows are keys, columns rows
    wgmma_fence();
    mma_ss_tiles<D>(st, smem_u32(k_tile), smem_u32(q_tile));
    mma_ss_tiles<D>(dpt, smem_u32(v_tile), smem_u32(do_tile));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(st);
    fence_regs<32>(dpt);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int c = acc_col(i, lane);
      const bool live = mode == kLive || meta->pos[c] >= kp[h];
      const float p = live ? expf(st[i] * scale - meta->lse[c]) : 0.f;
      st[i] = p;
      // ds^T, rounded below
      dpt[i] = p * (dpt[i] - meta->delta[c] + meta->dlse[c]) * scale;
    }
    uint32_t pa[16], dsa[16];
    to_a_frags(st, pa);
    to_a_frags(dpt, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs_tile<D>(acc_dv, pa + 4 * kk, smem_u32(do_tile), kk);
      mma_rs_tile<D>(acc_dk, dsa + 4 * kk, smem_u32(q_tile), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(acc_dv);
    fence_regs<D / 2>(acc_dk);
    fence_regs<16>(pa);
    fence_regs<16>(dsa);
    mbar_arrive(&sm.empty[s]);
  }
  store_rows<D>(acc_dk, dk + (size_t)bkv * tk * D, key0, tk, lane);
  store_rows<D>(acc_dv, dv + (size_t)bkv * tk * D, key0, tk, lane);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* q_pos;
  const void* kv_pos;
  const void* dout;   // backward only
  const void* lse;    // backward only
  const void* delta;  // backward only
  const void* dlse;   // backward only
  void* out0;         // o, dq or dk
  void* out1;         // lse, unused or dv
  int b, hq, hkv, tq, tk;
  float scale;
  cudaStream_t stream;
};

enum class Kind { kFwd, kDq, kDkv };

template <Kind kKind, int D>
int launch(const Args& a) {
  CUtensorMap m[4];  // q, k, v, do
  int err = encode_map<D>(&m[0], a.q, a.tq, a.b * a.hq);
  if (err == 0) err = encode_map<D>(&m[1], a.k, a.tk, a.b * a.hkv);
  if (err == 0) err = encode_map<D>(&m[2], a.v, a.tk, a.b * a.hkv);
  if (err == 0 && kKind != Kind::kFwd)
    err = encode_map<D>(&m[3], a.dout, a.tq, a.b * a.hq);
  if (err != 0) return err;
  const auto pos = [](const void* p) { return static_cast<const int*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const auto bf16 = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  // the shared-memory allowance is set once per kernel and process (a
  // process drives one card), not on every call
  if constexpr (kKind == Kind::kFwd) {
    constexpr int kSmem = fwd_smem_bytes<D>();
    static const cudaError_t allowed = cudaFuncSetAttribute(
        block_attn_fwd_sm90_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    const dim3 grid((a.tq + kBlock - 1) / kBlock, a.b * a.hq);
    block_attn_fwd_sm90_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
        m[0], m[1], m[2], pos(a.q_pos), pos(a.kv_pos), bf16(a.out0),
        static_cast<float*>(a.out1), a.hq, a.hkv, a.tq, a.tk, a.scale);
  } else if constexpr (kKind == Kind::kDq) {
    constexpr int kSmem = dq_smem_bytes<D>();
    static const cudaError_t allowed = cudaFuncSetAttribute(
        block_attn_dq_sm90_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    const dim3 grid((a.tq + kBlock - 1) / kBlock, a.b * a.hq);
    block_attn_dq_sm90_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
        m[0], m[1], m[2], m[3], pos(a.q_pos), pos(a.kv_pos), f32(a.lse),
        f32(a.delta), f32(a.dlse), bf16(a.out0), a.hq, a.hkv, a.tq, a.tk,
        a.scale);
  } else {
    constexpr int kSmem = dkv_smem_bytes<D>();
    static const cudaError_t allowed = cudaFuncSetAttribute(
        block_attn_dkv_sm90_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    const dim3 grid((a.tk + kBlock - 1) / kBlock, a.b * a.hkv);
    block_attn_dkv_sm90_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
        m[0], m[1], m[2], m[3], pos(a.q_pos), pos(a.kv_pos), f32(a.lse),
        f32(a.delta), f32(a.dlse), bf16(a.out0), bf16(a.out1), a.hq, a.hkv,
        a.tq, a.tk, a.scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <Kind kKind>
int dispatch(const Args& a, int head_dim) {
  if (a.b < 1 || a.hq < 1 || a.hkv < 1 || a.hq % a.hkv != 0 || a.tq < 1 ||
      a.tk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 32:
      return launch<kKind, 32>(a);
    case 64:
      return launch<kKind, 64>(a);
    case 128:
      return launch<kKind, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes: bf16 q, do (b, hq, tq, D), k, v
// (b, hkv, tk, D), contiguous and 16-byte aligned; int32 positions; lse,
// delta and dlse f32 (b, hq, tq). Each launches on `stream`, does not
// synchronise, allocates nothing, and returns 0 when launched, else a CUDA
// error code. The arguments are block_attn.cu's, entry point for entry
// point.
extern "C" int block_attn_fwd_sm90(const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* kv_pos, void* o, void* lse,
                                   int b, int hq, int hkv, int tq, int tk,
                                   int head_dim, float scale, void* stream) {
  const Args a{q, k,   v, q_pos, kv_pos, nullptr, nullptr, nullptr, nullptr,
               o, lse, b, hq,    hkv,    tq,      tk,      scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Kind::kFwd>(a, head_dim);
}

extern "C" int block_attn_dq_sm90(const void* q, const void* k,
                                  const void* v, const void* q_pos,
                                  const void* kv_pos, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* dlse, void* dq, int b, int hq,
                                  int hkv, int tq, int tk, int head_dim,
                                  float scale, void* stream) {
  const Args a{q,  k,       v, q_pos, kv_pos, dout, lse, delta, dlse,
               dq, nullptr, b, hq,    hkv,    tq,   tk,  scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Kind::kDq>(a, head_dim);
}

extern "C" int block_attn_dkv_sm90(const void* q, const void* k,
                                   const void* v, const void* q_pos,
                                   const void* kv_pos, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* dlse, void* dk, void* dv,
                                   int b, int hq, int hkv, int tq, int tk,
                                   int head_dim, float scale, void* stream) {
  const Args a{q,  k,  v, q_pos, kv_pos, dout, lse, delta, dlse,
               dk, dv, b, hq,    hkv,    tq,   tk,  scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Kind::kDkv>(a, head_dim);
}
