// Paged attention, chunk route (cw > 1, bf16 q), for NVIDIA Hopper (sm_90a),
// on the tensor cores: wgmma products, a loader warpgroup walking the page
// table, an mbarrier ring.
//
// Replaces the TPU kernel `_paged_kernel` in
// distributed_pytorch_from_scratch_tpu/ops/pallas/paged_attention.py:95 (row
// 9b of PERF.md's kernel table) where it runs a prefill chunk of cw > 1 query
// columns per request in bf16. The wrapper `ops/cuda/paged_attention.py`
// picks the source by `kernel_route`: decode steps (cw = 1) go to
// paged_decode.cu, f32 chunks to the SIMT paged_attn.cu. Same function as the
// Pallas kernel and as paged_attn.cu, not the same blocking:
//   * Rows: q (b, h, cw, hd) is read as (b, kv_heads, R = g*cw, hd), so row r
//     of kv head kv is query head kv*g + r / cw at position
//     qpos = start[b] + r % cw. Grouped-query heads share their kv head's
//     pages; K/V are never repeated.
//   * Keys: page-table column j, offset t sits at kpos = pos_offset + j*ps + t
//     and is live for a row iff kpos <= qpos. Pages wholly past
//     vmax = start + max(qlen, 1) - 1 (start + cw - 1 without qlen) are never
//     read. Page ids clamp into [0, n_pool_pages - 1], as the TPU gather
//     clamps.
//   * s = q . k * scale in f32 (bf16 x bf16 products are exact in wgmma's f32
//     accumulator); an int8 key's codes convert exactly to bf16 (|code| <=
//     127) and its scale multiplies s's column. s = -1e30 on dead keys,
//     m_safe = max(m_new, -1e30 / 2), p = live ? exp(s - m_safe) : 0 (by
//     predicate, not by underflow), taken as 2^((s - m_safe) log2 e) on the
//     SFU (relative error below 2^-22). The TPU kernel keeps p and v in f32
//     for p . v, so p (times an int8 value's scale) is split into two bf16
//     terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both are
//     multiplied by V: what is left, |p - p_hi - p_lo| <= 2^-17 p, is far
//     below one bf16 step of o. o = acc / (l == 0 ? 1 : l) (times the
//     row's reciprocal) rounded once to bf16; lse = l == 0 ? -1e30 :
//     m + log(l), f32. A row that sees nothing gets o = 0 and lse = -1e30
//     exactly.
//
// Bound on the H100 (chip_smoke.bound_paged: the K and V of the keys a row
// sees read once, the valid q read and o written once, over 3.35 TB/s; 4*hd
// operations per (query, visible key) pair over 989 TFLOP/s): at the chunk
// shape q (1, 8, 128, 64) starting at position 256, page_size 64, bf16, 1.05
// MB, 0.31 us, against 0.08 us of operations: bytes-bound and tiny. What
// sets the time is the walk: each kv head's keys are read in order, page by
// page, by few blocks.
//
// What this design does about it. One CTA per (64-row tile of the R stacked
// rows, kv head, batch row), so every K/V tile read feeds 64 rows of
// products. Its walk ends at the tile's own last visible key
// (min(walk end, max qpos of its rows - pos_offset + 1)), not at the chunk's:
// a causal stop per row tile. Warpgroup 1 is the loader: it loads the Q
// tile and stages the page table in shared memory without waiting for
// start[b], then for each tile of 64 keys reads K and V as 16-byte vectors,
// one key's vectors by neighbouring threads (page looked up per key, so a
// tile may span pages and a page tiles), converts int8 codes to bf16, and
// stores them in Tile<D>'s swizzled layout (sm90::tile_chunk) into a 2-stage
// ring; tile j's loads go out before it waits for the stage to free, so they
// overlap the consumers' work on tile j - 1. Keys past the tile's walk end
// are stored as zeros (no stale bits reach p . v, where 0 x NaN = NaN).
// Warpgroup 0 runs S = Q K^T (wgmma, A and B from shared memory), the online
// softmax on the f32 accumulators, and O += P_hi V + P_lo V (wgmma with P in
// registers, V MN-major). Only tiles that cross the diagonal or the walk's
// end are masked, by selects: the loader's index math, the mask and the
// exponentials are straight-line code, since a branch per element
// serialises them. No atomics and a fixed order: two calls give the same
// bits.

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlock = kTileRows;  // stacked rows per CTA, keys per K/V tile
constexpr int kStages = 2;
constexpr int kConsumers = 128;  // warpgroup 0: the products
constexpr int kLoaders = 128;    // warpgroup 1: the page walk
constexpr int kThreads = kConsumers + kLoaders;
constexpr float kMask = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxSmem = 232448;  // the most shared memory a block may take

// Q, then K and V per stage, then the int8 scales of each stage's keys and
// the barriers; +1024 to align the base. The page ids follow (mp ints).
template <int D>
constexpr int fixed_smem() {
  return 1024 + Tile<D>::kBytes * (1 + 2 * kStages) +
         2 * kStages * kBlock * 4 + 8 * (1 + 2 * kStages);
}

// A loader thread's share of one K/V tile: item i is 16-byte vector
// (t + i kLoaders) % kVpk of key (t + i kLoaders) / kVpk, in K and in V.
template <typename TKV, int D>
struct Share {
  static constexpr int kElems = 16 / sizeof(TKV);  // 8 bf16 or 16 int8 codes
  static constexpr int kVpk = D / kElems;          // vectors per key
  static constexpr int kPer = kBlock * kVpk / kLoaders;
  static_assert(kPer >= 1 && kBlock * kVpk % kLoaders == 0, "share");
  uint4 k[kPer];
  uint4 v[kPer];
  float ks[kPer];
  float vs[kPer];
};

// 2^x on the SFU (relative error below 2^-22; 0 for x <= -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// bf16 of the int8 codes in bytes 2 half, 2 half + 1 of w, packed (exact)
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w, int half) {
  const int sh = 16 * half;
  return pack_bf16(
      static_cast<float>(static_cast<int8_t>((w >> sh) & 0xffu)),
      static_cast<float>(static_cast<int8_t>((w >> (sh + 8)) & 0xffu)));
}

// TKV: the pool (bf16, or int8 codes with f32 scales, one per head-vector,
// in k_scale / v_scale); q and o are bf16.
template <typename TKV, int D>
__global__ void __launch_bounds__(kThreads, 1)
    paged_chunk_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                            const TKV* __restrict__ k_pool,
                            const TKV* __restrict__ v_pool,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ tbl,
                            const int* __restrict__ start,
                            const int* __restrict__ qlen,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int kvh, int R, int cw,
                            int ps, int mp, int n_pool_pages, int pos_offset,
                            float scale) {
  using S = Share<TKV, D>;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* q_tile = smem;
  auto k_tile = [&](int s) { return smem + kTile * (1 + 2 * s); };
  auto v_tile = [&](int s) { return smem + kTile * (2 + 2 * s); };
  float* ks_s = reinterpret_cast<float*>(smem + kTile * (1 + 2 * kStages));
  float* vs_s = ks_s + kStages * kBlock;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs_s + kStages * kBlock);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  int* tbl_s = reinterpret_cast<int*>(bars + 1 + 2 * kStages);

  const int r0 = blockIdx.x * kBlock;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int st = start[b];
  const int vmax = st + (qlen != nullptr ? max(qlen[b], 1) : cw) - 1;
  // keys of logical index < walk_end lie on the row's live pages
  const int n_live =
      vmax < pos_offset ? 0 : min(mp, (vmax - pos_offset) / ps + 1);
  const int walk_end = n_live * ps;
  // this tile's query columns [c_lo, c_hi] (all of them if it spans heads):
  // no row sees a key at or past key_end; every row sees every key below
  // full_end
  const int r_last = min(r0 + kBlock, R) - 1;
  const bool spans = r0 / cw != r_last / cw;
  const int c_lo = spans ? 0 : r0 % cw;
  const int c_hi = spans ? cw - 1 : r_last % cw;
  const int key_end = max(0, min(walk_end, st + c_hi - pos_offset + 1));
  const int full_end = max(0, min(walk_end, st + c_lo - pos_offset + 1));
  const int n_kv = (key_end + kBlock - 1) / kBlock;
  const size_t row_base = (static_cast<size_t>(b) * kvh + kv) * R;

  if (threadIdx.x == 0) {
    mbar_init(q_full, kLoaders);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], kLoaders);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the loader warpgroup
    const int t = threadIdx.x - kConsumers;
    // the Q tile (rows past R as zeros) and the page ids need no start[b]:
    // their loads go out before it arrives
    constexpr int kQv = D / 8;  // 16-byte vectors per row
    constexpr int kQper = kBlock * kQv / kLoaders;
    uint4 qv[kQper];
#pragma unroll
    for (int i = 0; i < kQper; ++i) {
      const int row = (t + i * kLoaders) / kQv;
      qv[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + row < R)
        qv[i] = __ldg(reinterpret_cast<const uint4*>(
                          q + (row_base + r0 + row) * D) +
                      (t + i * kLoaders) % kQv);
    }
    const int* tbl_b = tbl + static_cast<size_t>(b) * mp;
    for (int j = t; j < mp; j += kLoaders)
      tbl_s[j] = min(max(__ldg(tbl_b + j), 0), n_pool_pages - 1);
    if (n_kv == 0) return;
#pragma unroll
    for (int i = 0; i < kQper; ++i)
      *reinterpret_cast<uint4*>(
          q_tile + tile_chunk<D>((t + i * kLoaders) / kQv,
                                 (t + i * kLoaders) % kQv)) = qv[i];
    fence_proxy_async();
    mbar_arrive(q_full);
    bar_sync(1, kLoaders);  // the page ids are staged

    // Item i of this thread: vector t % kVpk of the tile's key
    // t / kVpk + i kLoaders / kVpk. Straight-line code, so the items' index
    // math and loads overlap: a key past the walk reads key 0 (staged, so a
    // real page) and keeps zeros.
    const auto fetch = [&](int j, S& sh) {
      size_t vec[S::kPer];
      bool ok[S::kPer];
#pragma unroll
      for (int i = 0; i < S::kPer; ++i) {
        const int key = j * kBlock + (t + i * kLoaders) / S::kVpk;
        ok[i] = key < key_end;
        const int kk = ok[i] ? key : 0;
        const int col = kk / ps;
        vec[i] = (static_cast<size_t>(tbl_s[col]) * kvh + kv) * ps +
                 (kk - col * ps);
      }
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int i = 0; i < S::kPer; ++i) {
        const size_t off = vec[i] * D + (t % S::kVpk) * S::kElems;
        const uint4 kx = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
        const uint4 vx = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
        sh.k[i] = ok[i] ? kx : zero;
        sh.v[i] = ok[i] ? vx : zero;
        if constexpr (kQuant) {
          const float ksx = __ldg(k_scale + vec[i]);
          const float vsx = __ldg(v_scale + vec[i]);
          sh.ks[i] = ok[i] ? ksx : 0.f;
          sh.vs[i] = ok[i] ? vsx : 0.f;
        }
      }
    };
    // tile j into its stage once the consumers have freed it, published on
    // the stage's `full` barrier
    const auto put = [&](int j, const S& sh) {
      const int s = j % kStages;
      if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
#pragma unroll
      for (int i = 0; i < S::kPer; ++i) {
        const int item = t + i * kLoaders;
        const int row = item / S::kVpk;
        const int c = item % S::kVpk;
        if constexpr (kQuant) {  // 16 codes -> two 16-byte bf16 chunks
          const uint4 kr = sh.k[i], vr = sh.v[i];
          *reinterpret_cast<uint4*>(k_tile(s) + tile_chunk<D>(row, 2 * c)) =
              make_uint4(codes_bf16x2(kr.x, 0), codes_bf16x2(kr.x, 1),
                         codes_bf16x2(kr.y, 0), codes_bf16x2(kr.y, 1));
          *reinterpret_cast<uint4*>(k_tile(s) +
                                    tile_chunk<D>(row, 2 * c + 1)) =
              make_uint4(codes_bf16x2(kr.z, 0), codes_bf16x2(kr.z, 1),
                         codes_bf16x2(kr.w, 0), codes_bf16x2(kr.w, 1));
          *reinterpret_cast<uint4*>(v_tile(s) + tile_chunk<D>(row, 2 * c)) =
              make_uint4(codes_bf16x2(vr.x, 0), codes_bf16x2(vr.x, 1),
                         codes_bf16x2(vr.y, 0), codes_bf16x2(vr.y, 1));
          *reinterpret_cast<uint4*>(v_tile(s) +
                                    tile_chunk<D>(row, 2 * c + 1)) =
              make_uint4(codes_bf16x2(vr.z, 0), codes_bf16x2(vr.z, 1),
                         codes_bf16x2(vr.w, 0), codes_bf16x2(vr.w, 1));
          if (c == 0) {
            ks_s[s * kBlock + row] = sh.ks[i];
            vs_s[s * kBlock + row] = sh.vs[i];
          }
        } else {
          *reinterpret_cast<uint4*>(k_tile(s) + tile_chunk<D>(row, c)) =
              sh.k[i];
          *reinterpret_cast<uint4*>(v_tile(s) + tile_chunk<D>(row, c)) =
              sh.v[i];
        }
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
    };
    // Tile j's loads go out before the loader waits for its stage, so they
    // overlap the consumers' work on tile j - 1. One tile in flight: the
    // proxy fence in `put` (MEMBAR) waits for every load the thread has
    // outstanding, so loads of a later tile issued before it would stall it.
    S buf;
    for (int j = 0; j < n_kv; ++j) {
      fetch(j, buf);
      put(j, buf);
    }
    return;
  }

  // the consumer warpgroup: this thread's rows are rr and rr + 8 of the tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rr = 16 * warp + lane / 4;
  const int qpos[2] = {st + (r0 + rr) % cw, st + (r0 + rr + 8) % cw};
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // scores in base 2: s log2(e), so p = 2^(x - m) is one SFU operation; m
  // is in the same units (lse = m ln 2 + log l)
  const float scale_log2 = scale * 1.4426950408889634f;
  float m[2] = {kMask, kMask};
  float l[2] = {0.f, 0.f};

  if (n_kv > 0) mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    float sc[32];
    wgmma_fence();
    mma_ss_tiles<D>(sc, smem_u32(q_tile), smem_u32(k_tile(s)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);

    const int k0 = j * kBlock;
    const bool edge = k0 + kBlock > full_end;
    // sc[4c + e] is row h = e / 2 at key k0 + 8c + 2 (lane % 4) + (e & 1)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float2 ks = make_float2(1.f, 1.f);
      if constexpr (kQuant)
        ks = *reinterpret_cast<const float2*>(
            &ks_s[s * kBlock + 8 * c + 2 * (lane % 4)]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[4 * c + e] *= (e & 1 ? ks.y : ks.x) * scale_log2;
    }
    uint32_t live = 0xffffffffu;  // bit i: sc[i]'s key is visible
    if (edge) {  // selects, not a branch per element
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
        const bool dead =
            key >= walk_end || pos_offset + key > qpos[(i >> 1) & 1];
        sc[i] = dead ? kMask : sc[i];
        live &= dead ? ~(1u << i) : ~0u;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float m_safe[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      // rows with nothing visible so far keep MASK; the clamp keeps alpha
      // finite and their (zero) sums zero
      m_safe[h] = fmaxf(mx[h], 0.5f * kMask);
      alpha[h] = ex2(m[h] - m_safe[h]);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      // p = 0 on a dead key by its bit, as a mask: a branch per element
      // would serialise the 32 exponentials
      const float e = ex2(sc[i] - m_safe[h]);
      sc[i] = __int_as_float(__float_as_int(e) &
                             -static_cast<int>((live >> i) & 1u));
      psum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = alpha[h] * l[h] + quad_sum(psum[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // p (times v's scale) as bf16 hi + lo: the A fragments of the 4 k-steps
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      float p0 = sc[2 * t];
      float p1 = sc[2 * t + 1];
      if constexpr (kQuant) {
        const float2 vs = *reinterpret_cast<const float2*>(
            &vs_s[s * kBlock + 8 * (t >> 1) + 2 * (lane % 4)]);
        p0 *= vs.x;
        p1 *= vs.y;
      }
      hi[t] = pack_bf16(p0, p1);
      lo[t] = pack_bf16(p0 - __uint_as_float(hi[t] << 16),
                        p1 - __uint_as_float(hi[t] & 0xffff0000u));
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_tile<D>(acc, hi + 4 * kk, smem_u32(v_tile(s)), kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_tile<D>(acc, lo + 4 * kk, smem_u32(v_tile(s)), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(acc);
    fence_regs<16>(hi);
    fence_regs<16>(lo);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + rr + 8 * h;
    if (row >= R) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];  // rows that see no key
    const float inv = 1.f / l_safe;  // one division a row, not one a value
    __nv_bfloat16* o_row = o + (row_base + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(o_row + 8 * c) = pack_bf16(
          acc[4 * c + 2 * h] * inv, acc[4 * c + 2 * h + 1] * inv);
    if (lse != nullptr && lane % 4 == 0)
      lse[row_base + row] =
          l[h] == 0.f ? kMask : m[h] * kLn2 + logf(l_safe);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* tbl;
  const int* start;
  const int* qlen;
  void* o;
  float* lse;
  int b, kvh, R, cw, ps, mp, n_pool_pages, pos_offset;
  float scale;
  cudaStream_t stream;
};

template <typename TKV, int D>
int launch(const Args& a) {
  const auto kernel = paged_chunk_sm90_kernel<TKV, D>;
  const size_t smem = fixed_smem<D>() + static_cast<size_t>(a.mp) * 4;
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (allowed != cudaSuccess) return static_cast<int>(allowed);
  const dim3 grid((a.R + kBlock - 1) / kBlock, a.kvh, a.b);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.k_scale, a.v_scale, a.tbl, a.start,
      a.qlen, static_cast<__nv_bfloat16*>(a.o), a.lse, a.kvh, a.R, a.cw,
      a.ps, a.mp, a.n_pool_pages, a.pos_offset, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int dispatch_dim(const Args& a, int d) {
  switch (d) {
    case 32:
      return launch<TKV, 32>(a);
    case 64:
      return launch<TKV, 64>(a);
    case 128:
      return launch<TKV, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes; the argument list of paged_attn.cu's
// `paged_attn` and paged_decode.cu's `paged_decode`, so one wrapper launches
// any route. Takes bf16 q only (is_bf16 = 1): q, o (b, kvh, R, head_dim)
// bf16; k, v (n_pool_pages, kvh, ps, head_dim) bf16, or int8 codes when
// `quantized` with k_scale, v_scale f32 (n_pool_pages, kvh, ps) (else null),
// 16-byte aligned; tbl (b, mp), start (b,) and qlen (b,) int32 (qlen may be
// null); lse (b, kvh, R) f32 or null. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int paged_chunk_sm90(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* tbl, const void* start,
                                const void* qlen, void* o, void* lse, int b,
                                int kvh, int R, int cw, int head_dim, int ps,
                                int mp, int n_pool_pages, int pos_offset,
                                int is_bf16, int quantized, float scale,
                                void* stream) {
  if (is_bf16 != 1 || b < 1 || kvh < 1 || cw < 1 || R < cw || R % cw != 0 ||
      ps < 1 || mp < 1 || n_pool_pages < 1 || b > 65535 || kvh > 65535 ||
      (quantized != 0) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k,
               v,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(tbl),
               static_cast<const int*>(start),
               static_cast<const int*>(qlen),
               o,
               static_cast<float*>(lse),
               b,
               kvh,
               R,
               cw,
               ps,
               mp,
               n_pool_pages,
               pos_offset,
               scale,
               static_cast<cudaStream_t>(stream)};
  return quantized ? dispatch_dim<int8_t>(a, head_dim)
                   : dispatch_dim<__nv_bfloat16>(a, head_dim);
}
