// Paged attention for NVIDIA Hopper (sm_90a): the prefill-chunk route.
//
// Replaces the TPU kernel `_paged_kernel` in
// distributed_pytorch_from_scratch_tpu/ops/pallas/paged_attention.py:95 (row 9
// of PERF.md's kernel table; driven there by `paged_attention`, :186-317): the
// same function, not the same blocking. Only chunks (cw > 1) reach this
// kernel: `kernel_route` in ops/cuda/paged_attention.py sends decode steps
// (cw = 1) to paged_decode.cu, which splits the page walk across its warps.
// The entry point still takes cw = 1, which the notes below describe. One layer's KV pool is a stack of
// pages (P+1, kv_heads, page_size, head_dim); a request's cache row is its
// list of page ids in the (b, max_pages) page table. Index P is the scratch
// page that free rows and pad columns aim at.
//   * Rows: q (b, h, cw, hd) is read as (b, kv_heads, R = g*cw, hd), so row r
//     of kv head kv is query head kv*g + r / cw at position
//     qpos = start[b] + r % cw (the head-major q.reshape(b, kvh, g, cw, hd)).
//     Grouped-query heads share their kv head's pages; K/V are never repeated.
//   * Keys: page-table column j, offset t sits at kpos = pos_offset + j*ps + t
//     and is live for a row iff kpos <= qpos. Pages wholly past
//     vmax = start + max(qlen, 1) - 1 (start + cw - 1 without qlen) are
//     skipped for the whole batch row and never read.
//   * s = f32(q) . f32(k) * scale, an int8 key being f32(code) * scale[vec];
//     s = -1e30 on dead keys, m_safe = max(m_new, -1e30 / 2), p = live ?
//     exp(s - m_safe) : 0. p . v is taken in f32 with v in f32, as the TPU
//     kernel upcasts v: nothing is rounded before the product (unlike
//     flash_fwd.cu, which rounds p to v's dtype). o = acc / (l == 0 ? 1 : l)
//     in q's dtype; lse = l == 0 ? -1e30 : m + log(l), f32.
//
// Bound on the H100 (chip_smoke.bound_paged: the K and V of the keys a row
// sees read once, the valid q read and o written once, over 3.35 TB/s;
// 4*hd operations per (query, visible key) pair over 989 TFLOP/s): at the
// 45m decode shape q (16, 8, 1, 64), page_size 64, bf16, with chip_smoke's
// seeded cursors, 4485 visible keys, 9.2 MB, 2.75 us; at the chunk shape
// q (1, 8, 128, 64) starting at position 256, 1.05 MB, 0.31 us. Both are
// bytes-bound and tiny.
//
// What this design does about it: it is the simple, right first version.
// One block per (16-row tile of the stacked rows, kv head, batch row) walks
// the row's live pages in order, reading each page id from the table, and
// streams them through static shared memory in sub-tiles of 32 keys,
// dequantised to f32 on the way in; m, l and the f32 accumulator stay in
// registers (16 threads share one row, each owning hd/16 dims, so a score is
// a partial dot plus four shuffles). A page is read once per tile. Each
// thread fetches its share of a sub-tile as 16-byte loads into registers
// while the block computes on the previous one, so the walk's load latency
// overlaps the arithmetic instead of adding to it. At decode (cw = 1, MHA) a
// block has one live row, so the time is still set by the serial page walk,
// not by the bytes. Split-K across pages (flash-decoding), tensor cores and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsPerRow = 16;  // threads sharing one stacked row
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kThreadsPerRow;  // stacked rows per block
constexpr int kKeys = 32;           // keys per shared-memory sub-tile
constexpr float kMask = -1e30f;

// 16 bytes of pool data (one uint4) -> 16 / sizeof(TKV) floats, exactly
template <typename TKV>
struct Unpack;
template <>
struct Unpack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void run(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
};
template <>
struct Unpack<__nv_bfloat16> {  // element 2i in the low half of word i
  static constexpr int kN = 8;
  __device__ __forceinline__ static void run(const uint4& r, float* out) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Unpack<int8_t> {  // element 4i + t in byte t of word i
  static constexpr int kN = 16;
  __device__ __forceinline__ static void run(const uint4& r, float* out) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        out[4 * i + t] =
            static_cast<float>(static_cast<int8_t>((w[i] >> (8 * t)) & 0xffu));
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

// T: q and o (float or bf16); TKV: the pool (T, or int8 codes with f32
// scales, one per head-vector, in k_scale / v_scale).
template <typename T, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const T* __restrict__ q, const TKV* __restrict__ k_pool,
                      const TKV* __restrict__ v_pool,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      const int* __restrict__ tbl,
                      const int* __restrict__ start,
                      const int* __restrict__ qlen, T* __restrict__ o,
                      float* __restrict__ lse, int kvh, int R, int cw, int ps,
                      int mp, int n_pool_pages, int pos_offset, float scale) {
  constexpr int kDims = D / kThreadsPerRow;  // dims owned by one thread
  __shared__ __align__(16) float k_tile[kKeys][D];  // K and V: 32 KB at
  __shared__ __align__(16) float v_tile[kKeys][D];  // D = 128

  const int b = blockIdx.z;
  const int kv = blockIdx.y;
  const int tid = threadIdx.x;
  const int c = tid % kThreadsPerRow;
  const int r = blockIdx.x * kRows + tid / kThreadsPerRow;
  const bool row_ok = r < R;
  // a warp whose rows all lie past R (decode: every warp but the first)
  // loads tiles with the block but skips the arithmetic
  const bool warp_live =
      blockIdx.x * kRows + (tid / 32) * (32 / kThreadsPerRow) < R;
  const int st = start[b];
  const int qpos = st + (row_ok ? r % cw : 0);
  const int vmax = st + (qlen != nullptr ? max(qlen[b], 1) : cw) - 1;
  // walk the pages at columns j with pos_offset + j*ps <= vmax, as logical
  // key indices [0, walk_end); no row sees a key past start + cw - 1, so the
  // loop stops there too (those keys are dead for every row of the block)
  const int n_live =
      vmax < pos_offset ? 0 : min(mp, (vmax - pos_offset) / ps + 1);
  const int walk_end = n_live * ps;
  const int key_end = min(walk_end, st + cw - pos_offset);

  const size_t row_base = ((size_t)b * kvh + kv) * R;
  const T* q_row = q + (row_base + (row_ok ? r : 0)) * D;
  const int* tbl_b = tbl + (size_t)b * mp;
  float qr[kDims];
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    qr[i] = row_ok ? to_float(q_row[c + kThreadsPerRow * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kMask;
  float l = 0.f;

  // this thread's share of a sub-tile: 16-byte vectors of one key each,
  // fetched into registers one sub-tile ahead of the compute
  constexpr int kVec = Unpack<TKV>::kN;
  constexpr int kVecsPerKey = D / kVec;
  constexpr int kVecs = kKeys * kVecsPerKey;
  constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
  uint4 k_raw[kPer];
  uint4 v_raw[kPer];
  float k_sc[kPer];
  float v_sc[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int vi = tid + i * kThreads;
      const int key = k0 + vi / kVecsPerKey;
      k_raw[i] = v_raw[i] = make_uint4(0u, 0u, 0u, 0u);  // zeros past the walk
      k_sc[i] = v_sc[i] = 1.f;
      if (vi < kVecs && key < walk_end) {
        // out-of-range ids clamp into the pool, as the TPU gather clamps
        const int page = min(max(tbl_b[key / ps], 0), n_pool_pages - 1);
        const size_t vec = ((size_t)page * kvh + kv) * ps + key % ps;
        const size_t off = vec * D + (vi % kVecsPerKey) * kVec;
        k_raw[i] = *reinterpret_cast<const uint4*>(k_pool + off);
        v_raw[i] = *reinterpret_cast<const uint4*>(v_pool + off);
        if (k_scale != nullptr) {  // fused int8 dequant
          k_sc[i] = k_scale[vec];
          v_sc[i] = v_scale[vec];
        }
      }
    }
  };
  if (key_end > 0) fetch(0);

  for (int k0 = 0; k0 < key_end; k0 += kKeys) {
    __syncthreads();  // the previous sub-tile is consumed
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int vi = tid + i * kThreads;
      if (vi < kVecs) {
        const int j = vi / kVecsPerKey;
        const int d0 = (vi % kVecsPerKey) * kVec;
        float kf[kVec];
        float vf[kVec];
        Unpack<TKV>::run(k_raw[i], kf);
        Unpack<TKV>::run(v_raw[i], vf);
#pragma unroll
        for (int t = 0; t < kVec; t += 4) {  // 16-byte shared stores
          *reinterpret_cast<float4*>(&k_tile[j][d0 + t]) =
              make_float4(kf[t] * k_sc[i], kf[t + 1] * k_sc[i],
                          kf[t + 2] * k_sc[i], kf[t + 3] * k_sc[i]);
          *reinterpret_cast<float4*>(&v_tile[j][d0 + t]) =
              make_float4(vf[t] * v_sc[i], vf[t + 1] * v_sc[i],
                          vf[t + 2] * v_sc[i], vf[t + 3] * v_sc[i]);
        }
      }
    }
    __syncthreads();
    if (k0 + kKeys < key_end) fetch(k0 + kKeys);  // in flight while computing

    if (!warp_live) continue;
    float s[kKeys];
    unsigned live_bits = 0u;
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        part = fmaf(qr[i], k_tile[j][c + kThreadsPerRow * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      part += __shfl_xor_sync(0xffffffffu, part, 8);
      const int key = k0 + j;
      const bool live = key < walk_end && pos_offset + key <= qpos;
      live_bits |= live ? (1u << j) : 0u;
      s[j] = live ? part * scale : kMask;
      m_new = fmaxf(m_new, s[j]);
    }
    // rows with nothing visible so far keep m_new = MASK; the clamp stops
    // exp(MASK - MASK) = 1 from resurrecting their masked entries
    const float m_safe = fmaxf(m_new, 0.5f * kMask);
    const float alpha = expf(m - m_safe);
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= alpha;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = (live_bits >> j) & 1u ? expf(s[j] - m_safe) : 0.f;
      p_sum += p;
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] = fmaf(p, v_tile[j][c + kThreadsPerRow * i], acc[i]);
    }
    l = alpha * l + p_sum;
    m = m_new;
  }

  if (row_ok) {
    const float l_safe = l == 0.f ? 1.f : l;  // rows that see no key
    T* o_row = o + (row_base + r) * D;
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      o_row[c + kThreadsPerRow * i] = from_float<T>(acc[i] / l_safe);
    if (lse != nullptr && c == 0)
      lse[row_base + r] = l == 0.f ? kMask : m + logf(l_safe);
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

template <typename T, typename TKV, int D>
int launch(const Args& a) {
  const dim3 grid((a.R + kRows - 1) / kRows, a.kvh, a.b);
  paged_attn_kernel<T, TKV, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.k_scale, a.v_scale, a.tbl, a.start,
      a.qlen, static_cast<T*>(a.o), a.lse, a.kvh, a.R, a.cw, a.ps, a.mp,
      a.n_pool_pages, a.pos_offset, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TKV>
int dispatch_dim(const Args& a, int d) {
  switch (d) {
    case 32:
      return launch<T, TKV, 32>(a);
    case 64:
      return launch<T, TKV, 64>(a);
    case 128:
      return launch<T, TKV, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_pool(const Args& a, int d, int quantized) {
  return quantized ? dispatch_dim<T, int8_t>(a, d) : dispatch_dim<T, T>(a, d);
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the launch
// (0 = launched). q, o: (b, kvh, R, head_dim) in q's dtype (is_bf16: 1 for
// bfloat16, 0 for float32); k, v: (n_pool_pages, kvh, ps, head_dim) in q's
// dtype, or int8 codes when `quantized` with k_scale, v_scale f32
// (n_pool_pages, kvh, ps) (else null); tbl (b, mp), start (b,) and qlen (b,)
// int32 (qlen may be null); lse (b, kvh, R) f32 or null.
extern "C" int paged_attn(const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale,
                          const void* tbl, const void* start, const void* qlen,
                          void* o, void* lse, int b, int kvh, int R, int cw,
                          int head_dim, int ps, int mp, int n_pool_pages,
                          int pos_offset, int is_bf16, int quantized,
                          float scale, void* stream) {
  if (b < 1 || kvh < 1 || cw < 1 || R < cw || R % cw != 0 || ps < 1 ||
      mp < 1 || n_pool_pages < 1 || b > 65535 || kvh > 65535 ||
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
  if (is_bf16) return dispatch_pool<__nv_bfloat16>(a, head_dim, quantized);
  return dispatch_pool<float>(a, head_dim, quantized);
}
