// Paged attention, decode route (cw = 1), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` in
// distributed_pytorch_from_scratch_tpu/ops/pallas/paged_attention.py:95 (row 9
// of PERF.md's kernel table) where it runs one query column per request: the
// decode step. Prefill chunks (cw > 1) go to paged_attn.cu; the wrapper
// `ops/cuda/paged_attention.py` picks the source by `kernel_route`. Same
// function as the Pallas kernel and as paged_attn.cu, not the same blocking:
//   * Rows: q (b, h, 1, hd) is read as (b, kv_heads, R = g, hd); the g query
//     heads of a kv head share its K/V stream (never repeated), all at
//     qpos = start[b].
//   * Keys: page-table column j, offset t sits at kpos = pos_offset + j*ps + t
//     and is live iff kpos <= qpos. At cw = 1 that is every key of logical
//     index < n_keys = clamp(start - pos_offset + 1, 0, mp*ps), for every row
//     (qlen moves nothing: vmax = start + max(qlen, 1) - 1 >= qpos, so no
//     page the mask leaves live lies past vmax), and pages past the last
//     live key are never read. Page ids clamp into [0, n_pool_pages - 1], as
//     the TPU gather clamps.
//   * s = f32(q) . f32(k) * scale, an int8 key being f32(code) * k_scale[vec];
//     s = -1e30 on dead keys, m_safe = max(m_new, -1e30 / 2); p and v stay in
//     f32 for p . v (p is not rounded); o = acc / (l == 0 ? 1 : l), rounded
//     once to q's dtype; lse = l == 0 ? -1e30 : m + log(l). A row that sees
//     nothing gets o = 0 and lse = -1e30 exactly.
//
// Bound on the H100 (chip_smoke.bound_paged: the K and V of the visible keys
// read once, q read and o written once, over 3.35 TB/s): at the 45m decode
// shape q (16, 8, 1, 64), page_size 64, bf16, with chip_smoke's seeded
// cursors, 4485 visible keys, 9.2 MB, 2.75 us; int8 pages (codes plus a f32
// scale per head-vector) 1.47 us. Bytes-bound, and spread over only b * kvh =
// 128 blocks of ~280 keys: each SM must keep tens of KB in flight to reach
// the rate.
//
// What this design does about it. One block per (kv head, batch row, chunk of
// kRows query rows) of kWarps warps; every warp walks a share of the row's
// keys: sub-tiles w, w + kWarps, w + 2 kWarps, ... of kKeys consecutive
// logical keys, with no block barrier in the walk. A sub-tile is kIt = 4
// warp-wide 16-byte loads of K and 4 of V in the pool's own dtype: lane
// (grp, sl) reads slice sl of key grp of each load, so 32 lanes read 512
// contiguous bytes of a page (a load may span pages when ps is small: each
// lane looks its key's page id up in the table, staged in shared memory once
// per block). The next sub-tile's loads are issued before the current one is
// computed (register double buffer), so a block keeps up to 64 KB in flight.
// Each warp keeps its own (m, l, acc) per row: scores are partial dots
// reduced over the lanes of a key by shuffles, the sub-tile max over the
// warp by shuffles, and acc is a per-lane sum over the lane's keys, reduced
// across the warp once at the end. The warps' states are then combined once
// in shared memory, in a fixed warp order (no atomics, no workspace, no
// second kernel; two calls give the same bits), with the MASK / 2 clamp so a
// warp that saw no live key adds exactly nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kIt = 4;  // warp-wide 16-byte loads of K (and of V) per sub-tile
constexpr float kMask = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// the page-table stage is dynamic shared memory: beyond 16 KB (4096 pages;
// the static arrays take up to 18 KB of the default 48 KB) the allowance is
// raised once per instantiation, up to 200 KB (51200 pages)
constexpr int kDefaultDynSmem = 16 * 1024;
constexpr int kMaxDynSmem = 200 * 1024;

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

// a 16-byte shared-memory read the compiler may not hoist out of the walk
// (several rows of q would not fit in registers beside the loads in flight)
__device__ __forceinline__ float4 lds4(const float* p) {
  float4 v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// How a warp covers a sub-tile: a key of D elements is kVpk 16-byte vectors,
// read by kVpk neighbouring lanes; one warp-wide load covers kKpi keys, and a
// sub-tile is kIt loads, kKeys keys (bf16 at head_dim 64: 8 lanes a key,
// 4 keys a load, 16 keys a sub-tile).
template <typename TKV, int D>
struct Layout {
  static constexpr int kVec = Unpack<TKV>::kN;
  static constexpr int kVpk = D / kVec;
  static constexpr int kKpi = 32 / kVpk;
  static constexpr int kKeys = kIt * kKpi;
  static_assert(kVpk >= 1 && kVpk <= 32 && 32 % kVpk == 0, "layout");
};

// One sub-tile's share of one lane: its slice of kIt keys of K and V, raw,
// with their int8 scales.
struct Buf {
  uint4 k[kIt];
  uint4 v[kIt];
  float ks[kIt];
  float vs[kIt];
};

// T: q and o (float or bf16); TKV: the pool (T, or int8 codes with f32
// scales, one per head-vector, in k_scale / v_scale); kRows: query rows of
// one kv head per block (1 for MHA; under GQA kMultiRows, and more blocks
// for larger g).
template <typename T, typename TKV, int D, int kRows>
__global__ void __launch_bounds__(kThreads, 1)
    paged_decode_kernel(const T* __restrict__ q, const TKV* __restrict__ k_pool,
                        const TKV* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ tbl,
                        const int* __restrict__ start, T* __restrict__ o,
                        float* __restrict__ lse, int kvh, int R, int ps,
                        int mp, int n_pool_pages, int pos_offset,
                        float scale) {
  using L = Layout<TKV, D>;
  constexpr int kVec = L::kVec;
  constexpr int kVpk = L::kVpk;
  constexpr int kKpi = L::kKpi;
  constexpr int kKeys = L::kKeys;
  constexpr bool kQuant = std::is_same<TKV, int8_t>::value;
  __shared__ __align__(16) float q_s[kRows][D];
  __shared__ __align__(16) float acc_s[kWarps][kRows][D];
  __shared__ float m_s[kWarps][kRows];
  __shared__ float l_s[kWarps][kRows];
  extern __shared__ int tbl_s[];  // the row's live page ids, clamped

  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, R - r0);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / kVpk;  // which key of a load
  const int sl = lane % kVpk;   // which 16-byte slice of it

  const int n_keys = min(max(start[b] - pos_offset + 1, 0), mp * ps);
  const int n_pages = (n_keys + ps - 1) / ps;
  const int* tbl_b = tbl + static_cast<size_t>(b) * mp;
  for (int j = tid; j < n_pages; j += kThreads)
    tbl_s[j] = min(max(tbl_b[j], 0), n_pool_pages - 1);
  const size_t row_base = (static_cast<size_t>(b) * kvh + kv) * R + r0;
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D;
    q_s[r][i % D] = r < rows ? to_float(q[(row_base + r) * D + i % D]) : 0.f;
  }
  __syncthreads();

  // q: one row's slice lives in registers; several rows are read from shared
  // memory at each use
  float qr[kRows == 1 ? kVec : 1];
  if constexpr (kRows == 1) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) qr[e] = q_s[0][sl * kVec + e];
  }
  const auto q4 = [&](int r, int e) -> float4 {
    if constexpr (kRows == 1)
      return make_float4(qr[e], qr[e + 1], qr[e + 2], qr[e + 3]);
    else
      return lds4(&q_s[r][sl * kVec + e]);
  };

  float m[kRows];
  float l[kRows];             // over this lane's keys
  float acc[kRows][kVec];     // this lane's slice, over this lane's keys
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMask;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
  }

  const auto fetch = [&](int t, Buf& f) {
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const int key = t * kKeys + i * kKpi + grp;
      f.k[i] = f.v[i] = make_uint4(0u, 0u, 0u, 0u);  // zeros past the keys
      f.ks[i] = f.vs[i] = 0.f;
      if (key < n_keys) {
        const int page = tbl_s[key / ps];
        const size_t vec =
            (static_cast<size_t>(page) * kvh + kv) * ps + key % ps;
        const size_t off = vec * D + sl * kVec;
        f.k[i] = __ldg(reinterpret_cast<const uint4*>(k_pool + off));
        f.v[i] = __ldg(reinterpret_cast<const uint4*>(v_pool + off));
        if constexpr (kQuant) {  // fused int8 dequant
          f.ks[i] = __ldg(k_scale + vec);
          f.vs[i] = __ldg(v_scale + vec);
        }
      }
    }
  };

  const auto compute = [&](int t, const Buf& f) {
    float s[kRows][kIt];
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      const bool live = t * kKeys + i * kKpi + grp < n_keys;
      float kf[kVec];
      Unpack<TKV>::run(f.k[i], kf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          const float4 qv = q4(r, e);
          part = fmaf(qv.x, kf[e], part);
          part = fmaf(qv.y, kf[e + 1], part);
          part = fmaf(qv.z, kf[e + 2], part);
          part = fmaf(qv.w, kf[e + 3], part);
        }
#pragma unroll
        for (int x = 1; x < kVpk; x <<= 1)
          part += __shfl_xor_sync(kFull, part, x);
        if constexpr (kQuant) part *= f.ks[i];
        s[r][i] = live ? part * scale : kMask;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mt = s[r][0];
#pragma unroll
      for (int i = 1; i < kIt; ++i) mt = fmaxf(mt, s[r][i]);
#pragma unroll
      for (int x = kVpk; x < 32; x <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, x));
      const float m_new = fmaxf(m[r], mt);
      // a warp with nothing live so far keeps m_new = MASK; the clamp stops
      // exp(MASK - MASK) = 1 from resurrecting its masked entries
      const float m_safe = fmaxf(m_new, 0.5f * kMask);
      const float alpha = expf(m[r] - m_safe);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int i = 0; i < kIt; ++i) {
        const bool live = t * kKeys + i * kKpi + grp < n_keys;
        s[r][i] = live ? expf(s[r][i] - m_safe) : 0.f;  // s becomes p
        l[r] += s[r][i];
      }
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kIt; ++i) {
      float vf[kVec];
      Unpack<TKV>::run(f.v[i], vf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float p = s[r][i];
        if constexpr (kQuant) p *= f.vs[i];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  };

  // the walk: this warp's sub-tiles, each one's loads issued while the one
  // before is computed (two buffers, unrolled by two so nothing is copied)
  const int n_sub = (n_keys + kKeys - 1) / kKeys;
  Buf cur, nxt;
  if (warp < n_sub) fetch(warp, cur);
  for (int t = warp; t < n_sub; t += 2 * kWarps) {
    if (t + kWarps < n_sub) fetch(t + kWarps, nxt);
    compute(t, cur);
    if (t + kWarps >= n_sub) break;
    if (t + 2 * kWarps < n_sub) fetch(t + 2 * kWarps, cur);
    compute(t + kWarps, nxt);
  }

  // the warp's state: l and acc summed over the lanes of each slice
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int x = kVpk; x < 32; x <<= 1) {
      l[r] += __shfl_xor_sync(kFull, l[r], x);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[r][e] += __shfl_xor_sync(kFull, acc[r][e], x);
    }
    if (lane < kVpk) {
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(&acc_s[warp][r][lane * kVec + e]) =
            make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2],
                        acc[r][e + 3]);
    }
    if (lane == 0) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
  }
  __syncthreads();

  // the combine, once, in warp order: a warp that saw no live key holds
  // m = MASK, l = 0, acc = 0, and exp(MASK - m_safe) = 0 keeps it out
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][r]);
    const float m_safe = fmaxf(mx, 0.5f * kMask);
    float lt = 0.f;
    float at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w][r] - m_safe);
      lt = fmaf(c, l_s[w][r], lt);
      at = fmaf(c, acc_s[w][r][d], at);
    }
    const float l_safe = lt == 0.f ? 1.f : lt;  // rows that see no key
    o[(row_base + r) * D + d] = from_float<T>(at / l_safe);
    if (lse != nullptr && d == 0)
      lse[row_base + r] = lt == 0.f ? kMask : mx + logf(l_safe);
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
  void* o;
  float* lse;
  int b, kvh, R, ps, mp, n_pool_pages, pos_offset;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename TKV, int D, int kRows>
int launch(const Args& a) {
  const auto kernel = paged_decode_kernel<T, TKV, D, kRows>;
  const size_t smem = static_cast<size_t>(a.mp) * sizeof(int);
  if (smem > static_cast<size_t>(kMaxDynSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > static_cast<size_t>(kDefaultDynSmem)) {
    static const cudaError_t allowed = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
  }
  const dim3 grid(a.kvh, a.b, (a.R + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.k_scale, a.v_scale, a.tbl, a.start,
      static_cast<T*>(a.o), a.lse, a.kvh, a.R, a.ps, a.mp, a.n_pool_pages,
      a.pos_offset, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// rows per block under GQA: 4, or 2 with int8 pools, whose 16-element
// vectors hold twice the accumulators per row (4 rows spill at head_dim 64)
template <typename TKV>
constexpr int kMultiRows = std::is_same<TKV, int8_t>::value ? 2 : 4;

template <typename T, typename TKV, int D>
int dispatch_rows(const Args& a) {
  return a.R == 1 ? launch<T, TKV, D, 1>(a)
                  : launch<T, TKV, D, kMultiRows<TKV>>(a);
}

template <typename T, typename TKV>
int dispatch_dim(const Args& a, int d) {
  switch (d) {
    case 32:
      return dispatch_rows<T, TKV, 32>(a);
    case 64:
      return dispatch_rows<T, TKV, 64>(a);
    case 128:
      return dispatch_rows<T, TKV, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_pool(const Args& a, int d, int quantized) {
  return quantized ? dispatch_dim<T, int8_t>(a, d) : dispatch_dim<T, T>(a, d);
}

}  // namespace

// Plain C entry point, bound with ctypes; the argument list of paged_attn.cu's
// `paged_attn`, so one wrapper launches either route. Takes cw = 1 only
// (R = g rows per kv head); qlen is accepted and moves nothing at cw = 1.
// Launches on `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() after the launch (0 = launched). q, o: (b, kvh, R,
// head_dim) in q's dtype (is_bf16: 1 for bfloat16, 0 for float32); k, v:
// (n_pool_pages, kvh, ps, head_dim) in q's dtype, or int8 codes when
// `quantized` with k_scale, v_scale f32 (n_pool_pages, kvh, ps) (else null);
// tbl (b, mp) and start (b,) int32; lse (b, kvh, R) f32 or null.
extern "C" int paged_decode(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* tbl, const void* start,
                            const void* qlen, void* o, void* lse, int b,
                            int kvh, int R, int cw, int head_dim, int ps,
                            int mp, int n_pool_pages, int pos_offset,
                            int is_bf16, int quantized, float scale,
                            void* stream) {
  (void)qlen;
  if (b < 1 || kvh < 1 || cw != 1 || R < 1 || ps < 1 || mp < 1 ||
      n_pool_pages < 1 || b > 65535 || (R + 1) / 2 > 65535 ||
      (quantized != 0) != (k_scale != nullptr && v_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k,
               v,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(tbl),
               static_cast<const int*>(start),
               o,
               static_cast<float*>(lse),
               b,
               kvh,
               R,
               ps,
               mp,
               n_pool_pages,
               pos_offset,
               scale,
               static_cast<cudaStream_t>(stream)};
  if (is_bf16) return dispatch_pool<__nv_bfloat16>(a, head_dim, quantized);
  return dispatch_pool<float>(a, head_dim, quantized);
}
