// Positional block attention for NVIDIA Hopper (sm_90a), float32: the
// forward and its two backward kernels, block_attn_fwd, block_attn_dq and
// block_attn_dkv. bfloat16 goes to block_attn_sm90.cu (wgmma, TMA).
//
// Replaces, for float32 inputs, the TPU kernels of
// distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py that
// ring attention runs for every (Q-chunk, KV-chunk) block (PERF.md rows 6-8):
// `_pos_fwd_kernel` (:810, via `_block_fwd_call` :974), `_pos_dq_kernel`
// (:850, launched at :1030) and `_pos_dkv_kernel` (:878, launched at :1056).
// The same function, not the same blocking:
//   * q (b*hq, tq, D), k, v (b*hkv, tk, D), q_pos (b, tq), kv_pos (b, tk)
//     int32 global positions; query row r of batch row n sees key c iff
//     q_pos[n, r] >= kv_pos[n, c] -- the ring's causal mask, decided by the
//     positions carried with each chunk, not by the indices;
//   * forward: s = q k^T * scale, dead entries MASK (-1e30), online
//     softmax with m_safe = max(m_new, MASK/2), alpha = 0 while
//     m_prev <= MASK/2, p hard-zeroed where not live; o is normalized
//     within the block and lse is the row logsumexp; a row that sees no key
//     here gets o = 0 and lse = MASK, so the ring's combine weighs it 0;
//   * backward, given the f32 cotangent dlse of lse as well as do:
//     p = live ? exp(s - lse) : 0 (never exp(MASK - MASK) = 1 on a dead row),
//     ds = p (dp - delta + dlse) scale, dq += ds k, dk += ds^T q,
//     dv += p^T do, with delta = rowsum(do * o) from the caller;
//   * grouped-query attention by index routing: q row bh reads kv row
//     (bh / hq) * hkv + (bh % hq) / (hq / hkv) and position row bh / hq; dk/dv
//     of a kv head sum over its group's query heads inside one block;
//   * ragged tq and tk (the 45m cp path's halves are 250 long) are handled
//     by bounds checks here, never by padding with sentinel positions.
//
// Bound on the H100 at the 45m cp=2 path's shape, q and k halves
// (8, 8, 250, 64) f32: the forward must move q, k, v and o (4.1 MB each)
// plus lse and the positions, ~16.5 MB, 4.9 us at 3.35 TB/s; its operations
// are 4*D per visible (q, k) pair, 1.02 GFLOP for a fully visible block,
// 15 us at 67 TFLOP/s of f32 outside the tensor cores: at f32 the forward
// is bound by operations. The backward pair does 2.5x the operations on
// the same pairs (bound_bwd's count). No model path runs it on the card:
// the cp cell trains in bf16; f32 is what the card-vs-CPU checks hold.
//
// What this design does about it: this is the simple, right first version,
// the SIMT layout of flash_fwd.cu / flash_bwd.cu (f32 FMAs; tensor cores
// would mean TF32, which changes the numbers), limited by the FMA pipe and the
// shared-memory reads that feed it. It keeps the flash property that matters
// for the bytes: the (tq, tk) score matrix never reaches device memory, and
// each block streams its operand tiles through shared memory once. The TPU
// kernels had no block skip inside a block pair (the ring skips whole
// blocks); here a tile that no row of the thread block can see is skipped
// with one block-wide vote (__syncthreads_or), which halves the work of a
// diagonal block. Blocks run in parallel and in no order, so the TPU's
// sequential grid axes become loops inside a block: block_attn_fwd and
// block_attn_dq own 64 query rows and loop over the key tiles;
// block_attn_dkv owns 64 keys and loops over the group's query heads and,
// inside, over the query tiles. Nothing is shared between blocks (no
// atomics), so results are the same from run to run.
//
// Layout: 4 threads share one row (a query row, or a key in dkv), each
// owning the dims c, c+4, c+8, ... of its row's vectors and accumulators,
// so a dot product is a partial sum plus two warp shuffles.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;        // rows (fwd, dq) or keys (dkv) per block
constexpr int kBlockN = 32;        // keys (fwd, dq) or rows (dkv) per tile
constexpr int kThreadsPerRow = 4;  // threads sharing one row
constexpr int kThreads = kBlockM * kThreadsPerRow;
constexpr float kMask = -1e30f;

// sum of a partial dot product over the 4 threads of a row
__device__ __forceinline__ float row_sum(float part) {
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

// Copy rows [r0, r0 + kBlockN) of a (t, D) matrix into a tile, zeros past t.
template <int D>
__device__ __forceinline__ void load_tile(float (*tile)[D], const float* src,
                                          int r0, int t, int tid) {
  for (int e = tid; e < kBlockN * D; e += kThreads) {
    const int j = e / D;
    const int d = e % D;
    const int r = r0 + j;
    tile[j][d] = r < t ? src[(size_t)r * D + d] : 0.f;
  }
}

// Smallest (kMin) or largest position among the first n entries of a tile.
template <bool kMin>
__device__ __forceinline__ int tile_extreme(const int* pos, int n) {
  int x = kMin ? INT_MAX : INT_MIN;
  for (int j = 0; j < n; ++j) x = kMin ? min(x, pos[j]) : max(x, pos[j]);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    block_attn_fwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ kv_pos, float* __restrict__ o,
                          float* __restrict__ lse, int hq, int hkv, int tq,
                          int tk, float scale) {
  constexpr int kDims = D / kThreadsPerRow;  // dims owned by one thread
  constexpr int kTileBytes = kBlockN * D * sizeof(float);  // <= 16 KB
  __shared__ __align__(16) unsigned char smem[2 * kTileBytes];
  __shared__ int kp_tile[kBlockN];
  float(*k_tile)[D] = reinterpret_cast<float(*)[D]>(smem);
  float(*v_tile)[D] = reinterpret_cast<float(*)[D]>(smem + kTileBytes);

  const int bh = blockIdx.y;
  const int batch = bh / hq;
  const int tid = threadIdx.x;
  const int c = tid % kThreadsPerRow;
  const int row = blockIdx.x * kBlockM + tid / kThreadsPerRow;
  const int kv_bh = batch * hkv + (bh % hq) / (hq / hkv);
  const float* q_bh = q + (size_t)bh * tq * D;
  const float* k_bh = k + (size_t)kv_bh * tk * D;
  const float* v_bh = v + (size_t)kv_bh * tk * D;
  const int* kp_b = kv_pos + (size_t)batch * tk;
  const bool row_in = row < tq;
  const int qp = row_in ? q_pos[(size_t)batch * tq + row] : 0;

  float qr[kDims];
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = c + kThreadsPerRow * i;
    qr[i] = row_in ? q_bh[(size_t)row * D + d] : 0.f;
    acc[i] = 0.f;
  }
  float m = kMask;
  float l = 0.f;

  for (int k0 = 0; k0 < tk; k0 += kBlockN) {
    const int n_cols = min(kBlockN, tk - k0);
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(k_tile, k_bh, k0, tk, tid);
    load_tile<D>(v_tile, v_bh, k0, tk, tid);
    if (tid < kBlockN) kp_tile[tid] = tid < n_cols ? kp_b[k0 + tid] : 0;
    __syncthreads();
    // a tile no row of this block sees adds nothing: skip it, all together
    const int kp_min = tile_extreme<true>(kp_tile, n_cols);
    if (!__syncthreads_or(row_in && qp >= kp_min)) continue;

    float s[kBlockN];
    unsigned live_bits = 0u;
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        part = fmaf(qr[i], k_tile[j][c + kThreadsPerRow * i], part);
      part = row_sum(part);
      const bool live = row_in && j < n_cols && qp >= kp_tile[j];
      live_bits |= (live ? 1u : 0u) << j;
      s[j] = live ? part * scale : kMask;
      m_new = fmaxf(m_new, s[j]);
    }
    // rows that saw nothing yet keep m = MASK: the clamp keeps
    // exp(MASK - MASK) = 1 from resurrecting their masked entries
    const float m_safe = fmaxf(m_new, 0.5f * kMask);
    const float alpha = m <= 0.5f * kMask ? 0.f : expf(m - m_safe);
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= alpha;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      const float p = (live_bits >> j) & 1u ? expf(s[j] - m_safe) : 0.f;
      p_sum += p;
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] = fmaf(p, v_tile[j][c + kThreadsPerRow * i], acc[i]);
    }
    l = alpha * l + p_sum;
    m = m_new;
  }

  if (row_in) {
    const bool dead = l == 0.f;  // the row sees no key of this block
    const float l_safe = dead ? 1.f : l;
    float* o_row = o + ((size_t)bh * tq + row) * D;
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      o_row[c + kThreadsPerRow * i] = acc[i] / l_safe;
    if (c == 0) lse[(size_t)bh * tq + row] = dead ? kMask : m + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    block_attn_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ q_pos,
                         const int* __restrict__ kv_pos,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ dlse, float* __restrict__ dq,
                         int hq, int hkv, int tq, int tk, float scale) {
  constexpr int kDims = D / kThreadsPerRow;
  constexpr int kTileBytes = kBlockN * D * sizeof(float);  // <= 16 KB
  __shared__ __align__(16) unsigned char smem[2 * kTileBytes];
  __shared__ int kp_tile[kBlockN];
  float(*k_tile)[D] = reinterpret_cast<float(*)[D]>(smem);
  float(*v_tile)[D] = reinterpret_cast<float(*)[D]>(smem + kTileBytes);

  const int bh = blockIdx.y;
  const int batch = bh / hq;
  const int tid = threadIdx.x;
  const int c = tid % kThreadsPerRow;
  const int row = blockIdx.x * kBlockM + tid / kThreadsPerRow;
  const int kv_bh = batch * hkv + (bh % hq) / (hq / hkv);
  const size_t row_off = ((size_t)bh * tq + row) * D;
  const float* k_bh = k + (size_t)kv_bh * tk * D;
  const float* v_bh = v + (size_t)kv_bh * tk * D;
  const int* kp_b = kv_pos + (size_t)batch * tk;
  const bool row_in = row < tq;
  const int qp = row_in ? q_pos[(size_t)batch * tq + row] : 0;

  float qr[kDims], dor[kDims], acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = c + kThreadsPerRow * i;
    qr[i] = row_in ? q[row_off + d] : 0.f;
    dor[i] = row_in ? dout[row_off + d] : 0.f;
    acc[i] = 0.f;
  }
  const size_t r_idx = (size_t)bh * tq + row;
  const float lse_r = row_in ? lse[r_idx] : 0.f;
  const float delta_r = row_in ? delta[r_idx] : 0.f;
  const float dlse_r = row_in ? dlse[r_idx] : 0.f;

  for (int k0 = 0; k0 < tk; k0 += kBlockN) {
    const int n_cols = min(kBlockN, tk - k0);
    __syncthreads();  // the previous tiles are consumed
    load_tile<D>(k_tile, k_bh, k0, tk, tid);
    load_tile<D>(v_tile, v_bh, k0, tk, tid);
    if (tid < kBlockN) kp_tile[tid] = tid < n_cols ? kp_b[k0 + tid] : 0;
    __syncthreads();
    const int kp_min = tile_extreme<true>(kp_tile, n_cols);
    if (!__syncthreads_or(row_in && qp >= kp_min)) continue;
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float s_part = 0.f, dp_part = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        const int d = c + kThreadsPerRow * i;
        s_part = fmaf(qr[i], k_tile[j][d], s_part);
        dp_part = fmaf(dor[i], v_tile[j][d], dp_part);
      }
      const float s = row_sum(s_part) * scale;
      const float dp = row_sum(dp_part);
      const bool live = row_in && j < n_cols && qp >= kp_tile[j];
      const float p = live ? expf(s - lse_r) : 0.f;
      const float ds = p * (dp - delta_r + dlse_r) * scale;
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] = fmaf(ds, k_tile[j][c + kThreadsPerRow * i], acc[i]);
    }
  }

  if (row_in) {
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      dq[row_off + c + kThreadsPerRow * i] = acc[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    block_attn_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ kv_pos,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ dlse,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int hq, int hkv, int tq, int tk, float scale) {
  constexpr int kDims = D / kThreadsPerRow;
  constexpr int kTileBytes = kBlockN * D * sizeof(float);  // <= 16 KB
  __shared__ __align__(16) unsigned char smem[2 * kTileBytes];
  __shared__ float lse_tile[kBlockN];
  __shared__ float delta_tile[kBlockN];
  __shared__ float dlse_tile[kBlockN];
  __shared__ int qp_tile[kBlockN];
  float(*q_tile)[D] = reinterpret_cast<float(*)[D]>(smem);
  float(*do_tile)[D] = reinterpret_cast<float(*)[D]>(smem + kTileBytes);

  const int bkv = blockIdx.y;
  const int batch = bkv / hkv;
  const int tid = threadIdx.x;
  const int c = tid % kThreadsPerRow;
  const int key = blockIdx.x * kBlockM + tid / kThreadsPerRow;
  const int group = hq / hkv;
  // query heads of this kv head: b*hq + hk*group + g (the TPU `_q_row`)
  const int bh0 = batch * hq + (bkv % hkv) * group;
  const size_t key_off = ((size_t)bkv * tk + key) * D;
  const int* qp_b = q_pos + (size_t)batch * tq;
  const bool key_in = key < tk;
  const int kp = key_in ? kv_pos[(size_t)batch * tk + key] : 0;

  float kr[kDims], vr[kDims], dk_acc[kDims], dv_acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = c + kThreadsPerRow * i;
    kr[i] = key_in ? k[key_off + d] : 0.f;
    vr[i] = key_in ? v[key_off + d] : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)bh0 + g;
    const float* q_bh = q + bh * tq * D;
    const float* do_bh = dout + bh * tq * D;
    for (int r0 = 0; r0 < tq; r0 += kBlockN) {
      const int n_rows = min(kBlockN, tq - r0);
      __syncthreads();  // the previous tiles are consumed
      load_tile<D>(q_tile, q_bh, r0, tq, tid);
      load_tile<D>(do_tile, do_bh, r0, tq, tid);
      if (tid < kBlockN) {
        const bool in = tid < n_rows;
        const size_t r = bh * tq + r0 + tid;
        lse_tile[tid] = in ? lse[r] : 0.f;
        delta_tile[tid] = in ? delta[r] : 0.f;
        dlse_tile[tid] = in ? dlse[r] : 0.f;
        qp_tile[tid] = in ? qp_b[r0 + tid] : 0;
      }
      __syncthreads();
      // a tile of rows that sees no key of this block adds nothing
      const int qp_max = tile_extreme<false>(qp_tile, n_rows);
      if (!__syncthreads_or(key_in && kp <= qp_max)) continue;
#pragma unroll 4
      for (int j = 0; j < kBlockN; ++j) {
        float s_part = 0.f, dp_part = 0.f;
#pragma unroll
        for (int i = 0; i < kDims; ++i) {
          const int d = c + kThreadsPerRow * i;
          s_part = fmaf(kr[i], q_tile[j][d], s_part);
          dp_part = fmaf(vr[i], do_tile[j][d], dp_part);
        }
        const float s = row_sum(s_part) * scale;
        const float dp = row_sum(dp_part);
        const bool live = key_in && j < n_rows && kp <= qp_tile[j];
        const float p = live ? expf(s - lse_tile[j]) : 0.f;
        const float ds =
            p * (dp - delta_tile[j] + dlse_tile[j]) * scale;
#pragma unroll
        for (int i = 0; i < kDims; ++i) {
          const int d = c + kThreadsPerRow * i;
          dv_acc[i] = fmaf(p, do_tile[j][d], dv_acc[i]);
          dk_acc[i] = fmaf(ds, q_tile[j][d], dk_acc[i]);
        }
      }
    }
  }

  if (key_in) {
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const int d = c + kThreadsPerRow * i;
      dk[key_off + d] = dk_acc[i];
      dv[key_off + d] = dv_acc[i];
    }
  }
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
  const auto pos = [](const void* p) { return static_cast<const int*>(p); };
  const auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  if constexpr (kKind == Kind::kFwd) {
    const dim3 grid((a.tq + kBlockM - 1) / kBlockM, a.b * a.hq);
    block_attn_fwd_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        f32(a.q), f32(a.k), f32(a.v), pos(a.q_pos), pos(a.kv_pos),
        static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.hq, a.hkv,
        a.tq, a.tk, a.scale);
  } else if constexpr (kKind == Kind::kDq) {
    const dim3 grid((a.tq + kBlockM - 1) / kBlockM, a.b * a.hq);
    block_attn_dq_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        f32(a.q), f32(a.k), f32(a.v), pos(a.q_pos), pos(a.kv_pos), f32(a.dout),
        f32(a.lse), f32(a.delta), f32(a.dlse), static_cast<float*>(a.out0),
        a.hq, a.hkv, a.tq, a.tk, a.scale);
  } else {
    const dim3 grid((a.tk + kBlockM - 1) / kBlockM, a.b * a.hkv);
    block_attn_dkv_kernel<D><<<grid, kThreads, 0, a.stream>>>(
        f32(a.q), f32(a.k), f32(a.v), pos(a.q_pos), pos(a.kv_pos), f32(a.dout),
        f32(a.lse), f32(a.delta), f32(a.dlse), static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.hq, a.hkv, a.tq, a.tk, a.scale);
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

// Plain C entry points, bound with ctypes. Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError() after
// the launch (0 = launched). Inputs are float32; block_attn_sm90.cu takes
// the same arguments for bfloat16.
// Positions are int32; lse, delta and dlse are float32 (b*hq, tq).
extern "C" int block_attn_fwd(const void* q, const void* k, const void* v,
                              const void* q_pos, const void* kv_pos, void* o,
                              void* lse, int b, int hq, int hkv, int tq,
                              int tk, int head_dim, float scale,
                              void* stream) {
  const Args a{q, k,   v, q_pos, kv_pos, nullptr, nullptr, nullptr, nullptr,
               o, lse, b, hq,    hkv,    tq,      tk,      scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Kind::kFwd>(a, head_dim);
}

extern "C" int block_attn_dq(const void* q, const void* k, const void* v,
                             const void* q_pos, const void* kv_pos,
                             const void* dout, const void* lse,
                             const void* delta, const void* dlse, void* dq,
                             int b, int hq, int hkv, int tq, int tk,
                             int head_dim, float scale,
                             void* stream) {
  const Args a{q,  k,       v, q_pos, kv_pos, dout, lse, delta, dlse,
               dq, nullptr, b, hq,    hkv,    tq,   tk,  scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Kind::kDq>(a, head_dim);
}

extern "C" int block_attn_dkv(const void* q, const void* k, const void* v,
                              const void* q_pos, const void* kv_pos,
                              const void* dout, const void* lse,
                              const void* delta, const void* dlse, void* dk,
                              void* dv, int b, int hq, int hkv, int tq, int tk,
                              int head_dim, float scale,
                              void* stream) {
  const Args a{q,    k,  v,  q_pos, kv_pos, dout, lse, delta, dlse,
               dk,   dv, b,  hq,    hkv,    tq,   tk,  scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Kind::kDkv>(a, head_dim);
}
