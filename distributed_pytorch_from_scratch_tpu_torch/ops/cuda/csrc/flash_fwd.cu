// Causal flash-attention forward for NVIDIA Hopper (sm_90a), the float32
// route (bfloat16 inputs go to flash_fwd_sm90.cu, on the tensor cores).
//
// Replaces the TPU kernel `_fwd_kernel` in
// distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py (driven
// there by `_fwd_call`): the same function, not the same blocking.
//   * o = softmax(q k^T / sqrt(d), causal) v per (batch, head) row, plus the
//     f32 row logsumexp `lse` that the backward kernels will need.
//   * Grouped-query attention by index routing: query head h of batch b reads
//     kv head h / (hq / hkv); K/V are never repeated in device memory.
//   * Hard mask -1e30 for col > row, col >= t_real and row >= t_real, with the
//     m_safe = max(m_new, MASK/2) clamp, so rows >= t_real come out as exact
//     zeros with lse = -1e30. A ragged t is masked here, never padded in HBM.
//   * q k^T reads the inputs in their own dtype and accumulates in f32; p is
//     rounded to v's dtype before p v, as the TPU kernel does.
//
// Bound on the H100: f32 has no tensor-core route that keeps its numbers
// (TF32 would round the inputs), so the f32 FMA pipe, 67 TFLOP/s, bounds the
// ~1.1 GFLOP of causal work at the 45m prefill shape (b 4, h 8, t 512, d 64).
//
// What this design does about it: it is the simple, right first version, a
// SIMT kernel with f32 FMAs (no mma/wgmma, no TMA), limited by that pipe and
// the shared-memory reads that feed it. The f32 route is what the card's
// checks against the CPU hold at 1e-6; the bf16 path of the model does not
// come here. It does keep the flash property that matters for the bytes: each block
// holds 64 query rows in registers and streams K/V tiles through shared
// memory once, so q, k, v are read from HBM once per 64-row tile and the
// t x t score matrix never leaves the chip. Tiles entirely above the causal
// diagonal or past t_real are never loaded (the loop bound replaces the TPU
// kernel's `block_live` guard). Tensor-core products are later work.
//
// Layout: q, o (b*hq, t, D), k, v (b*hkv, t, D), contiguous; lse (b*hq, t)
// f32. One thread block per (64-row q tile, b*hq row); 4 threads share one
// query row, each owning the dims c, c+4, c+8, ... of q and of the
// accumulator, so a score is a partial dot plus two warp shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;        // query rows per thread block
constexpr int kBlockN = 32;        // keys per shared-memory tile
constexpr int kThreadsPerRow = 4;  // threads sharing one query row
constexpr int kThreads = kBlockM * kThreadsPerRow;
constexpr float kMask = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int hq, int hkv, int t,
                     int t_real, float scale) {
  constexpr int kDims = D / kThreadsPerRow;  // dims owned by one thread
  constexpr int kTileBytes = kBlockN * D * sizeof(T);  // 16 KB at most
  __shared__ __align__(16) unsigned char smem[2 * kTileBytes];
  T(*k_tile)[D] = reinterpret_cast<T(*)[D]>(smem);
  T(*v_tile)[D] = reinterpret_cast<T(*)[D]>(smem + kTileBytes);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int c = tid % kThreadsPerRow;
  const int row = q0 + tid / kThreadsPerRow;
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const T* q_bh = q + (size_t)bh * t * D;
  const T* k_bh = k + (size_t)kv_bh * t * D;
  const T* v_bh = v + (size_t)kv_bh * t * D;

  float qr[kDims];
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = c + kThreadsPerRow * i;
    qr[i] = row < t ? to_float(q_bh[(size_t)row * D + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kMask;
  float l = 0.f;

  // Keys this block can see: col <= its last row and col < t_real. A block
  // of padding rows only (q0 >= t_real) loads nothing and writes zeros.
  const int kv_end = q0 < t_real ? min(q0 + kBlockM, t_real) : 0;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < kBlockN * D; e += kThreads) {
      const int j = e / D;
      const int d = e % D;
      const int col = k0 + j;
      const bool live = col < t;
      k_tile[j][d] = live ? k_bh[(size_t)col * D + d] : from_float<T>(0.f);
      v_tile[j][d] = live ? v_bh[(size_t)col * D + d] : from_float<T>(0.f);
    }
    __syncthreads();

    float s[kBlockN];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        part = fmaf(qr[i], to_float(k_tile[j][c + kThreadsPerRow * i]), part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int col = k0 + j;
      s[j] = (col > row || col >= t_real || row >= t_real) ? kMask
                                                            : part * scale;
      m_new = fmaxf(m_new, s[j]);
    }
    // all-dead rows keep m_new = MASK; the clamp stops exp(MASK - MASK) = 1
    // from resurrecting their masked entries
    const float m_safe = fmaxf(m_new, 0.5f * kMask);
    const float alpha = expf(m - m_safe);
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= alpha;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockN; ++j) {
      const float p = expf(s[j] - m_safe);
      p_sum += p;
      const float pv = to_float(from_float<T>(p));  // p in v's dtype
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] = fmaf(pv, to_float(v_tile[j][c + kThreadsPerRow * i]), acc[i]);
    }
    l = alpha * l + p_sum;
    m = m_new;
  }

  if (row < t) {
    const float l_safe = l == 0.f ? 1.f : l;  // padding rows only
    T* o_row = o + ((size_t)bh * t + row) * D;
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      o_row[c + kThreadsPerRow * i] = from_float<T>(acc[i] / l_safe);
    if (c == 0) lse[(size_t)bh * t + row] = m + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int hq, int hkv, int t, int t_real, float scale,
           cudaStream_t stream) {
  const dim3 grid((t + kBlockM - 1) / kBlockM, b * hq);
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      hq, hkv, t, t_real, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v, void* o,
                 void* lse, int b, int hq, int hkv, int t, int t_real, int d,
                 float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, b, hq, hkv, t, t_real, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, hq, hkv, t, t_real, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, hq, hkv, t, t_real, scale,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes: float32 inputs. Launches on
// `stream`, does not synchronise, allocates nothing; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int b, int hq, int hkv, int t,
                         int t_real, int head_dim, float scale, void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || t < 1 || t_real < 1 ||
      t_real > t)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_dim<float>(q, k, v, o, lse, b, hq, hkv, t, t_real, head_dim,
                             scale, s);
}
