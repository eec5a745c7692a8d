// Causal flash-attention backward for NVIDIA Hopper (sm_90a), the float32
// route: two kernels, flash_bwd_dq and flash_bwd_dkv (bfloat16 inputs go to
// flash_bwd_sm90.cu, on the tensor cores).
//
// Replaces the four TPU backward launches of
// distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py, all
// driven by `_bwd_call` (:385): `_bwd_fused_kernel` (:306, one block, group
// 1), `_bwd_fused_gqa_kernel` (:343, one block, GQA), `_dq_kernel` (:210)
// and `_dkv_kernel` (:255) (multi-block). Which of them the TPU took was a
// tiling choice (block grid, group size); they compute one function, and
// these two kernels compute that function for every t and group:
//   * given q (b*hq, t, D), k, v (b*hkv, t, D), do (b*hq, t, D) and the
//     forward's f32 row logsumexp `lse` plus delta = rowsum(do * o) (f32,
//     computed by the caller, as JAX computes it in XLA), produce
//     dq (b*hq, t, D) and dk, dv (b*hkv, t, D);
//   * s = q k^T * scale in f32 from the input-dtype values; entries with
//     col > row, col >= t_real or row >= t_real are dead and get p = 0 (hard
//     zero: dead rows carry lse = -1e30, so exp(s - lse) would not be 0);
//     p = exp(s - lse) otherwise;
//   * dv += p.to(dtype)^T do;  dp = do v^T;  ds = (p (dp - delta) scale)
//     .to(dtype);  dq += ds k;  dk += ds^T q -- the TPU kernels' rounding
//     points. Accumulators are f32 and cast once at the end;
//   * grouped-query attention: dk/dv of kv head hk sum over the query heads
//     hk*group + g, g < group (the TPU `_q_row` routing), inside one block,
//     so no atomics and no repeated K/V in device memory;
//   * pad rows and pad keys (>= t_real) come out as exact zeros.
//
// Bound on the H100: f32 has no tensor-core route that keeps its numbers
// (TF32 would round the inputs), so the f32 FMA pipe, 67 TFLOP/s, bounds the
// 5 products of 2*D flops on each of b*h*t(t+1)/2 live pairs.
//
// What this design does about it: this is the simple, right first version.
// Both kernels are SIMT with f32 FMAs (no mma/wgmma, no TMA), limited by the
// f32 FMA pipe and the shared-memory reads that feed it. The f32 route is
// what the card's checks against the CPU hold at 1e-6; the bf16 path of the
// model does not come here. They recompute s and p instead
// of storing the t x t matrices (7 products in all, as the TPU's split
// path), so nothing of size t^2 ever reaches device memory. Blocks run in
// parallel and in no order, so the TPU kernels' sequential grid axes
// become loops inside a block: flash_bwd_dq owns 64 query rows and loops
// over the key tiles up to the diagonal; flash_bwd_dkv owns 64 keys and
// loops over the group's query heads and, inside, over the query tiles from
// the diagonal to t_real. Tiles past the diagonal or past t_real are never
// loaded. Nothing is shared between blocks, so results are the same from
// run to run. Tensor-core products are later work.
//
// Layout: as flash_fwd.cu -- 4 threads share one row (query row in dq, key
// in dkv), each owning the dims c, c+4, c+8, ... of its row's vectors and
// accumulators, so a dot product is a partial sum plus two warp shuffles.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;        // rows (dq) or keys (dkv) per thread block
constexpr int kBlockN = 32;        // keys (dq) or rows (dkv) per smem tile
constexpr int kThreadsPerRow = 4;  // threads sharing one row
constexpr int kThreads = kBlockM * kThreadsPerRow;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// x rounded to T and back: the TPU kernels' `.astype(dtype)` before a dot
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// sum of a partial dot product over the 4 threads of a row
__device__ __forceinline__ float row_sum(float part) {
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

// Copy rows [r0, r0 + kBlockN) of a (t, D) matrix into a tile, zeros past t.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T (*tile)[D], const T* src, int r0,
                                          int t, int tid) {
  for (int e = tid; e < kBlockN * D; e += kThreads) {
    const int j = e / D;
    const int d = e % D;
    const int r = r0 + j;
    tile[j][d] = r < t ? src[(size_t)r * D + d] : from_float<T>(0.f);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int hq, int hkv, int t, int t_real, float scale) {
  constexpr int kDims = D / kThreadsPerRow;
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
  const size_t row_off = ((size_t)bh * t + row) * D;
  const T* k_bh = k + (size_t)kv_bh * t * D;
  const T* v_bh = v + (size_t)kv_bh * t * D;

  const bool row_live = row < t_real;
  float qr[kDims], dor[kDims], acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = c + kThreadsPerRow * i;
    qr[i] = row < t ? to_float(q[row_off + d]) : 0.f;
    dor[i] = row < t ? to_float(dout[row_off + d]) : 0.f;
    acc[i] = 0.f;
  }
  const float lse_r = row_live ? lse[(size_t)bh * t + row] : 0.f;
  const float delta_r = row_live ? delta[(size_t)bh * t + row] : 0.f;

  // Keys any row of this block can see: col <= its last row, col < t_real.
  // A block of padding rows only loads nothing and writes zeros.
  const int kv_end = q0 < t_real ? min(q0 + kBlockM, t_real) : 0;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockN) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<T, D>(k_tile, k_bh, k0, t, tid);
    load_tile<T, D>(v_tile, v_bh, k0, t, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float s_part = 0.f, dp_part = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        const int d = c + kThreadsPerRow * i;
        s_part = fmaf(qr[i], to_float(k_tile[j][d]), s_part);
        dp_part = fmaf(dor[i], to_float(v_tile[j][d]), dp_part);
      }
      const float s = row_sum(s_part) * scale;
      const float dp = row_sum(dp_part);
      const int col = k0 + j;
      const bool live = col <= row && col < t_real && row_live;
      const float p = live ? expf(s - lse_r) : 0.f;
      const float ds = round_to<T>(p * (dp - delta_r) * scale);
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] = fmaf(ds, to_float(k_tile[j][c + kThreadsPerRow * i]), acc[i]);
    }
  }

  if (row < t) {
#pragma unroll
    for (int i = 0; i < kDims; ++i)
      dq[row_off + c + kThreadsPerRow * i] = from_float<T>(acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int hq, int hkv, int t,
                         int t_real, float scale) {
  constexpr int kDims = D / kThreadsPerRow;
  constexpr int kTileBytes = kBlockN * D * sizeof(T);  // 16 KB at most
  __shared__ __align__(16) unsigned char smem[2 * kTileBytes];
  __shared__ float lse_tile[kBlockN];
  __shared__ float delta_tile[kBlockN];
  T(*q_tile)[D] = reinterpret_cast<T(*)[D]>(smem);
  T(*do_tile)[D] = reinterpret_cast<T(*)[D]>(smem + kTileBytes);

  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * kBlockM;
  const int tid = threadIdx.x;
  const int c = tid % kThreadsPerRow;
  const int key = k0 + tid / kThreadsPerRow;
  const int group = hq / hkv;
  // query heads of this kv head: b*hq + hk*group + g (the TPU `_q_row`)
  const int bh0 = (bkv / hkv) * hq + (bkv % hkv) * group;
  const size_t key_off = ((size_t)bkv * t + key) * D;

  float kr[kDims], vr[kDims], dk_acc[kDims], dv_acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    const int d = c + kThreadsPerRow * i;
    kr[i] = key < t ? to_float(k[key_off + d]) : 0.f;
    vr[i] = key < t ? to_float(v[key_off + d]) : 0.f;
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }
  const bool key_live = key < t_real;

  // Rows that can see a key of this block: row >= k0 (causal), row < t_real.
  // A block of padding keys only loads nothing and writes zeros.
  const int q_end = k0 < t_real ? t_real : 0;
  for (int g = 0; g < group; ++g) {
    const size_t bh = (size_t)bh0 + g;
    const T* q_bh = q + bh * t * D;
    const T* do_bh = dout + bh * t * D;
    for (int r0 = k0; r0 < q_end; r0 += kBlockN) {
      __syncthreads();  // the previous tiles are consumed
      load_tile<T, D>(q_tile, q_bh, r0, t, tid);
      load_tile<T, D>(do_tile, do_bh, r0, t, tid);
      if (tid < kBlockN) {
        const int r = r0 + tid;
        lse_tile[tid] = r < t_real ? lse[bh * t + r] : 0.f;
        delta_tile[tid] = r < t_real ? delta[bh * t + r] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kBlockN; ++j) {
        float s_part = 0.f, dp_part = 0.f;
#pragma unroll
        for (int i = 0; i < kDims; ++i) {
          const int d = c + kThreadsPerRow * i;
          s_part = fmaf(kr[i], to_float(q_tile[j][d]), s_part);
          dp_part = fmaf(vr[i], to_float(do_tile[j][d]), dp_part);
        }
        const float s = row_sum(s_part) * scale;
        const float dp = row_sum(dp_part);
        const int row = r0 + j;
        const bool live = key <= row && key_live && row < t_real;
        const float p = live ? expf(s - lse_tile[j]) : 0.f;
        const float pv = round_to<T>(p);  // p in do's dtype
        const float ds = round_to<T>(p * (dp - delta_tile[j]) * scale);
#pragma unroll
        for (int i = 0; i < kDims; ++i) {
          const int d = c + kThreadsPerRow * i;
          dv_acc[i] = fmaf(pv, to_float(do_tile[j][d]), dv_acc[i]);
          dk_acc[i] = fmaf(ds, to_float(q_tile[j][d]), dk_acc[i]);
        }
      }
    }
  }

  if (key < t) {
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const int d = c + kThreadsPerRow * i;
      dk[key_off + d] = from_float<T>(dk_acc[i]);
      dv[key_off + d] = from_float<T>(dv_acc[i]);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* lse;
  const void* delta;
  void* out0;  // dq, or dk
  void* out1;  // unused, or dv
  int b, hq, hkv, t, t_real;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a) {
  const dim3 grid((a.t + kBlockM - 1) / kBlockM, a.b * a.hq);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.hq, a.hkv, a.t, a.t_real, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const dim3 grid((a.t + kBlockM - 1) / kBlockM, a.b * a.hkv);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.hq, a.hkv, a.t,
      a.t_real, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDq, typename T>
int dispatch_dim(const Args& a, int d) {
  switch (d) {
    case 32:
      return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64:
      return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128:
      return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDq>
int dispatch(const Args& a, int head_dim) {
  if (a.b < 1 || a.hq < 1 || a.hkv < 1 || a.hq % a.hkv != 0 || a.t < 1 ||
      a.t_real < 1 || a.t_real > a.t)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_dim<kDq, float>(a, head_dim);
}

}  // namespace

// Plain C entry points, bound with ctypes: float32 inputs. Each launches on
// `stream`, does not synchronise, allocates nothing, and returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int b, int hq,
                            int hkv, int t, int t_real, int head_dim,
                            float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr,
               b, hq, hkv, t, t_real, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, head_dim);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int b,
                             int hq, int hkv, int t, int t_real, int head_dim,
                             float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv,
               b, hq, hkv, t, t_real, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, head_dim);
}
