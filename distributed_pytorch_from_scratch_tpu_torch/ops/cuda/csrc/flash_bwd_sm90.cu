// Causal flash-attention backward for NVIDIA Hopper (sm_90a), bf16, on the
// tensor cores: two kernels, flash_bwd_dq_sm90 and flash_bwd_dkv_sm90, with
// wgmma products, TMA loads and an mbarrier ring.
//
// Replaces, for bfloat16 inputs, the four TPU backward launches of
// distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py driven
// by `_bwd_call` (:385): `_bwd_fused_kernel` (:306), `_bwd_fused_gqa_kernel`
// (:343), `_dq_kernel` (:210) and `_dkv_kernel` (:255); flash_bwd.cu keeps
// the f32 route. The function is flash_bwd.cu's, step for step:
//   * from q, k, v, do (bf16), the forward's f32 row logsumexp `lse` and
//     delta = rowsum(do * o) (f32, computed by the caller), produce dq, dk, dv;
//   * s = q k^T * scale in f32; dead entries (col > row, col >= t_real,
//     row >= t_real) get p = 0 exactly; p = exp(s - lse) otherwise;
//   * dv += bf16(p)^T do;  dp = do v^T;  ds = bf16(p (dp - delta) scale);
//     dq += ds k;  dk += ds^T q -- f32 accumulators, cast once at the end;
//   * grouped-query attention: dk/dv of kv head hk sum over its group of
//     query heads inside one CTA: no atomics, the same bits from run to run;
//   * pad rows and pad keys (>= t_real) come out as exact zeros; nothing of
//     size t^2 reaches device memory (s and p are recomputed: 7 products).
//
// Bound on the H100 at the 45m train shape (q, do (32, 8, 1000, 64), MHA):
// 5 distinct products of 2 d flops on each of the 16.0M live pairs of every
// head, 82 GFLOP, 83 us at 989 TFLOP/s, against ~231 MB moved, 69 us: the
// bound is operations.
//
// Design. Both kernels: warp 4 is a producer whose lane 0 starts the TMA
// copies; warps 0-3 are one consumer warpgroup; tiles are 64 rows, staged
// through a 2-stage ring of `full` / `empty` mbarriers; the row masks are
// evaluated only on the diagonal tile and the ragged edge.
//   flash_bwd_dq: a CTA owns 64 query rows (Q and dO loaded once) and loops
//     over the K/V tiles up to the diagonal: S = Q K^T and dP = dO V^T by
//     wgmma from shared memory, P and dS in registers, dQ += dS K with dS as
//     the register A operand and K read MN-major.
//   flash_bwd_dkv: a CTA owns 64 keys (K and V loaded once) and loops over
//     the group's query heads and over the query tiles from the diagonal to
//     t_real; Q, dO and the tile's lse and delta rows come through the ring
//     (the producer warp's 32 lanes copy the two rows into the stage and
//     arrive; lane 0 also announces the TMA bytes): S^T = K Q^T and
//     dP^T = V dO^T from shared memory, dV += bf16(P^T) dO and
//     dK += dS^T Q with P^T and dS^T as register A operands, dO and Q read
//     MN-major. Key tiles launch in order: the first has the most work.
// No warp specialisation of registers (setmaxnreg): a 160-thread CTA has
// the registers it needs at two CTAs per SM for head_dim <= 64.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlock = kTileRows;  // rows per tile
constexpr int kStages = 2;
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;
constexpr float kMask = -1e30f;

// thread (warp w, lane l) of the consumer warpgroup holds accumulator rows
// 16 w + l / 4 + {0, 8} and columns 8 c + 2 (l % 4) + {0, 1}
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i >> 1) & 1); }
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

template <int D>
constexpr int dq_smem_bytes() {
  // Q, dO, then K and V per stage, then the barriers
  return Tile<D>::kBytes * (2 + 2 * kStages) + 8 * (1 + 2 * kStages) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int hq, int hkv,
                             int t, int t_real, float scale) {
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* q_tile = smem;
  uint8_t* do_tile = smem + kTile;
  auto k_tile = [&](int s) { return smem + kTile * (2 + 2 * s); };
  auto v_tile = [&](int s) { return smem + kTile * (3 + 2 * s); };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kTile * (2 + 2 * kStages));
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;  // longest first
  const int bh = blockIdx.y;
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int kv_end = q0 < t_real ? min(q0 + kBlock, t_real) : 0;
  const int n_kv = (kv_end + kBlock - 1) / kBlock;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp
    if (threadIdx.x == kConsumers && n_kv > 0) {
      mbar_arrive_tx(q_full, 2 * kTile);
      tma_tile<D>(q_tile, &q_map, q_full, q0, bh);
      tma_tile<D>(do_tile, &do_map, q_full, q0, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
        mbar_arrive_tx(&full[s], 2 * kTile);
        tma_tile<D>(k_tile(s), &k_map, &full[s], j * kBlock, kv_bh);
        tma_tile<D>(v_tile(s), &v_map, &full[s], j * kBlock, kv_bh);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + 16 * warp + lane / 4;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool live = row < t_real;
    lse_r[h] = live ? lse[(size_t)bh * t + row] : 0.f;
    delta_r[h] = live ? delta[(size_t)bh * t + row] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  if (n_kv > 0) mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    float sc[32], dp[32];
    wgmma_fence();
    mma_ss_tiles<D>(sc, smem_u32(q_tile), smem_u32(k_tile(s)));
    mma_ss_tiles<D>(dp, smem_u32(do_tile), smem_u32(v_tile(s)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);
    fence_regs<32>(dp);

    const int k0 = j * kBlock;
    const bool edge = k0 + kBlock > q0 || k0 + kBlock > t_real ||
                      q0 + kBlock > t_real;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      bool live = true;
      if (edge) {
        const int row = row0 + acc_row(i);
        const int col = k0 + acc_col(i, lane);
        live = col <= row && col < t_real && row < t_real;
      }
      const float p = live ? expf(sc[i] * scale - lse_r[h]) : 0.f;
      dp[i] = p * (dp[i] - delta_r[h]) * scale;  // ds, rounded below
    }
    uint32_t ds[16];
    to_a_frags(dp, ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_rs_tile<D>(acc, ds + 4 * kk, smem_u32(k_tile(s)), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(acc);
    fence_regs<16>(ds);
    mbar_arrive(&empty[s]);
  }
  store_rows<D>(acc, dq + (size_t)bh * t * D, row0, t, lane);
}

template <int D>
constexpr int dkv_smem_bytes() {
  // K, V, then Q and dO per stage, then lse and delta rows per stage, then
  // the barriers
  return Tile<D>::kBytes * (2 + 2 * kStages) + 2 * 4 * kBlock * kStages +
         8 * (1 + 2 * kStages) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 2 : 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int hq, int hkv,
                              int t, int t_real, float scale) {
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* k_tile = smem;
  uint8_t* v_tile = smem + kTile;
  auto q_tile = [&](int s) { return smem + kTile * (2 + 2 * s); };
  auto do_tile = [&](int s) { return smem + kTile * (3 + 2 * s); };
  float* rows = reinterpret_cast<float*>(smem + kTile * (2 + 2 * kStages));
  auto lse_row = [&](int s) { return rows + 2 * kBlock * s; };
  auto delta_row = [&](int s) { return rows + 2 * kBlock * s + kBlock; };
  uint64_t* bars = reinterpret_cast<uint64_t*>(rows + 2 * kBlock * kStages);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int k0 = blockIdx.x * kBlock;  // the first key tile has most work
  const int bkv = blockIdx.y;
  const int group = hq / hkv;
  // query heads of this kv head: b*hq + hk*group + g (the TPU `_q_row`)
  const int bh0 = (bkv / hkv) * hq + (bkv % hkv) * group;
  // query tiles from the diagonal to t_real, for each head of the group
  const int n_q = k0 < t_real ? (t_real - k0 + kBlock - 1) / kBlock : 0;
  const int n_items = n_q * group;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // producer warp
    const int lane = threadIdx.x - kConsumers;
    if (n_items == 0) return;
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * kTile);
      tma_tile<D>(k_tile, &k_map, kv_full, k0, bkv);
      tma_tile<D>(v_tile, &v_map, kv_full, k0, bkv);
    }
    for (int n = 0; n < n_items; ++n) {
      const int s = n % kStages;
      const int bh = bh0 + n / n_q;
      const int r0 = k0 + (n % n_q) * kBlock;
      if (n >= kStages) mbar_wait(&empty[s], (n / kStages - 1) & 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + lane + 32 * e;
        const bool live = r < t_real;
        lse_row(s)[lane + 32 * e] = live ? lse[(size_t)bh * t + r] : 0.f;
        delta_row(s)[lane + 32 * e] = live ? delta[(size_t)bh * t + r] : 0.f;
      }
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * kTile);
        tma_tile<D>(q_tile(s), &q_map, &full[s], r0, bh);
        tma_tile<D>(do_tile(s), &do_map, &full[s], r0, bh);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int key0 = k0 + 16 * warp + lane / 4;  // this thread's keys: +0, +8
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    acc_dk[i] = 0.f;
    acc_dv[i] = 0.f;
  }

  if (n_items > 0) mbar_wait(kv_full, 0);
  for (int n = 0; n < n_items; ++n) {
    const int s = n % kStages;
    const int r0 = k0 + (n % n_q) * kBlock;
    mbar_wait(&full[s], (n / kStages) & 1);
    float st[32], dpt[32];  // S^T and dP^T: rows are keys, columns rows
    wgmma_fence();
    mma_ss_tiles<D>(st, smem_u32(k_tile), smem_u32(q_tile(s)));
    mma_ss_tiles<D>(dpt, smem_u32(v_tile), smem_u32(do_tile(s)));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(st);
    fence_regs<32>(dpt);

    const bool edge = r0 < k0 + kBlock || r0 + kBlock > t_real ||
                      k0 + kBlock > t_real;
    const float* lse_s = lse_row(s);
    const float* delta_s = delta_row(s);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = key0 + acc_row(i);
      const int c = acc_col(i, lane);
      bool live = true;
      if (edge) {
        const int row = r0 + c;
        live = key <= row && key < t_real && row < t_real;
      }
      const float p = live ? expf(st[i] * scale - lse_s[c]) : 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - delta_s[c]) * scale;  // ds^T, rounded below
    }
    uint32_t pa[16], dsa[16];
    to_a_frags(st, pa);
    to_a_frags(dpt, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs_tile<D>(acc_dv, pa + 4 * kk, smem_u32(do_tile(s)), kk);
      mma_rs_tile<D>(acc_dk, dsa + 4 * kk, smem_u32(q_tile(s)), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(acc_dv);
    fence_regs<D / 2>(acc_dk);
    fence_regs<16>(pa);
    fence_regs<16>(dsa);
    mbar_arrive(&empty[s]);
  }
  store_rows<D>(acc_dk, dk + (size_t)bkv * t * D, key0, t, lane);
  store_rows<D>(acc_dv, dv + (size_t)bkv * t * D, key0, t, lane);
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

template <int D>
int encode_all(const Args& a, CUtensorMap* maps) {
  int err = encode_map<D>(&maps[0], a.q, a.t, a.b * a.hq);
  if (err == 0) err = encode_map<D>(&maps[1], a.k, a.t, a.b * a.hkv);
  if (err == 0) err = encode_map<D>(&maps[2], a.v, a.t, a.b * a.hkv);
  if (err == 0) err = encode_map<D>(&maps[3], a.dout, a.t, a.b * a.hq);
  return err;
}

template <int D>
int launch_dq(const Args& a) {
  CUtensorMap m[4];
  if (int err = encode_all<D>(a, m)) return err;
  constexpr int kSmem = dq_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.t + kBlock - 1) / kBlock, a.b * a.hq);
  flash_bwd_dq_sm90_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      a.hq, a.hkv, a.t, a.t_real, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Args& a) {
  CUtensorMap m[4];
  if (int err = encode_all<D>(a, m)) return err;
  constexpr int kSmem = dkv_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.t + kBlock - 1) / kBlock, a.b * a.hkv);
  flash_bwd_dkv_sm90_kernel<D><<<grid, kThreads, kSmem, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), a.hq, a.hkv, a.t, a.t_real,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDq>
int dispatch(const Args& a, int head_dim) {
  if (a.b < 1 || a.hq < 1 || a.hkv < 1 || a.hq % a.hkv != 0 || a.t < 1 ||
      a.t_real < 1 || a.t_real > a.t)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 32:
      return kDq ? launch_dq<32>(a) : launch_dkv<32>(a);
    case 64:
      return kDq ? launch_dq<64>(a) : launch_dkv<64>(a);
    case 128:
      return kDq ? launch_dq<128>(a) : launch_dkv<128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes: bf16 q, do (b, hq, t, D), k, v
// (b, hkv, t, D), contiguous and 16-byte aligned; lse, delta f32 (b, hq, t).
// Each launches on `stream`, does not synchronise, allocates nothing, and
// returns 0 when launched, else a CUDA error code.
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int hq,
                                 int hkv, int t, int t_real, int head_dim,
                                 float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr,
               b, hq, hkv, t, t_real, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, head_dim);
}

extern "C" int flash_bwd_dkv_sm90(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int b, int hq, int hkv,
                                  int t, int t_real, int head_dim,
                                  float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv,
               b, hq, hkv, t, t_real, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, head_dim);
}
