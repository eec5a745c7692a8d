// Causal flash-attention forward for NVIDIA Hopper (sm_90a), bf16, on the
// tensor cores: wgmma products, TMA loads, an mbarrier ring.
//
// Replaces the TPU kernel `_fwd_kernel` in
// distributed_pytorch_from_scratch_tpu/ops/pallas/flash_attention.py (driven
// there by `_fwd_call`) for bfloat16 inputs; flash_fwd.cu keeps the f32
// route. The function is flash_fwd.cu's, step for step:
//   * o = softmax(q k^T / sqrt(d), causal) v per (batch, head) row, o in
//     bf16, plus the f32 row logsumexp `lse`;
//   * grouped-query attention by index: query head h of batch b reads kv
//     head h / (hq / hkv); K/V are never repeated in device memory;
//   * hard mask -1e30 for col > row, col >= t_real and row >= t_real, with
//     the m_safe = max(m_new, MASK/2) clamp, so rows >= t_real come out as
//     exact zeros with lse = -1e30;
//   * scores accumulate in f32; p is rounded to bf16 before p v.
//
// Bound on the H100: at the 45m train shape (b 32, h 8, t 1000, d 64) the
// causal work is 32.8 GFLOP, 33 us at 989 TFLOP/s, against 66 MB moved,
// 20 us at 3.35 TB/s; at the prefill shape (4, 8, 512, 64) 1.1 GFLOP
// against 8.4 MB: operations at the train shape, bytes at the prefill one.
//
// Design. One CTA per (64-row query tile, b*h), tiles launched longest first
// (reverse order) so the causal tail is short. Warp 4 is the producer: one
// lane loads the Q tile once and streams the K and V tiles (64 keys) through
// a 2-stage shared-memory ring by TMA, each stage completing on its `full`
// mbarrier; warps 0-3 are one consumer warpgroup owning the 64 rows:
//   S = Q K^T      wgmma m64n64k16, A and B from shared memory (K-major);
//   online softmax on the f32 accumulators in registers (a row lives in the
//                  4 lanes of a quad: max and sum are two shuffles);
//   O += P V       P rounded to bf16 in registers and fed as wgmma's register
//                  A operand; B = V from shared memory, MN-major (the
//                  transpose bit), so P never touches shared memory;
// then the consumers release the stage on its `empty` mbarrier. The mask is
// evaluated only on the diagonal tile and the ragged edge; the key loop ends
// at the diagonal and at t_real, and TMA zero-fills rows past t, so a ragged
// t needs no padding in device memory. 160 threads and <= 204 registers a
// thread (two CTAs per SM), so setmaxnreg has nothing to move: the producer
// warp is not a warpgroup of its own.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlock = kTileRows;  // query rows per CTA, keys per K/V tile
constexpr int kStages = 2;
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreads = kConsumers + 32;
constexpr float kMask = -1e30f;

template <int D>
constexpr int smem_bytes() {
  // Q, then K and V per stage, then the barriers; +1024 to align the base
  return Tile<D>::kBytes * (1 + 2 * kStages) + 8 * (1 + 2 * kStages) + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int hq, int hkv, int t,
                          int t_real, float scale) {
  constexpr int kTile = Tile<D>::kBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* q_tile = smem;
  auto k_tile = [&](int s) { return smem + kTile * (1 + 2 * s); };
  auto v_tile = [&](int s) { return smem + kTile * (2 + 2 * s); };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kTile * (1 + 2 * kStages));
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;  // longest first
  const int bh = blockIdx.y;
  const int kv_bh = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  // keys this tile can see: col <= its last row and col < t_real
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

  if (threadIdx.x >= kConsumers) {  // producer warp: one lane starts TMA
    if (threadIdx.x == kConsumers && n_kv > 0) {
      mbar_arrive_tx(q_full, kTile);
      tma_tile<D>(q_tile, &q_map, q_full, q0, bh);
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
  const int row0 = q0 + 16 * warp + lane / 4;  // this thread's rows: +0, +8
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
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
    const bool edge = k0 + kBlock > q0 || k0 + kBlock > t_real ||
                      q0 + kBlock > t_real;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      float x = sc[i] * scale;
      if (edge) {
        const int row = row0 + 8 * h;
        const int col = k0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
        if (col > row || col >= t_real || row >= t_real) x = kMask;
      }
      sc[i] = x;
      mx[h] = fmaxf(mx[h], x);
    }
    float m_safe[2], alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      // all-dead rows keep MASK; the clamp stops exp(MASK - MASK) = 1 from
      // resurrecting their masked entries
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
      mma_rs_tile<D>(acc, pa + 4 * kk, smem_u32(v_tile(s)), kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(acc);
    fence_regs<16>(pa);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= t) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];  // padding rows only
    __nv_bfloat16* o_row = o + ((size_t)bh * t + row) * D + 2 * (lane % 4);
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(o_row + 8 * c) = pack_bf16(
          acc[4 * c + 2 * h] / l_safe, acc[4 * c + 2 * h + 1] / l_safe);
    if (lane % 4 == 0) lse[(size_t)bh * t + row] = m[h] + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int hq, int hkv, int t, int t_real, float scale,
           cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = encode_map<D>(&q_map, q, t, b * hq);
  if (err == 0) err = encode_map<D>(&k_map, k, t, b * hkv);
  if (err == 0) err = encode_map<D>(&v_map, v, t, b * hkv);
  if (err != 0) return err;
  constexpr int kSmem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((t + kBlock - 1) / kBlock, b * hq);
  flash_fwd_sm90_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), hq, hkv, t, t_real, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes. bf16 q (b, hq, t, D), k, v
// (b, hkv, t, D), contiguous and 16-byte aligned; o bf16 like q, lse f32
// (b, hq, t). Launches on `stream`, does not synchronise, allocates nothing;
// returns 0 when launched, else a CUDA error code.
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* o, void* lse, int b, int hq, int hkv,
                              int t, int t_real, int head_dim, float scale,
                              void* stream) {
  if (b < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || t < 1 || t_real < 1 ||
      t_real > t)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, o, lse, b, hq, hkv, t, t_real, scale, s);
    case 64:
      return launch<64>(q, k, v, o, lse, b, hq, hkv, t, t_real, scale, s);
    case 128:
      return launch<128>(q, k, v, o, lse, b, hq, hkv, t, t_real, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
