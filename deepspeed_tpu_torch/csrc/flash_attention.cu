// Flash attention for training on Hopper (sm_90a): forward, dK/dV and dQ.
//
// Replaces the three Pallas kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
//   dstt_flash_fwd      <- _fwd_kernel      (:182, pallas_call :254)
//   dstt_flash_bwd_dkdv <- _bwd_dkdv_kernel (:282, pallas_call :407)
//   dstt_flash_bwd_dq   <- _bwd_dq_kernel   (:335, pallas_call :436)
//
// What they compute, per (batch b, head h), with scores
//   s[q,k] = scale·(Q·Kᵀ)[q,k] + slope_h·(k − q), then −1e30 where the window
//   test (w <= 0 or (q − k) < w) fails, then −1e30 where causal and q < k,
// and −1e30 for keys past the end of the sequence:
//   forward: O = softmax(s)·V (online softmax over key tiles), lse = m + log(l);
//   dK/dV:   P = exp(s − lse), dV = Pᵀ·dO, dS = P∘(dO·Vᵀ − Δ), dK = scale·dSᵀ·Q;
//   dQ:      dQ = scale·dS·K;
// with Δ = rowsum(dO∘O) computed by the caller. The order of the masking
// steps and the −1e30 constant are those of the Pallas _block_scores (:125).
//
// Layout. q/k/v/dO are read where the model left them, [B, S, H, D] with
// explicit batch/sequence/head strides (the last dimension contiguous): the
// JAX wrapper's [B·H, S, D] transposes are TPU tiling and would cost two
// copies per tensor here. O/dQ/dK/dV are written with their own strides, lse
// and Δ are [B, H, S] fp32 (lse in natural log).
//
// Grid. The Pallas kernels accumulate over a sequential innermost grid axis in
// VMEM scratch; here that axis is a loop inside one CTA:
//   forward and dQ: one CTA per (b, h, q-tile), looping over key tiles;
//   dK/dV:          one CTA per (b, h, key-tile), looping over query tiles.
// No atomics, so every result is deterministic. Under causal masking the tiles
// wholly above the diagonal are skipped, their loads included. The ragged edge
// (S not a multiple of the tile) is bounds-checked or zero-filled instead of
// padded; for causal self-attention that gives what the JAX wrapper's padding
// gives.
//
// Input types: fp32, bf16 and fp16, as the Pallas kernels run in the input's
// type. 16-bit rounding follows the Pallas kernel: P is cast to the input type
// before P·V and before Pᵀ·dO, dS before dSᵀ·Q and dS·K; every product
// accumulates in fp32 and O, dQ, dK, dV are written in the input type from
// fp32 accumulators.
//
// What bounds it on this card. At the training shape (S = 1024, D = 64, bf16)
// the forward moves ~4 bytes of q/k/v/O per 2·S·D/2 causal flops per row:
// about 250 flops per byte, near the H100's ~295 ridge, so bytes and tensor
// operations bound it about equally; the backward does 2.5x the products on
// ~1.5x the bytes and is bound by operations.
//
// The 16-bit kernels (flash_fwd_hopper, flash_dkdv_hopper, flash_dq_hopper)
// are warp-specialised for Hopper (hopper.cuh): per CTA one producer warp and
// two consumer warpgroups. The producer's lane 0 loads tiles by TMA into a
// three-stage ring of 128-byte-swizzled shared memory with mbarrier completion
// (the dK/dV producer warp also stages each query tile's lse and Δ); the
// consumers run every product as wgmma with fp32 accumulators in registers
// and hand a stage back through an "empty" mbarrier. S, P, dS and the
// O/dK/dV/dQ accumulators never touch shared memory: P (and dS) are rounded in
// registers and fed back as wgmma's register A operand, whose layout is the
// accumulator's. Softmax runs in base 2 (scale and slopes pre-multiplied by
// log2 e); lse is written back in natural log.
//   forward: CTA = 128 query rows (64 per warpgroup), key tiles of 128 (D <=
//     64) or 64 (D <= 128); S = Q·Kᵀ with both operands K-major in shared
//     memory, O += P·V with V read MN-major (trans-b); running max and sum per
//     row by quad shuffles; the q-tiles with the most key tiles launch first.
//   dK/dV: CTA = 128 keys (64 per warpgroup), query tiles of 64; Sᵀ = K·Qᵀ
//     and dPᵀ = V·dOᵀ (keys as rows, so Pᵀ and dSᵀ land in registers as the A
//     of dV += Pᵀ·dO and dK += dSᵀ·Q, with dO and Q read MN-major).
//   dQ: CTA = 128 query rows (64 per warpgroup); Q and dO loaded once, key
//     tiles of 64 through the ring (the register budget: S, dP and dQ
//     accumulators plus dS as A); S = Q·Kᵀ and dP = dO·Vᵀ K-major, dS formed
//     in registers, dQ += dS·K with K read MN-major; each thread's two rows
//     keep their lse and Δ in registers; the longest causal q-tiles first.
// They need 16-byte rows and strides for TMA: D % 8 == 0, q/k/v/dO bases at
// 16 bytes and their strides multiples of 8 elements; the wrapper pads any
// other input into aligned buffers before the launch (flash_attention.py).
// fp32 inputs keep the 32x32 scalar kernels (shared-memory tiles, scalar
// FMAs through common.cuh and attention.cuh: TF32 tensor cores would break
// the fp32 tolerance).
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute; cudaErrorInvalidValue
// for arguments it does not take, cudaErrorNotSupported if the driver refuses
// a tensor map).

#include <cstring>

#include "attention.cuh"
#include "hopper.cuh"

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;
  void* dq;
  void* dk;
  void* dv;
  float* lse;          // [B, H, Sq]: written by the forward, read by the backward
  const float* delta;  // [B, H, Sq]
  const float* slopes; // [H] or null (no ALiBi)
  const float* window; // [1] or null (global); w <= 0 is global
  long long q_str[3], k_str[3], v_str[3], do_str[3];  // batch, seq, head
  long long out_str[3], dq_str[3], dk_str[3], dv_str[3];
  int B, Sq, Sk, H, D, causal, dtype;
  float scale;
};

namespace {

constexpr int MAX_D = 128;

constexpr int F32_TILE = 32;  // the fp32 kernels' query and key tiles

struct Mask {
  float scale, slope, w;
  bool has_window, causal;
  int Sk;

  // The Pallas _block_scores order: scale·dot, + ALiBi, window, causal; then
  // keys past the end of the sequence.
  __device__ __forceinline__ float operator()(float dot, int qpos, int kpos) const {
    float s = scale * dot + slope * static_cast<float>(kpos - qpos);
    if (has_window && !(w <= 0.0f || static_cast<float>(qpos - kpos) < w)) s = NEG_INF;
    if (causal && qpos < kpos) s = NEG_INF;
    if (kpos >= Sk) s = NEG_INF;
    return s;
  }

  // Scale and ALiBi only: for a tile that no mask can reach.
  __device__ __forceinline__ float unmasked(float dot, int qpos, int kpos) const {
    return scale * dot + slope * static_cast<float>(kpos - qpos);
  }
};

__device__ __forceinline__ Mask make_mask(const FlashParams& p, int h) {
  Mask m;
  m.scale = p.scale;
  m.slope = p.slopes != nullptr ? p.slopes[h] : 0.0f;
  m.has_window = p.window != nullptr;
  m.w = m.has_window ? p.window[0] : 0.0f;
  m.causal = p.causal != 0;
  m.Sk = p.Sk;
  return m;
}

// Exclusive end of the keys a query tile [q0, q0 + BQ) can see.
__device__ __forceinline__ int key_end(const FlashParams& p, int q0, int BQ) {
  return p.causal ? min(p.Sk, q0 + BQ) : p.Sk;
}

// ---------------------------------------------------------------------------
// fp32 forward: one CTA per (q-tile, h, b), 32x32 tiles, scalar FMAs.
// ---------------------------------------------------------------------------

template <int DP>
struct FwdSmem {
  static constexpr int BQ = F32_TILE, BK = F32_TILE;
  static constexpr int LDT = ld_t<float, DP>(), LDS = ld_f<BK>(), LDA = ld_f<DP>();
  static constexpr size_t bytes = (BQ * LDT + 2 * BK * LDT + BQ * LDS + BQ * LDS + BQ * LDA + 2 * BQ) * sizeof(float);
};

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) flash_fwd_f32_kernel(const FlashParams p) {
  using L = FwdSmem<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, LDT = L::LDT, LDS = L::LDS, LDA = L::LDA;
  static_assert(BK == 32, "the softmax gives each lane one key column");
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [BQ][LDT]
  float* k_s = q_s + BQ * LDT;                   // [BK][LDT]
  float* v_s = k_s + BK * LDT;                   // [BK][LDT]
  float* p_s = v_s + BK * LDT;                   // [BQ][LDS] probabilities
  float* s_s = p_s + BQ * LDS;                   // [BQ][LDS] scores
  float* acc_s = s_s + BQ * LDS;                 // [BQ][LDA] output accumulator
  float* m_s = acc_s + BQ * LDA;                 // [BQ] running max
  float* l_s = m_s + BQ;                         // [BQ] running sum

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Mask mask = make_mask(p, h);

  load_tile<float, BQ, DP, LDT>(q_s, static_cast<const float*>(p.q), p.q_str, b, h, q0, p.Sq, p.D);
  for (int i = threadIdx.x; i < BQ * LDA; i += NUM_THREADS) acc_s[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NUM_THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.0f;
  }

  const int k_end = key_end(p, q0, BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    load_tile<float, BK, DP, LDT>(k_s, static_cast<const float*>(p.k), p.k_str, b, h, k0, p.Sk, p.D);
    load_tile<float, BK, DP, LDT>(v_s, static_cast<const float*>(p.v), p.v_str, b, h, k0, p.Sk, p.D);
    __syncthreads();
    block_gemm<BQ, BK, DP, false, true, LDT, LDT, LDS>(q_s, k_s, s_s, false);
    __syncthreads();

    // Online softmax, one warp per row.
    for (int r = warp; r < BQ; r += NUM_WARPS) {
      const int c = lane;
      const float sv = mask(s_s[r * LDS + c], q0 + r, k0 + c);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(sv));
      const float pj = expf(sv - m_new);
      p_s[r * LDS + c] = pj;
      const float sum = warp_sum(pj);
      const float alpha = expf(m_old - m_new);
      for (int d = lane; d < DP; d += 32) acc_s[r * LDA + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();
    block_gemm<BQ, DP, BK, false, false, LDS, LDT, LDA>(p_s, v_s, acc_s, true);
    __syncthreads();
  }

  // O = acc / l, lse = m + log(l).
  float* out = static_cast<float*>(p.out) + b * p.out_str[0] + h * p.out_str[2];
  for (int i = threadIdx.x; i < BQ * DP; i += NUM_THREADS) {
    const int r = i / DP, d = i % DP;
    if (q0 + r < p.Sq && d < p.D) {
      const float l = l_s[r] == 0.0f ? 1.0f : l_s[r];
      out[(q0 + r) * p.out_str[1] + d] = acc_s[r * LDA + d] / l;
    }
  }
  float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
  for (int r = threadIdx.x; r < BQ; r += NUM_THREADS) {
    if (q0 + r < p.Sq) lse[q0 + r] = m_s[r] + logf(l_s[r] == 0.0f ? 1.0f : l_s[r]);
  }
}

// ---------------------------------------------------------------------------
// fp32 dK/dV: one CTA per (key-tile, h, b), looping over query tiles.
// ---------------------------------------------------------------------------

template <int DP>
struct DkdvSmem {
  static constexpr int BQ = F32_TILE, BK = F32_TILE;
  static constexpr int LDT = ld_t<float, DP>(), LDS = ld_f<BK>(), LDA = ld_f<DP>();
  static constexpr size_t bytes =
      (2 * BK * LDT + 2 * BQ * LDT + 2 * BQ * LDS + 2 * BQ * LDS + 2 * BK * LDA + 2 * BQ) * sizeof(float);
};

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) flash_dkdv_f32_kernel(const FlashParams p) {
  using L = DkdvSmem<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, LDT = L::LDT, LDS = L::LDS, LDA = L::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [BK][LDT]
  float* v_s = k_s + BK * LDT;                   // [BK][LDT]
  float* q_s = v_s + BK * LDT;                   // [BQ][LDT]
  float* do_s = q_s + BQ * LDT;                  // [BQ][LDT]
  float* p_s = do_s + BQ * LDT;                  // [BQ][LDS]
  float* ds_s = p_s + BQ * LDS;                  // [BQ][LDS]
  float* s_s = ds_s + BQ * LDS;                  // [BQ][LDS]
  float* dp_s = s_s + BQ * LDS;                  // [BQ][LDS]
  float* dk_s = dp_s + BQ * LDS;                 // [BK][LDA]
  float* dv_s = dk_s + BK * LDA;                 // [BK][LDA]
  float* lse_s = dv_s + BK * LDA;                // [BQ]
  float* delta_s = lse_s + BQ;                   // [BQ]

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const Mask mask = make_mask(p, h);

  load_tile<float, BK, DP, LDT>(k_s, static_cast<const float*>(p.k), p.k_str, b, h, k0, p.Sk, p.D);
  load_tile<float, BK, DP, LDT>(v_s, static_cast<const float*>(p.v), p.v_str, b, h, k0, p.Sk, p.D);
  for (int i = threadIdx.x; i < BK * LDA; i += NUM_THREADS) {
    dk_s[i] = 0.0f;
    dv_s[i] = 0.0f;
  }

  // Under causal masking, query tiles that end before this key tile starts
  // see none of its keys.
  const int q_start = p.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < p.Sq; q0 += BQ) {
    load_tile<float, BQ, DP, LDT>(q_s, static_cast<const float*>(p.q), p.q_str, b, h, q0, p.Sq, p.D);
    load_tile<float, BQ, DP, LDT>(do_s, static_cast<const float*>(p.dout), p.do_str, b, h, q0, p.Sq, p.D);
    load_rows<BQ>(lse_s, p.lse, b, h, p.H, q0, p.Sq);
    load_rows<BQ>(delta_s, p.delta, b, h, p.H, q0, p.Sq);
    __syncthreads();
    block_gemm<BQ, BK, DP, false, true, LDT, LDT, LDS>(q_s, k_s, s_s, false);    // Q·Kᵀ
    block_gemm<BQ, BK, DP, false, true, LDT, LDT, LDS>(do_s, v_s, dp_s, false);  // dO·Vᵀ
    __syncthreads();
    probs_and_dscores<float, BQ, BK, LDS, LDS>(mask, s_s, dp_s, lse_s, delta_s, p_s, ds_s, q0, k0, p.Sq);
    __syncthreads();
    block_gemm<BK, DP, BQ, true, false, LDS, LDT, LDA>(p_s, do_s, dv_s, true);   // dV += Pᵀ·dO
    block_gemm<BK, DP, BQ, true, false, LDS, LDT, LDA>(ds_s, q_s, dk_s, true);   // dK += dSᵀ·Q
    __syncthreads();
  }
  __syncthreads();  // the zeroed accumulators, for a key tile no query tile reaches
  store_tile<float, BK, DP, LDA>(static_cast<float*>(p.dk), p.dk_str, dk_s, p.scale, b, h, k0, p.Sk, p.D);
  store_tile<float, BK, DP, LDA>(static_cast<float*>(p.dv), p.dv_str, dv_s, 1.0f, b, h, k0, p.Sk, p.D);
}

// ---------------------------------------------------------------------------
// Hopper 16-bit kernels: one producer warp (TMA) and two consumer warpgroups
// (wgmma), a three-stage ring of shared-memory tiles between them.
// ---------------------------------------------------------------------------

constexpr int HOP_CONSUMER_WARPS = 8;  // two warpgroups of 64 rows each
constexpr int HOP_THREADS = HOP_CONSUMER_WARPS * 32 + 32;
constexpr int HOP_STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct HopMaps {
  CUtensorMap q, k, v, dout;
};

// The mask in base-2 units: scores and slopes times log2 e (−1e30 stays −1e30).
__device__ __forceinline__ Mask make_mask2(const FlashParams& p, int h) {
  Mask m = make_mask(p, h);
  m.scale *= LOG2E;
  m.slope *= LOG2E;
  return m;
}

// Shared memory: [Q: BQ x DP][K: STAGES x BK x DP][V: the same], 1024-byte
// aligned tiles, then the barriers.
template <typename T, int DP, int BK>
struct HopFwd {
  static constexpr int BQ = 128;
  static constexpr int Q_ELEMS = BQ * DP, KV_ELEMS = BK * DP;
  static constexpr size_t bytes =
      1024 + (Q_ELEMS + 2 * HOP_STAGES * KV_ELEMS) * sizeof(T) + (1 + 2 * HOP_STAGES) * sizeof(uint64_t);
};

template <typename T, int DP, int BK>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    flash_fwd_hopper(const FlashParams p, const __grid_constant__ HopMaps maps) {
  using L = HopFwd<T, DP, BK>;
  constexpr int BQ = L::BQ, ST = HOP_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + L::Q_ELEMS;          // stage s at k_s + s * KV_ELEMS
  T* v_s = k_s + ST * L::KV_ELEMS;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(v_s + ST * L::KV_ELEMS);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + ST;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows first
  const int n_tiles = (key_end(p, q0, BQ) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], HOP_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == HOP_CONSUMER_WARPS) {  // producer
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, L::Q_ELEMS * sizeof(T));
      tma_load_rows<BQ, DP>(q_s, &maps.q, q_bar, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::KV_ELEMS * sizeof(T));
        tma_load_rows<BK, DP>(k_s + s * L::KV_ELEMS, &maps.k, &full[s], j * BK, h, b);
        tma_load_rows<BK, DP>(v_s + s * L::KV_ELEMS, &maps.v, &full[s], j * BK, h, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + 64·wg + [0, 64); this
  // thread holds rows row0 and row0 + 8 of the accumulators.
  const int wg = warp / 4, t = threadIdx.x % 128;
  const Mask mask = make_mask2(p, h);
  const int row0 = q0 + 64 * wg + acc_row(0, t);
  const T* q_w = q_s + 64 * 64 * wg;  // this warpgroup's rows in each column atom

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST, k0 = j * BK;
    const T* k_t = k_s + s * L::KV_ELEMS;
    const T* v_t = v_s + s * L::KV_ELEMS;
    mbar_wait(&full[s], (j / ST) & 1);

    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {  // S = Q·Kᵀ, both K-major
      const int off = (kk % 4) * 16;  // column atom kk / 4, 32 bytes per step inside it
      wgmma_ss<T, BK, 0>(sc, desc_b128(q_w + (kk / 4) * BQ * 64 + off, 16),
                         desc_b128(k_t + (kk / 4) * BK * 64 + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Mask, then the online softmax in base 2; a row's four threads are a quad.
    // A tile that no mask reaches, without ALiBi, keeps the raw products: the
    // scaled row max is the raw one times the (positive) scale, and one FMA
    // inside exp2 scales and shifts each score.
    const bool masked = mask.has_window || k0 + BK > p.Sk || (mask.causal && k0 + BK - 1 > q0 + 64 * wg);
    const bool raw = !masked && mask.slope == 0.0f && mask.scale > 0.0f;
    if (!raw) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int qpos = row0 + 8 * ((i >> 1) & 1), kpos = k0 + acc_col(i, t);
        sc[i] = masked ? mask(sc[i], qpos, kpos) : mask.unmasked(sc[i], qpos, kpos);
      }
    }
    const float mul = raw ? mask.scale : 1.0f;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * mul);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = exp2f(fmaf(sc[i], mul, -m[r]));
      l[r] += sc[i];  // this thread's part of the row sum; the quad adds up at the end
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[BK / 16][4];  // P in the input type, as the A operand of P·V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<T>(sc, kk, pa[kk]);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // O += P·V, V MN-major: 16 keys = 16 rows per step
      wgmma_rs<T, DP, 1>(o, pa[kk], desc_b128(v_t + kk * 16 * 64, BK * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Epilogue: O / l in the input type, lse = m·ln 2 + log(l), l = 0 taken as 1.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.0f) l[r] = 1.0f;
    inv[r] = 1.0f / l[r];
  }
  T* out = static_cast<T*>(p.out) + b * p.out_str[0] + h * p.out_str[2];
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = (i >> 1) & 1, row = row0 + 8 * r, col = acc_col(i, t);
    if (row < p.Sq && col < p.D) {
      *reinterpret_cast<uint32_t*>(out + row * p.out_str[1] + col) = pack2<T>(o[i] * inv[r], o[i + 1] * inv[r]);
    }
  }
  if (t % 4 == 0) {
    float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row0 + 8 * r < p.Sq) lse[row0 + 8 * r] = m[r] * LN2 + logf(l[r]);
    }
  }
}

// Shared memory: [K: 128 x DP][V: 128 x DP][Q: STAGES x 64 x DP][dO: the same]
// [lse·log2 e: STAGES x 64][Δ: STAGES x 64], then the barriers.
template <typename T, int DP>
struct HopDkdv {
  static constexpr int BK = 128, BQ = 64;
  static constexpr int KV_ELEMS = BK * DP, Q_ELEMS = BQ * DP;
  static constexpr size_t bytes = 1024 + (2 * KV_ELEMS + 2 * HOP_STAGES * Q_ELEMS) * sizeof(T) +
                                  2 * HOP_STAGES * BQ * sizeof(float) + (1 + 2 * HOP_STAGES) * sizeof(uint64_t);
};

template <typename T, int DP>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    flash_dkdv_hopper(const FlashParams p, const __grid_constant__ HopMaps maps) {
  using L = HopDkdv<T, DP>;
  constexpr int BK = L::BK, BQ = L::BQ, ST = HOP_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + L::KV_ELEMS;
  T* q_s = v_s + L::KV_ELEMS;          // stage s at q_s + s * Q_ELEMS
  T* do_s = q_s + ST * L::Q_ELEMS;
  float* lse_s = reinterpret_cast<float*>(do_s + ST * L::Q_ELEMS);  // stage s at lse_s + s * BQ
  float* delta_s = lse_s + ST * BQ;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(delta_s + ST * BQ);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + ST;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int k0 = blockIdx.y * BK;  // key tile 0 sees the most query tiles under causal masking
  // Under causal masking, query tiles that end before this key tile starts
  // see none of its keys.
  const int q_start = p.causal ? k0 : 0;
  const int n_tiles = q_start < p.Sq ? (p.Sq - q_start + BQ - 1) / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes: lse/Δ stores, and lane 0's TMA bytes
      mbar_init(&empty[s], HOP_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == HOP_CONSUMER_WARPS) {  // producer
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * L::KV_ELEMS * sizeof(T));
      tma_load_rows<BK, DP>(k_s, &maps.k, kv_bar, k0, h, b);
      tma_load_rows<BK, DP>(v_s, &maps.v, kv_bar, k0, h, b);
    }
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST, q0 = q_start + j * BQ;
      if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < p.Sq;
        lse_s[s * BQ + r] = in ? p.lse[row_base + q0 + r] * LOG2E : 0.0f;  // base 2, as the scores
        delta_s[s * BQ + r] = in ? p.delta[row_base + q0 + r] : 0.0f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * L::Q_ELEMS * sizeof(T));
        tma_load_rows<BQ, DP>(q_s + s * L::Q_ELEMS, &maps.q, &full[s], q0, h, b);
        tma_load_rows<BQ, DP>(do_s + s * L::Q_ELEMS, &maps.dout, &full[s], q0, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns keys k0 + 64·wg + [0, 64); this thread holds
  // key rows key0 and key0 + 8, query columns acc_col(i, t).
  const int wg = warp / 4, t = threadIdx.x % 128;
  const Mask mask = make_mask2(p, h);
  const int key0 = k0 + 64 * wg + acc_row(0, t);
  const T* k_w = k_s + 64 * 64 * wg;
  const T* v_w = v_s + 64 * 64 * wg;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }

  mbar_wait(kv_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST, q0 = q_start + j * BQ;
    const T* q_t = q_s + s * L::Q_ELEMS;
    const T* do_t = do_s + s * L::Q_ELEMS;
    const float* lse_t = lse_s + s * BQ;
    const float* delta_t = delta_s + s * BQ;
    mbar_wait(&full[s], (j / ST) & 1);

    float st[BQ / 2], dpt[BQ / 2];  // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, keys as rows
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      st[i] = 0.0f;
      dpt[i] = 0.0f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk % 4) * 16;
      wgmma_ss<T, BQ, 0>(st, desc_b128(k_w + (kk / 4) * BK * 64 + off, 16),
                         desc_b128(q_t + (kk / 4) * BQ * 64 + off, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk % 4) * 16;
      wgmma_ss<T, BQ, 0>(dpt, desc_b128(v_w + (kk / 4) * BK * 64 + off, 16),
                         desc_b128(do_t + (kk / 4) * BQ * 64 + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // Pᵀ = exp(Sᵀ − lse) and dSᵀ = Pᵀ∘(dPᵀ − Δ), lse (base 2) and Δ per
    // column; queries past Sq give 0. A tile that no mask reaches, without
    // ALiBi, scales and shifts each raw product with one FMA.
    const bool masked =
        mask.has_window || k0 + BK > p.Sk || q0 + BQ > p.Sq || (mask.causal && q0 < k0 + BK);
    const bool raw = !masked && mask.slope == 0.0f;
    if (raw) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) st[i] = exp2f(fmaf(st[i], mask.scale, -lse_t[acc_col(i, t)]));
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int c = acc_col(i, t), key = key0 + 8 * ((i >> 1) & 1), qry = q0 + c;
        const float s2 = masked ? mask(st[i], qry, key) : mask.unmasked(st[i], qry, key);
        st[i] = qry < p.Sq ? exp2f(s2 - lse_t[c]) : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) dpt[i] = st[i] * (dpt[i] - delta_t[acc_col(i, t)]);
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // Pᵀ and dSᵀ in the input type
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      acc_to_a<T>(st, kk, pa[kk]);
      acc_to_a<T>(dpt, kk, da[kk]);
    }
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)  // dV += Pᵀ·dO, dO MN-major
      wgmma_rs<T, DP, 1>(dv, pa[kk], desc_b128(do_t + kk * 16 * 64, BQ * 128), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)  // dK += dSᵀ·Q, Q MN-major
      wgmma_rs<T, DP, 1>(dk, da[kk], desc_b128(q_t + kk * 16 * 64, BQ * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Epilogue: dK · scale and dV in the input type.
  T* dk_g = static_cast<T*>(p.dk) + b * p.dk_str[0] + h * p.dk_str[2];
  T* dv_g = static_cast<T*>(p.dv) + b * p.dv_str[0] + h * p.dv_str[2];
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int key = key0 + 8 * ((i >> 1) & 1), col = acc_col(i, t);
    if (key < p.Sk && col < p.D) {
      *reinterpret_cast<uint32_t*>(dk_g + key * p.dk_str[1] + col) = pack2<T>(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_g + key * p.dv_str[1] + col) = pack2<T>(dv[i], dv[i + 1]);
    }
  }
}

// Shared memory: [Q: 128 x DP][dO: 128 x DP][K: STAGES x 64 x DP][V: the
// same], then the barriers.
template <typename T, int DP>
struct HopDq {
  static constexpr int BQ = 128, BK = 64;
  static constexpr int Q_ELEMS = BQ * DP, KV_ELEMS = BK * DP;
  static constexpr size_t bytes =
      1024 + (2 * Q_ELEMS + 2 * HOP_STAGES * KV_ELEMS) * sizeof(T) + (1 + 2 * HOP_STAGES) * sizeof(uint64_t);
};

// 16-bit dQ: CTA = 128 query rows (64 per warpgroup), key tiles of 64. The
// register budget sets the key tile: S, dP and dQ accumulators (32 + 32 +
// 32 or 64 a thread) plus dS as the A operand fit under the 168 registers a
// 288-thread CTA gets; 128-key tiles would not.
template <typename T, int DP>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    flash_dq_hopper(const FlashParams p, const __grid_constant__ HopMaps maps) {
  using L = HopDq<T, DP>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = HOP_STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + L::Q_ELEMS;
  T* k_s = do_s + L::Q_ELEMS;         // stage s at k_s + s * KV_ELEMS
  T* v_s = k_s + ST * L::KV_ELEMS;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(v_s + ST * L::KV_ELEMS);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + ST;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows first
  const int n_tiles = (key_end(p, q0, BQ) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], HOP_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == HOP_CONSUMER_WARPS) {  // producer: Q and dO once, then the K/V ring
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, 2 * L::Q_ELEMS * sizeof(T));
      tma_load_rows<BQ, DP>(q_s, &maps.q, q_bar, q0, h, b);
      tma_load_rows<BQ, DP>(do_s, &maps.dout, q_bar, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::KV_ELEMS * sizeof(T));
        tma_load_rows<BK, DP>(k_s + s * L::KV_ELEMS, &maps.k, &full[s], j * BK, h, b);
        tma_load_rows<BK, DP>(v_s + s * L::KV_ELEMS, &maps.v, &full[s], j * BK, h, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + 64·wg + [0, 64); this
  // thread holds rows row0 and row0 + 8 for the whole CTA, so their lse (in
  // base 2, as the scores) and Δ live in registers. Rows past Sq read as
  // zeros and are never written.
  const int wg = warp / 4, t = threadIdx.x % 128;
  const Mask mask = make_mask2(p, h);
  const int row0 = q0 + 64 * wg + acc_row(0, t);
  const T* q_w = q_s + 64 * 64 * wg;  // this warpgroup's rows in each column atom
  const T* do_w = do_s + 64 * 64 * wg;
  float lse2[2], dlt[2];
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < p.Sq ? p.lse[row_base + row] * LOG2E : 0.0f;
    dlt[r] = row < p.Sq ? p.delta[row_base + row] : 0.0f;
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST, k0 = j * BK;
    const T* k_t = k_s + s * L::KV_ELEMS;
    const T* v_t = v_s + s * L::KV_ELEMS;
    mbar_wait(&full[s], (j / ST) & 1);

    float sc[BK / 2], dp[BK / 2];  // S = Q·Kᵀ and dP = dO·Vᵀ, both operands K-major
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      sc[i] = 0.0f;
      dp[i] = 0.0f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk % 4) * 16;  // column atom kk / 4, 32 bytes per step inside it
      wgmma_ss<T, BK, 0>(sc, desc_b128(q_w + (kk / 4) * BQ * 64 + off, 16),
                         desc_b128(k_t + (kk / 4) * BK * 64 + off, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk % 4) * 16;
      wgmma_ss<T, BK, 0>(dp, desc_b128(do_w + (kk / 4) * BQ * 64 + off, 16),
                         desc_b128(v_t + (kk / 4) * BK * 64 + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp2(S·scale·log2 e − lse₂), then dS = P∘(dP − Δ) rounded to T. A
    // tile that no mask reaches, without ALiBi, scales and shifts each raw
    // product with one FMA; the others go through the mask in the Pallas
    // _block_scores order.
    const bool masked = mask.has_window || k0 + BK > p.Sk || (mask.causal && k0 + BK - 1 > q0 + 64 * wg);
    const bool raw = !masked && mask.slope == 0.0f;
    if (raw) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = exp2f(fmaf(sc[i], mask.scale, -lse2[(i >> 1) & 1]));
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1, qpos = row0 + 8 * r, kpos = k0 + acc_col(i, t);
        const float s2 = masked ? mask(sc[i], qpos, kpos) : mask.unmasked(sc[i], qpos, kpos);
        sc[i] = exp2f(s2 - lse2[r]);
      }
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) dp[i] = sc[i] * (dp[i] - dlt[(i >> 1) & 1]);
    uint32_t da[BK / 16][4];  // dS in the input type, as the A operand of dS·K
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a<T>(dp, kk, da[kk]);
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // dQ += dS·K, K MN-major: 16 keys = 16 rows per step
      wgmma_rs<T, DP, 1>(dq, da[kk], desc_b128(k_t + kk * 16 * 64, BK * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Epilogue: dQ · scale in the input type.
  T* dq_g = static_cast<T*>(p.dq) + b * p.dq_str[0] + h * p.dq_str[2];
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1), col = acc_col(i, t);
    if (row < p.Sq && col < p.D) {
      *reinterpret_cast<uint32_t*>(dq_g + row * p.dq_str[1] + col) = pack2<T>(dq[i] * p.scale, dq[i + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 dQ: one CTA per (q-tile, h, b), looping over key tiles.
// ---------------------------------------------------------------------------

template <int DP>
struct DqSmem {
  static constexpr int BQ = F32_TILE, BK = F32_TILE;
  static constexpr int LDT = ld_t<float, DP>(), LDS = ld_f<BK>(), LDA = ld_f<DP>();
  static constexpr size_t bytes = (2 * BQ * LDT + 2 * BK * LDT + 3 * BQ * LDS + BQ * LDA + 2 * BQ) * sizeof(float);
};

template <int DP>
__global__ void __launch_bounds__(NUM_THREADS) flash_dq_f32_kernel(const FlashParams p) {
  using L = DqSmem<DP>;
  constexpr int BQ = L::BQ, BK = L::BK, LDT = L::LDT, LDS = L::LDS, LDA = L::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [BQ][LDT]
  float* do_s = q_s + BQ * LDT;                  // [BQ][LDT]
  float* k_s = do_s + BQ * LDT;                  // [BK][LDT]
  float* v_s = k_s + BK * LDT;                   // [BK][LDT]
  float* ds_s = v_s + BK * LDT;                  // [BQ][LDS]
  float* s_s = ds_s + BQ * LDS;                  // [BQ][LDS]
  float* dp_s = s_s + BQ * LDS;                  // [BQ][LDS]
  float* dq_s = dp_s + BQ * LDS;                 // [BQ][LDA]
  float* lse_s = dq_s + BQ * LDA;                // [BQ]
  float* delta_s = lse_s + BQ;                   // [BQ]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const Mask mask = make_mask(p, h);

  load_tile<float, BQ, DP, LDT>(q_s, static_cast<const float*>(p.q), p.q_str, b, h, q0, p.Sq, p.D);
  load_tile<float, BQ, DP, LDT>(do_s, static_cast<const float*>(p.dout), p.do_str, b, h, q0, p.Sq, p.D);
  load_rows<BQ>(lse_s, p.lse, b, h, p.H, q0, p.Sq);
  load_rows<BQ>(delta_s, p.delta, b, h, p.H, q0, p.Sq);
  for (int i = threadIdx.x; i < BQ * LDA; i += NUM_THREADS) dq_s[i] = 0.0f;

  const int k_end = key_end(p, q0, BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    load_tile<float, BK, DP, LDT>(k_s, static_cast<const float*>(p.k), p.k_str, b, h, k0, p.Sk, p.D);
    load_tile<float, BK, DP, LDT>(v_s, static_cast<const float*>(p.v), p.v_str, b, h, k0, p.Sk, p.D);
    __syncthreads();
    block_gemm<BQ, BK, DP, false, true, LDT, LDT, LDS>(q_s, k_s, s_s, false);    // Q·Kᵀ
    block_gemm<BQ, BK, DP, false, true, LDT, LDT, LDS>(do_s, v_s, dp_s, false);  // dO·Vᵀ
    __syncthreads();
    probs_and_dscores<float, BQ, BK, LDS, LDS>(mask, s_s, dp_s, lse_s, delta_s, static_cast<float*>(nullptr),
                                               ds_s, q0, k0, p.Sq);
    __syncthreads();
    block_gemm<BQ, DP, BK, false, false, LDS, LDT, LDA>(ds_s, k_s, dq_s, true);  // dQ += dS·K
    __syncthreads();
  }
  store_tile<float, BQ, DP, LDA>(static_cast<float*>(p.dq), p.dq_str, dq_s, p.scale, b, h, q0, p.Sq, p.D);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

enum Which { FWD, DKDV, DQ };

template <typename Kernel>
int launch_with_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// The fp32 kernels.
template <int DP>
int launch_f32(const FlashParams& p, Which which, cudaStream_t stream) {
  void (*kernel)(const FlashParams) = nullptr;
  size_t smem = 0;
  int tiles = (p.Sq + F32_TILE - 1) / F32_TILE;
  if (which == FWD) {
    kernel = flash_fwd_f32_kernel<DP>;
    smem = FwdSmem<DP>::bytes;
  } else if (which == DKDV) {
    kernel = flash_dkdv_f32_kernel<DP>;
    smem = DkdvSmem<DP>::bytes;
    tiles = (p.Sk + F32_TILE - 1) / F32_TILE;
  } else {
    kernel = flash_dq_f32_kernel<DP>;
    smem = DqSmem<DP>::bytes;
  }
  const int e = launch_with_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<dim3(tiles, p.H, p.B), NUM_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The 16-bit kernels on Hopper. Their inputs need TMA's
// 16-byte rows and strides, their outputs 4-byte pairs; the wrapper pads
// anything else before the launch.
template <typename T, int DP>
int launch_hopper(const FlashParams& p, Which which, cudaStream_t stream) {
  if (p.D % 8 != 0 || !aligned16(p.q, p.q_str) || !aligned16(p.k, p.k_str) || !aligned16(p.v, p.v_str)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool is_bf16 = std::is_same<T, bf16>::value;
  HopMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (which == FWD) {
    constexpr int BK = DP == 64 ? 128 : 64;
    using L = HopFwd<T, DP, BK>;
    if (!even(p.out, p.out_str)) return static_cast<int>(cudaErrorInvalidValue);
    if (!tile_map(&maps.q, p.q, is_bf16, p.q_str, p.B, p.Sq, p.H, p.D, L::BQ) ||
        !tile_map(&maps.k, p.k, is_bf16, p.k_str, p.B, p.Sk, p.H, p.D, BK) ||
        !tile_map(&maps.v, p.v, is_bf16, p.v_str, p.B, p.Sk, p.H, p.D, BK)) {
      return static_cast<int>(cudaErrorNotSupported);
    }
    const int e = launch_with_smem(flash_fwd_hopper<T, DP, BK>, L::bytes);
    if (e != 0) return e;
    const dim3 grid(p.B * p.H, (p.Sq + L::BQ - 1) / L::BQ);
    flash_fwd_hopper<T, DP, BK><<<grid, HOP_THREADS, L::bytes, stream>>>(p, maps);
  } else if (which == DKDV) {
    using L = HopDkdv<T, DP>;
    if (!aligned16(p.dout, p.do_str) || !even(p.dk, p.dk_str) || !even(p.dv, p.dv_str)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (!tile_map(&maps.q, p.q, is_bf16, p.q_str, p.B, p.Sq, p.H, p.D, L::BQ) ||
        !tile_map(&maps.dout, p.dout, is_bf16, p.do_str, p.B, p.Sq, p.H, p.D, L::BQ) ||
        !tile_map(&maps.k, p.k, is_bf16, p.k_str, p.B, p.Sk, p.H, p.D, L::BK) ||
        !tile_map(&maps.v, p.v, is_bf16, p.v_str, p.B, p.Sk, p.H, p.D, L::BK)) {
      return static_cast<int>(cudaErrorNotSupported);
    }
    const int e = launch_with_smem(flash_dkdv_hopper<T, DP>, L::bytes);
    if (e != 0) return e;
    const dim3 grid(p.B * p.H, (p.Sk + L::BK - 1) / L::BK);
    flash_dkdv_hopper<T, DP><<<grid, HOP_THREADS, L::bytes, stream>>>(p, maps);
  } else {
    using L = HopDq<T, DP>;
    if (!aligned16(p.dout, p.do_str) || !even(p.dq, p.dq_str)) return static_cast<int>(cudaErrorInvalidValue);
    if (!tile_map(&maps.q, p.q, is_bf16, p.q_str, p.B, p.Sq, p.H, p.D, L::BQ) ||
        !tile_map(&maps.dout, p.dout, is_bf16, p.do_str, p.B, p.Sq, p.H, p.D, L::BQ) ||
        !tile_map(&maps.k, p.k, is_bf16, p.k_str, p.B, p.Sk, p.H, p.D, L::BK) ||
        !tile_map(&maps.v, p.v, is_bf16, p.v_str, p.B, p.Sk, p.H, p.D, L::BK)) {
      return static_cast<int>(cudaErrorNotSupported);
    }
    const int e = launch_with_smem(flash_dq_hopper<T, DP>, L::bytes);
    if (e != 0) return e;
    const dim3 grid(p.B * p.H, (p.Sq + L::BQ - 1) / L::BQ);
    flash_dq_hopper<T, DP><<<grid, HOP_THREADS, L::bytes, stream>>>(p, maps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const FlashParams& p, Which which, cudaStream_t stream) {
  if constexpr (IS_16BIT<T>) {
    return p.D <= 64 ? launch_hopper<T, 64>(p, which, stream) : launch_hopper<T, 128>(p, which, stream);
  } else {
    if (p.D <= 32) return launch_f32<32>(p, which, stream);
    if (p.D <= 64) return launch_f32<64>(p, which, stream);
    return launch_f32<128>(p, which, stream);
  }
}

int dispatch(const FlashParams* p, Which which, void* stream) {
  if (p == nullptr || p->D < 1 || p->D > MAX_D || p->B < 1 || p->B > 65535 || p->H < 1 ||
      p->H > 65535 || p->Sq < 1 || p->Sk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return dispatch_d<float>(*p, which, s);
  if (p->dtype == 1) return dispatch_d<bf16>(*p, which, s);
  if (p->dtype == 2) return dispatch_d<half>(*p, which, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The caller has checked shapes, dtypes,
// devices, a contiguous last dimension and 1 <= D <= 128, and for the 16-bit kernels
// the alignment above.
extern "C" int dstt_flash_fwd(const FlashParams* p, void* stream) { return dispatch(p, FWD, stream); }
extern "C" int dstt_flash_bwd_dkdv(const FlashParams* p, void* stream) { return dispatch(p, DKDV, stream); }
extern "C" int dstt_flash_bwd_dq(const FlashParams* p, void* stream) { return dispatch(p, DQ, stream); }
