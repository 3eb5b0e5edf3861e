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
// and Δ are [B, H, S] fp32.
//
// Grid. The Pallas kernels accumulate over a sequential innermost grid axis in
// VMEM scratch; here that axis is a loop inside one CTA:
//   forward and dQ: one CTA per (b, h, q-tile), looping over key tiles;
//   dK/dV:          one CTA per (b, h, key-tile), looping over query tiles.
// No atomics, so every result is deterministic. Under causal masking the tiles
// wholly above the diagonal are skipped, their loads included. The ragged edge
// (S not a multiple of the tile) is bounds-checked instead of zero-padded; for
// causal self-attention that gives what the JAX wrapper's padding gives.
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
// ~1.5x the bytes and is bound by operations. The design: 64x64 tiles (bf16,
// fp16) staged in shared memory by 16-byte loads, every product on the tensor
// cores through nvcuda::wmma fragments with fp32 accumulators (common.cuh),
// 8 warps per CTA,
// shared-memory rows padded so a fragment's rows fall in different banks, the
// softmax state and the forward's accumulator in shared memory (each key tile
// rescales its rows), the backward's dK/dV and dQ accumulators in registers,
// and one load of each k/v (forward, dQ) or q/dO (dK/dV) tile per CTA
// iteration. fp32 inputs take 32x32 tiles, scalar FMAs and shared-memory
// accumulators. Left to later work: wgmma, TMA/cp.async double buffering, the
// forward's accumulator in registers, and splitting the causal work evenly
// over CTAs.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute).

#include "attention.cuh"

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

template <typename T> struct Tile;
template <> struct Tile<bf16> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<half> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<float> { static constexpr int BQ = 32, BK = 32; };

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
// Forward: one CTA per (q-tile, h, b).
// ---------------------------------------------------------------------------

template <typename T, int DP>
struct FwdSmem {
  static constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  static constexpr int LDT = ld_t<T, DP>(), LDP = ld_t<T, BK>(), LDS = ld_f<BK>(), LDA = ld_f<DP>();
  static constexpr size_t bytes =
      (BQ * LDT + 2 * BK * LDT + BQ * LDP) * sizeof(T) + (BQ * LDS + BQ * LDA + 2 * BQ) * sizeof(float);
};

template <typename T, int DP>
__global__ void __launch_bounds__(NUM_THREADS) flash_fwd_kernel(const FlashParams p) {
  using L = FwdSmem<T, DP>;
  constexpr int BQ = L::BQ, BK = L::BK, LDT = L::LDT, LDP = L::LDP, LDS = L::LDS, LDA = L::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                   // [BQ][LDT]
  T* k_s = q_s + BQ * LDT;                                // [BK][LDT]
  T* v_s = k_s + BK * LDT;                                // [BK][LDT]
  T* p_s = v_s + BK * LDT;                                // [BQ][LDP], P in the input type
  float* s_s = reinterpret_cast<float*>(p_s + BQ * LDP);  // [BQ][LDS] scores
  float* acc_s = s_s + BQ * LDS;                          // [BQ][LDA] output accumulator
  float* m_s = acc_s + BQ * LDA;                          // [BQ] running max
  float* l_s = m_s + BQ;                                  // [BQ] running sum

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Mask mask = make_mask(p, h);

  load_tile<T, BQ, DP, LDT>(q_s, static_cast<const T*>(p.q), p.q_str, b, h, q0, p.Sq, p.D);
  for (int i = threadIdx.x; i < BQ * LDA; i += NUM_THREADS) acc_s[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NUM_THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.0f;
  }

  const int k_end = key_end(p, q0, BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    load_tile<T, BK, DP, LDT>(k_s, static_cast<const T*>(p.k), p.k_str, b, h, k0, p.Sk, p.D);
    load_tile<T, BK, DP, LDT>(v_s, static_cast<const T*>(p.v), p.v_str, b, h, k0, p.Sk, p.D);
    __syncthreads();
    block_gemm<BQ, BK, DP, false, true, LDT, LDT, LDS>(q_s, k_s, s_s, false);
    __syncthreads();

    // Online softmax, one warp per row.
    for (int r = warp; r < BQ; r += NUM_WARPS) {
      float sv[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int c = lane + 32 * j;
        sv[j] = mask(s_s[r * LDS + c], q0 + r, k0 + c);
        mx = fmaxf(mx, sv[j]);
      }
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float pj = expf(sv[j] - m_new);
        p_s[r * LDP + lane + 32 * j] = from_float<T>(pj);
        sum += pj;
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_new);
      for (int d = lane; d < DP; d += 32) acc_s[r * LDA + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();
    block_gemm<BQ, DP, BK, false, false, LDP, LDT, LDA>(p_s, v_s, acc_s, true);
    __syncthreads();
  }

  // O = acc / l in the input type, lse = m + log(l).
  T* out = static_cast<T*>(p.out) + b * p.out_str[0] + h * p.out_str[2];
  for (int i = threadIdx.x; i < BQ * DP; i += NUM_THREADS) {
    const int r = i / DP, d = i % DP;
    if (q0 + r < p.Sq && d < p.D) {
      const float l = l_s[r] == 0.0f ? 1.0f : l_s[r];
      out[(q0 + r) * p.out_str[1] + d] = from_float<T>(acc_s[r * LDA + d] / l);
    }
  }
  float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.Sq;
  for (int r = threadIdx.x; r < BQ; r += NUM_THREADS) {
    if (q0 + r < p.Sq) lse[q0 + r] = m_s[r] + logf(l_s[r] == 0.0f ? 1.0f : l_s[r]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (key-tile, h, b), looping over query tiles.
// ---------------------------------------------------------------------------

template <typename T, int DP>
struct DkdvSmem {
  static constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  static constexpr int LDT = ld_t<T, DP>(), LDP = ld_t<T, BK>(), LDS = ld_f<BK>(), LDA = ld_f<DP>();
  // 16-bit inputs keep dK and dV in registers (RegAcc); fp32 accumulates in shared memory
  static constexpr bool REG = IS_16BIT<T>;
  static constexpr size_t bytes = (2 * BK * LDT + 2 * BQ * LDT + 2 * BQ * LDP) * sizeof(T) +
                                  (2 * BQ * LDS + (REG ? 0 : 2 * BK * LDA) + 2 * BQ) * sizeof(float);
  static_assert(!REG || BK * LDA <= 2 * BQ * LDS, "the dK/dV staging tile must fit in the score buffers");
};

template <typename T, int DP>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dkdv_kernel(const FlashParams p) {
  using L = DkdvSmem<T, DP>;
  constexpr int BQ = L::BQ, BK = L::BK, LDT = L::LDT, LDP = L::LDP, LDS = L::LDS, LDA = L::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                   // [BK][LDT]
  T* v_s = k_s + BK * LDT;                                // [BK][LDT]
  T* q_s = v_s + BK * LDT;                                // [BQ][LDT]
  T* do_s = q_s + BQ * LDT;                               // [BQ][LDT]
  T* p_s = do_s + BQ * LDT;                               // [BQ][LDP]
  T* ds_s = p_s + BQ * LDP;                               // [BQ][LDP]
  float* s_s = reinterpret_cast<float*>(ds_s + BQ * LDP); // [BQ][LDS]
  float* dp_s = s_s + BQ * LDS;                           // [BQ][LDS]
  float* dk_s = dp_s + BQ * LDS;                          // [BK][LDA] (fp32 inputs only)
  float* dv_s = dk_s + (L::REG ? 0 : BK * LDA);           // [BK][LDA] (fp32 inputs only)
  float* lse_s = dv_s + (L::REG ? 0 : BK * LDA);          // [BQ]
  float* delta_s = lse_s + BQ;                            // [BQ]

  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const Mask mask = make_mask(p, h);

  load_tile<T, BK, DP, LDT>(k_s, static_cast<const T*>(p.k), p.k_str, b, h, k0, p.Sk, p.D);
  load_tile<T, BK, DP, LDT>(v_s, static_cast<const T*>(p.v), p.v_str, b, h, k0, p.Sk, p.D);
  RegAcc<T, BK, DP> dk_acc, dv_acc;
  if constexpr (L::REG) {
    dk_acc.zero();
    dv_acc.zero();
  } else {
    for (int i = threadIdx.x; i < BK * LDA; i += NUM_THREADS) {
      dk_s[i] = 0.0f;
      dv_s[i] = 0.0f;
    }
  }

  // Under causal masking, query tiles that end before this key tile starts
  // see none of its keys.
  const int q_start = p.causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_start; q0 < p.Sq; q0 += BQ) {
    load_tile<T, BQ, DP, LDT>(q_s, static_cast<const T*>(p.q), p.q_str, b, h, q0, p.Sq, p.D);
    load_tile<T, BQ, DP, LDT>(do_s, static_cast<const T*>(p.dout), p.do_str, b, h, q0, p.Sq, p.D);
    load_rows<BQ>(lse_s, p.lse, b, h, p.H, q0, p.Sq);
    load_rows<BQ>(delta_s, p.delta, b, h, p.H, q0, p.Sq);
    __syncthreads();
    block_gemm<BQ, BK, DP, false, true, LDT, LDT, LDS>(q_s, k_s, s_s, false);    // Q·Kᵀ
    block_gemm<BQ, BK, DP, false, true, LDT, LDT, LDS>(do_s, v_s, dp_s, false);  // dO·Vᵀ
    __syncthreads();
    probs_and_dscores<T, BQ, BK, LDS, LDP>(mask, s_s, dp_s, lse_s, delta_s, p_s, ds_s, q0, k0, p.Sq);
    __syncthreads();
    if constexpr (L::REG) {
      dv_acc.template mma<BQ, true, false, LDP, LDT>(p_s, do_s);   // dV += Pᵀ·dO
      dk_acc.template mma<BQ, true, false, LDP, LDT>(ds_s, q_s);   // dK += dSᵀ·Q
    } else {
      block_gemm<BK, DP, BQ, true, false, LDP, LDT, LDA>(p_s, do_s, dv_s, true);
      block_gemm<BK, DP, BQ, true, false, LDP, LDT, LDA>(ds_s, q_s, dk_s, true);
    }
    __syncthreads();
  }

  if constexpr (L::REG) {  // stage each accumulator through the free score buffers
    dk_acc.store(s_s, LDA);
    __syncthreads();
    store_tile<T, BK, DP, LDA>(static_cast<T*>(p.dk), p.dk_str, s_s, p.scale, b, h, k0, p.Sk, p.D);
    __syncthreads();
    dv_acc.store(s_s, LDA);
    __syncthreads();
    store_tile<T, BK, DP, LDA>(static_cast<T*>(p.dv), p.dv_str, s_s, 1.0f, b, h, k0, p.Sk, p.D);
  } else {
    store_tile<T, BK, DP, LDA>(static_cast<T*>(p.dk), p.dk_str, dk_s, p.scale, b, h, k0, p.Sk, p.D);
    store_tile<T, BK, DP, LDA>(static_cast<T*>(p.dv), p.dv_str, dv_s, 1.0f, b, h, k0, p.Sk, p.D);
  }
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (q-tile, h, b), looping over key tiles.
// ---------------------------------------------------------------------------

template <typename T, int DP>
struct DqSmem {
  static constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  static constexpr int LDT = ld_t<T, DP>(), LDP = ld_t<T, BK>(), LDS = ld_f<BK>(), LDA = ld_f<DP>();
  // 16-bit inputs keep dQ in registers (RegAcc); fp32 accumulates in shared memory
  static constexpr bool REG = IS_16BIT<T>;
  static constexpr size_t bytes = (2 * BQ * LDT + 2 * BK * LDT + BQ * LDP) * sizeof(T) +
                                  (2 * BQ * LDS + (REG ? 0 : BQ * LDA) + 2 * BQ) * sizeof(float);
  static_assert(!REG || BQ * LDA <= 2 * BQ * LDS, "the dQ staging tile must fit in the score buffers");
};

template <typename T, int DP>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dq_kernel(const FlashParams p) {
  using L = DqSmem<T, DP>;
  constexpr int BQ = L::BQ, BK = L::BK, LDT = L::LDT, LDP = L::LDP, LDS = L::LDS, LDA = L::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                   // [BQ][LDT]
  T* do_s = q_s + BQ * LDT;                               // [BQ][LDT]
  T* k_s = do_s + BQ * LDT;                               // [BK][LDT]
  T* v_s = k_s + BK * LDT;                                // [BK][LDT]
  T* ds_s = v_s + BK * LDT;                               // [BQ][LDP]
  float* s_s = reinterpret_cast<float*>(ds_s + BQ * LDP); // [BQ][LDS]
  float* dp_s = s_s + BQ * LDS;                           // [BQ][LDS]
  float* dq_s = dp_s + BQ * LDS;                          // [BQ][LDA] (fp32 inputs only)
  float* lse_s = dq_s + (L::REG ? 0 : BQ * LDA);          // [BQ]
  float* delta_s = lse_s + BQ;                            // [BQ]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const Mask mask = make_mask(p, h);

  load_tile<T, BQ, DP, LDT>(q_s, static_cast<const T*>(p.q), p.q_str, b, h, q0, p.Sq, p.D);
  load_tile<T, BQ, DP, LDT>(do_s, static_cast<const T*>(p.dout), p.do_str, b, h, q0, p.Sq, p.D);
  load_rows<BQ>(lse_s, p.lse, b, h, p.H, q0, p.Sq);
  load_rows<BQ>(delta_s, p.delta, b, h, p.H, q0, p.Sq);
  RegAcc<T, BQ, DP> dq_acc;
  if constexpr (L::REG) {
    dq_acc.zero();
  } else {
    for (int i = threadIdx.x; i < BQ * LDA; i += NUM_THREADS) dq_s[i] = 0.0f;
  }

  const int k_end = key_end(p, q0, BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    load_tile<T, BK, DP, LDT>(k_s, static_cast<const T*>(p.k), p.k_str, b, h, k0, p.Sk, p.D);
    load_tile<T, BK, DP, LDT>(v_s, static_cast<const T*>(p.v), p.v_str, b, h, k0, p.Sk, p.D);
    __syncthreads();
    block_gemm<BQ, BK, DP, false, true, LDT, LDT, LDS>(q_s, k_s, s_s, false);    // Q·Kᵀ
    block_gemm<BQ, BK, DP, false, true, LDT, LDT, LDS>(do_s, v_s, dp_s, false);  // dO·Vᵀ
    __syncthreads();
    probs_and_dscores<T, BQ, BK, LDS, LDP>(mask, s_s, dp_s, lse_s, delta_s, static_cast<T*>(nullptr),
                                           ds_s, q0, k0, p.Sq);
    __syncthreads();
    if constexpr (L::REG) {
      dq_acc.template mma<BK, false, false, LDP, LDT>(ds_s, k_s);          // dQ += dS·K
    } else {
      block_gemm<BQ, DP, BK, false, false, LDP, LDT, LDA>(ds_s, k_s, dq_s, true);
    }
    __syncthreads();
  }

  if constexpr (L::REG) {  // stage the accumulator through the free score buffers
    dq_acc.store(s_s, LDA);
    __syncthreads();
    dq_s = s_s;
  }
  store_tile<T, BQ, DP, LDA>(static_cast<T*>(p.dq), p.dq_str, dq_s, p.scale, b, h, q0, p.Sq, p.D);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

enum Which { FWD, DKDV, DQ };

template <typename T, int DP>
int launch(const FlashParams& p, Which which, cudaStream_t stream) {
  constexpr int BQ = Tile<T>::BQ, BK = Tile<T>::BK;
  void (*kernel)(const FlashParams);
  size_t smem;
  dim3 grid;
  if (which == FWD) {
    kernel = flash_fwd_kernel<T, DP>;
    smem = FwdSmem<T, DP>::bytes;
    grid = dim3((p.Sq + BQ - 1) / BQ, p.H, p.B);
  } else if (which == DKDV) {
    kernel = flash_bwd_dkdv_kernel<T, DP>;
    smem = DkdvSmem<T, DP>::bytes;
    grid = dim3((p.Sk + BK - 1) / BK, p.H, p.B);
  } else {
    kernel = flash_bwd_dq_kernel<T, DP>;
    smem = DqSmem<T, DP>::bytes;
    grid = dim3((p.Sq + BQ - 1) / BQ, p.H, p.B);
  }
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const FlashParams& p, Which which, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, which, stream);
  if (p.D <= 64) return launch<T, 64>(p, which, stream);
  return launch<T, 128>(p, which, stream);
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
// devices, a contiguous last dimension and 1 <= D <= 128.
extern "C" int dstt_flash_fwd(const FlashParams* p, void* stream) { return dispatch(p, FWD, stream); }
extern "C" int dstt_flash_bwd_dkdv(const FlashParams* p, void* stream) { return dispatch(p, DKDV, stream); }
extern "C" int dstt_flash_bwd_dq(const FlashParams* p, void* stream) { return dispatch(p, DQ, stream); }
