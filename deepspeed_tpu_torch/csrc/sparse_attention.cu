// Block-sparse flash attention for training on Hopper (sm_90a): forward, dQ
// and dK/dV over a static block layout.
//
// Replaces the three Pallas kernels of deepspeed_tpu/ops/sparse_attention/kernels.py:
//   dstt_sparse_fwd      <- _fwd_kernel  (:75,  pallas_call :142)
//   dstt_sparse_bwd_dq   <- _dq_kernel   (:154, pallas_call :248)
//   dstt_sparse_bwd_dkdv <- _dkdv_kernel (:192, pallas_call :268)
//
// What they compute, per (batch b, head h). The [nq, nk] block layout (block
// rows of the sequence) arrives compressed by the host into lists:
//   k_lists [nq][max_a], k_counts [nq]: query block qi attends key blocks
//     k_lists[qi][0 .. k_counts[qi]), ascending;
//   q_lists [nk][max_aq], q_counts [nk]: the transposed lists, the query
//     blocks that attend key block kj (q_counts[kj] may be 0).
// Scores s[q,k] = scale·(Q·Kᵀ)[q,k] over the listed blocks only, then −1e30
// where causal and q < k (only the diagonal block qi == kj can hold such
// pairs: the causal layout is lower block-triangular). Then
//   forward: O = softmax(s)·V with an online softmax over the listed key
//            blocks, lse = m + log(l), l == 0 counted as 1;
//   dQ:      P = exp(s − lse), dS = P∘(dO·Vᵀ − Δ), dQ = scale·dS·K;
//   dK/dV:   dV = Pᵀ·dO, dK = scale·dSᵀ·Q over the query blocks of q_lists;
//            a key block no query attends gets dK = dV = 0;
// with Δ = rowsum(dO∘O) computed by the caller (flash_delta). −1e30 and the
// l == 0 rule are the Pallas kernels' NEG_INF and l_safe, so the kernels and
// the plain versions give 0 at the same places.
//
// Layout. q/k/v/dO are read where the model left them, [B, S, H, D] with
// explicit batch/sequence/head strides (the last dimension contiguous); the
// JAX wrapper's [B·H, S, D] transposes are TPU tiling and are not made here.
// O/dQ/dK/dV are written with their own strides; lse and Δ are [B, H, S] fp32
// (the flash port's layout, not the Pallas 128-lane broadcast).
//
// Input types: fp32, bf16 and fp16. 16-bit rounding follows the Pallas
// kernels: P is cast to the input type before P·V and before Pᵀ·dO, dS before
// dS·K and dSᵀ·Q; every product accumulates in fp32 and O, dQ, dK, dV are
// written in the input type from fp32 accumulators. No atomics anywhere and
// every sum in a fixed order, so two calls give the same bits and resume
// stays bitwise.
//
// What bounds it on this card. Each active block pair is a flash tile: at
// the slice's shape (S = 8192, block 64, D = 64, bf16, 2,304 active pairs per
// (b, h) out of 8,256 causal ones) a kernel does 4 (forward) to 8 (dK/dV)
// ·64²·64 flops per pair and reads about 1 + 18 (the mean list length)
// tiles per block, so it is bound by the tensor cores, as the dense flash
// kernels are.
//
// The 16-bit kernels at blocks 64 and 128 (sparse_fwd_hopper,
// sparse_bwd_dq_hopper, sparse_bwd_dkdv_hopper) are built as the flash
// kernels' Hopper kernels (flash_attention.cu, hopper.cuh): one TMA producer
// warp and two consumer warpgroups a CTA, a four-stage mbarrier ring of
// 128-byte-swizzled tiles, every product a wgmma with fp32 accumulators in
// registers, P and dS rounded in registers and fed back as the register A
// operand, exp2 with one FMA on tiles outside the diagonal block. What is new
// is the walk:
//   forward: one CTA per (query block, h, b), Q loaded once; the producer
//          streams the 64-key K/V tiles of k_lists[qi]; the online max and
//          sum of each row (base 2) and O stay in registers, O and lse are
//          written from them at the end. Query blocks run longest list
//          first (the host's dq_order).
//   dQ:    the same walk, Q and dO loaded once.
//   dK/dV: one CTA per (key block, h, b), K and V loaded once; the
//          producer streams the 64-row Q/dO tiles of q_lists[kj] with their
//          lse·log2 e and Δ. Key blocks run longest list first (the host's
//          dkdv_order). The lists are lopsided (fixed-64: up to 125 query
//          blocks a key block, most 2 to 4; bigbird-128: one of 64, the rest
//          at most 7), yet on an H100 cutting the long lists across CTAs,
//          with a second pass adding their fp32 partials, was slower at every
//          cut timed: the short lists' per-CTA start-up, not the long list,
//          sets the time. A key block no query attends walks no tile: it
//          loads nothing and writes its zero accumulators, which live in
//          registers.
// Block 128: each warpgroup owns 64 of the block's rows and both take every
// tile (the forward's warpgroup 0 skips the diagonal block's second tile,
// which its rows cannot see). Block 64 has only 64 rows, one warpgroup's M,
// so the warpgroups split the list by parity (warpgroup w takes tiles
// j ≡ w mod 2) with an accumulator each; at the end warpgroup 1 stages its
// partial through shared memory and warpgroup 0 adds it (the forward merges
// the two online softmaxes: m = max(m₀, m₁), O = O₀·2^(m₀−m) + O₁·2^(m₁−m),
// l likewise), always in that order. Tiles are 64 rows, so inside the
// diagonal block the mask zeroes what a warpgroup's rows cannot see.
// They need TMA's 16-byte rows and strides (D % 8 == 0, q/k/v/dO bases at 16
// bytes, strides multiples of 8 elements); the wrapper pads anything else
// before the launch, and the entry points refuse it.
//
// fp32 inputs and blocks 16 and 32 keep the tiled design: a loop over the list
// inside one CTA per (query tile, h, b), or per (key tile, h, b) for dK/dV,
// walking the whole list; tiles of TL rows (the block itself at blocks 16
// and 32; 32 rows for fp32 at blocks 64 and 128, two or four tiles a block),
// tiles wholly above the diagonal skipped with their loads; common.cuh wmma
// products from padded shared memory, fp32 accumulators, 16-bit dQ/dK/dV
// accumulators in registers.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute;
// cudaErrorInvalidValue for arguments it does not take, cudaErrorNotSupported
// if the driver refuses a tensor map).

#include <cstring>

#include "attention.cuh"
#include "hopper.cuh"

struct SparseParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* out;
  void* dq;
  void* dk;
  void* dv;
  float* lse;          // [B, H, S]: written by the forward, read by the backward
  const float* delta;  // [B, H, S]
  const int* k_lists;  // [nq][max_a]
  const int* k_counts; // [nq]
  const int* q_lists;  // [nk][max_aq]
  const int* q_counts; // [nk]
  const int* dq_order;   // [nq]: the query blocks, longest k_counts first
  const int* dkdv_order; // [nk]: the key blocks, longest q_counts first
  long long q_str[3], k_str[3], v_str[3], do_str[3];  // batch, seq, head
  long long out_str[3], dq_str[3], dk_str[3], dv_str[3];
  int B, S, H, D, block, max_a, max_aq, causal, dtype;
  float scale;
};

namespace {

constexpr int MAX_D = 128;

// Scores of one tile: scale·dot, then −1e30 above the diagonal where the
// tile lies in a causal diagonal block.
struct SparseMask {
  float scale;
  bool causal;

  __device__ __forceinline__ float operator()(float dot, int qpos, int kpos) const {
    const float s = scale * dot;
    return causal && qpos < kpos ? NEG_INF : s;
  }
};

// ---------------------------------------------------------------------------
// Forward: one CTA per (query tile, h, b).
// ---------------------------------------------------------------------------

template <typename T, int DP, int TL>
struct FwdSmem {
  static constexpr int LDT = ld_t<T, DP>(), LDP = ld_t<T, TL>(), LDS = ld_f<TL>(), LDA = ld_f<DP>();
  static constexpr size_t bytes =
      (3 * TL * LDT + TL * LDP) * sizeof(T) + (TL * LDS + TL * LDA + 2 * TL) * sizeof(float);
};

template <typename T, int DP, int TL>
__global__ void __launch_bounds__(NUM_THREADS) sparse_fwd_kernel(const SparseParams p) {
  using L = FwdSmem<T, DP, TL>;
  constexpr int LDT = L::LDT, LDP = L::LDP, LDS = L::LDS, LDA = L::LDA;
  constexpr int CPL = (TL + 31) / 32;  // score columns per lane
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                   // [TL][LDT]
  T* k_s = q_s + TL * LDT;                                // [TL][LDT]
  T* v_s = k_s + TL * LDT;                                // [TL][LDT]
  T* p_s = v_s + TL * LDT;                                // [TL][LDP], P in the input type
  float* s_s = reinterpret_cast<float*>(p_s + TL * LDP);  // [TL][LDS] scores
  float* acc_s = s_s + TL * LDS;                          // [TL][LDA] output accumulator
  float* m_s = acc_s + TL * LDA;                          // [TL] running max
  float* l_s = m_s + TL;                                  // [TL] running sum

  const int q0 = blockIdx.x * TL, h = blockIdx.y, b = blockIdx.z;
  const int qi = q0 / p.block;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<T, TL, DP, LDT>(q_s, static_cast<const T*>(p.q), p.q_str, b, h, q0, p.S, p.D);
  for (int i = threadIdx.x; i < TL * LDA; i += NUM_THREADS) acc_s[i] = 0.0f;
  for (int i = threadIdx.x; i < TL; i += NUM_THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.0f;
  }
  __syncthreads();

  const int count = p.k_counts[qi];
  const int* list = p.k_lists + static_cast<long long>(qi) * p.max_a;
  for (int a = 0; a < count; ++a) {
    const int kj = list[a];
    const SparseMask mask{p.scale, p.causal != 0 && kj == qi};
    for (int k0 = kj * p.block; k0 < (kj + 1) * p.block; k0 += TL) {
      if (mask.causal && k0 > q0 + TL - 1) break;  // the rest of the diagonal block is masked
      load_tile<T, TL, DP, LDT>(k_s, static_cast<const T*>(p.k), p.k_str, b, h, k0, p.S, p.D);
      load_tile<T, TL, DP, LDT>(v_s, static_cast<const T*>(p.v), p.v_str, b, h, k0, p.S, p.D);
      __syncthreads();
      block_gemm<TL, TL, DP, false, true, LDT, LDT, LDS>(q_s, k_s, s_s, false);
      __syncthreads();

      // Online softmax, one warp per row.
      for (int r = warp; r < TL; r += NUM_WARPS) {
        float sv[CPL];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          sv[j] = c < TL ? mask(s_s[r * LDS + c], q0 + r, k0 + c) : NEG_INF;
          mx = fmaxf(mx, sv[j]);
        }
        mx = warp_max(mx);
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          if (c < TL) {
            const float pj = expf(sv[j] - m_new);
            p_s[r * LDP + c] = from_float<T>(pj);
            sum += pj;
          }
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
      block_gemm<TL, DP, TL, false, false, LDP, LDT, LDA>(p_s, v_s, acc_s, true);
      __syncthreads();
    }
  }

  // O = acc / l in the input type, lse = m + log(l), l == 0 counted as 1.
  T* out = static_cast<T*>(p.out) + b * p.out_str[0] + h * p.out_str[2];
  for (int i = threadIdx.x; i < TL * DP; i += NUM_THREADS) {
    const int r = i / DP, d = i % DP;
    if (q0 + r < p.S && d < p.D) {
      const float l = l_s[r] == 0.0f ? 1.0f : l_s[r];
      out[(q0 + r) * p.out_str[1] + d] = from_float<T>(acc_s[r * LDA + d] / l);
    }
  }
  float* lse = p.lse + (static_cast<long long>(b) * p.H + h) * p.S;
  for (int r = threadIdx.x; r < TL; r += NUM_THREADS) {
    if (q0 + r < p.S) lse[q0 + r] = m_s[r] + logf(l_s[r] == 0.0f ? 1.0f : l_s[r]);
  }
}

// Score buffers of the backward kernels: S and dP, [TL][LDS] each, and with
// 16-bit inputs also the staging area of the register accumulators on the
// way out ([TL][LDA]), so the region is the larger of the two.
template <int TL, int DP>
constexpr int score_floats() {
  return 2 * TL * ld_f<TL>() > TL * ld_f<DP>() ? 2 * TL * ld_f<TL>() : TL * ld_f<DP>();
}

// ---------------------------------------------------------------------------
// dQ: one CTA per (query tile, h, b), looping over the query block's list.
// ---------------------------------------------------------------------------

template <typename T, int DP, int TL>
struct DqSmem {
  static constexpr int LDT = ld_t<T, DP>(), LDP = ld_t<T, TL>(), LDS = ld_f<TL>(), LDA = ld_f<DP>();
  // 16-bit inputs keep dQ in registers (RegAcc); fp32 accumulates in shared memory
  static constexpr bool REG = IS_16BIT<T>;
  static constexpr int SC = score_floats<TL, DP>();
  static constexpr size_t bytes =
      (4 * TL * LDT + TL * LDP) * sizeof(T) + (SC + (REG ? 0 : TL * LDA) + 2 * TL) * sizeof(float);
};

template <typename T, int DP, int TL>
__global__ void __launch_bounds__(NUM_THREADS) sparse_bwd_dq_kernel(const SparseParams p) {
  using L = DqSmem<T, DP, TL>;
  constexpr int LDT = L::LDT, LDP = L::LDP, LDS = L::LDS, LDA = L::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                   // [TL][LDT]
  T* do_s = q_s + TL * LDT;                               // [TL][LDT]
  T* k_s = do_s + TL * LDT;                               // [TL][LDT]
  T* v_s = k_s + TL * LDT;                                // [TL][LDT]
  T* ds_s = v_s + TL * LDT;                               // [TL][LDP]
  float* s_s = reinterpret_cast<float*>(ds_s + TL * LDP); // [TL][LDS]
  float* dp_s = s_s + TL * LDS;                           // [TL][LDS]
  float* dq_s = s_s + L::SC;             // [TL][LDA] (fp32 inputs only)
  float* lse_s = dq_s + (L::REG ? 0 : TL * LDA);          // [TL]
  float* delta_s = lse_s + TL;                            // [TL]

  const int q0 = blockIdx.x * TL, h = blockIdx.y, b = blockIdx.z;
  const int qi = q0 / p.block;

  load_tile<T, TL, DP, LDT>(q_s, static_cast<const T*>(p.q), p.q_str, b, h, q0, p.S, p.D);
  load_tile<T, TL, DP, LDT>(do_s, static_cast<const T*>(p.dout), p.do_str, b, h, q0, p.S, p.D);
  load_rows<TL>(lse_s, p.lse, b, h, p.H, q0, p.S);
  load_rows<TL>(delta_s, p.delta, b, h, p.H, q0, p.S);
  RegAcc<T, TL, DP> dq_acc;
  if constexpr (L::REG) {
    dq_acc.zero();
  } else {
    for (int i = threadIdx.x; i < TL * LDA; i += NUM_THREADS) dq_s[i] = 0.0f;
  }
  __syncthreads();

  const int count = p.k_counts[qi];
  const int* list = p.k_lists + static_cast<long long>(qi) * p.max_a;
  for (int a = 0; a < count; ++a) {
    const int kj = list[a];
    const SparseMask mask{p.scale, p.causal != 0 && kj == qi};
    for (int k0 = kj * p.block; k0 < (kj + 1) * p.block; k0 += TL) {
      if (mask.causal && k0 > q0 + TL - 1) break;
      load_tile<T, TL, DP, LDT>(k_s, static_cast<const T*>(p.k), p.k_str, b, h, k0, p.S, p.D);
      load_tile<T, TL, DP, LDT>(v_s, static_cast<const T*>(p.v), p.v_str, b, h, k0, p.S, p.D);
      __syncthreads();
      block_gemm<TL, TL, DP, false, true, LDT, LDT, LDS>(q_s, k_s, s_s, false);    // Q·Kᵀ
      block_gemm<TL, TL, DP, false, true, LDT, LDT, LDS>(do_s, v_s, dp_s, false);  // dO·Vᵀ
      __syncthreads();
      probs_and_dscores<T, TL, TL, LDS, LDP>(mask, s_s, dp_s, lse_s, delta_s, static_cast<T*>(nullptr),
                                             ds_s, q0, k0, p.S);
      __syncthreads();
      if constexpr (L::REG) {
        dq_acc.template mma<TL, false, false, LDP, LDT>(ds_s, k_s);  // dQ += dS·K
      } else {
        block_gemm<TL, DP, TL, false, false, LDP, LDT, LDA>(ds_s, k_s, dq_s, true);
      }
      __syncthreads();
    }
  }

  if constexpr (L::REG) {  // stage the accumulator through the free score buffers
    dq_acc.store(s_s, LDA);
    __syncthreads();
    dq_s = s_s;
  }
  store_tile<T, TL, DP, LDA>(static_cast<T*>(p.dq), p.dq_str, dq_s, p.scale, b, h, q0, p.S, p.D);
}

// ---------------------------------------------------------------------------
// dK/dV: one CTA per (key tile, h, b), looping over the key block's
// transposed list.
// ---------------------------------------------------------------------------

template <typename T, int DP, int TL>
struct DkdvSmem {
  static constexpr int LDT = ld_t<T, DP>(), LDP = ld_t<T, TL>(), LDS = ld_f<TL>(), LDA = ld_f<DP>();
  // 16-bit inputs keep dK and dV in registers (RegAcc); fp32 accumulates in shared memory
  static constexpr bool REG = IS_16BIT<T>;
  static constexpr int SC = score_floats<TL, DP>();
  static constexpr size_t bytes =
      (4 * TL * LDT + 2 * TL * LDP) * sizeof(T) + (SC + (REG ? 0 : 2 * TL * LDA) + 2 * TL) * sizeof(float);
};

template <typename T, int DP, int TL>
__global__ void __launch_bounds__(NUM_THREADS) sparse_bwd_dkdv_kernel(const SparseParams p) {
  using L = DkdvSmem<T, DP, TL>;
  constexpr int LDT = L::LDT, LDP = L::LDP, LDS = L::LDS, LDA = L::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                   // [TL][LDT]
  T* v_s = k_s + TL * LDT;                                // [TL][LDT]
  T* q_s = v_s + TL * LDT;                                // [TL][LDT]
  T* do_s = q_s + TL * LDT;                               // [TL][LDT]
  T* p_s = do_s + TL * LDT;                               // [TL][LDP]
  T* ds_s = p_s + TL * LDP;                               // [TL][LDP]
  float* s_s = reinterpret_cast<float*>(ds_s + TL * LDP); // [TL][LDS]
  float* dp_s = s_s + TL * LDS;                           // [TL][LDS]
  float* dk_s = s_s + L::SC;             // [TL][LDA] (fp32 inputs only)
  float* dv_s = dk_s + (L::REG ? 0 : TL * LDA);           // [TL][LDA] (fp32 inputs only)
  float* lse_s = dv_s + (L::REG ? 0 : TL * LDA);          // [TL]
  float* delta_s = lse_s + TL;                            // [TL]

  const int k0 = blockIdx.x * TL, h = blockIdx.y, b = blockIdx.z;
  const int kj = k0 / p.block;

  load_tile<T, TL, DP, LDT>(k_s, static_cast<const T*>(p.k), p.k_str, b, h, k0, p.S, p.D);
  load_tile<T, TL, DP, LDT>(v_s, static_cast<const T*>(p.v), p.v_str, b, h, k0, p.S, p.D);
  RegAcc<T, TL, DP> dk_acc, dv_acc;
  if constexpr (L::REG) {
    dk_acc.zero();
    dv_acc.zero();
  } else {
    for (int i = threadIdx.x; i < TL * LDA; i += NUM_THREADS) {
      dk_s[i] = 0.0f;
      dv_s[i] = 0.0f;
    }
  }
  // before any reader: with no query block to walk, the store below is the
  // first reader of the zeroed accumulators
  __syncthreads();

  // q_counts[kj] == 0 (a key block no query attends) leaves dK = dV = 0.
  const int count = p.q_counts[kj];
  const int* list = p.q_lists + static_cast<long long>(kj) * p.max_aq;
  for (int a = 0; a < count; ++a) {
    const int qi = list[a];
    const SparseMask mask{p.scale, p.causal != 0 && qi == kj};
    for (int q0 = qi * p.block; q0 < (qi + 1) * p.block; q0 += TL) {
      if (mask.causal && q0 + TL - 1 < k0) continue;  // the query tile sees none of these keys
      load_tile<T, TL, DP, LDT>(q_s, static_cast<const T*>(p.q), p.q_str, b, h, q0, p.S, p.D);
      load_tile<T, TL, DP, LDT>(do_s, static_cast<const T*>(p.dout), p.do_str, b, h, q0, p.S, p.D);
      load_rows<TL>(lse_s, p.lse, b, h, p.H, q0, p.S);
      load_rows<TL>(delta_s, p.delta, b, h, p.H, q0, p.S);
      __syncthreads();
      block_gemm<TL, TL, DP, false, true, LDT, LDT, LDS>(q_s, k_s, s_s, false);    // Q·Kᵀ
      block_gemm<TL, TL, DP, false, true, LDT, LDT, LDS>(do_s, v_s, dp_s, false);  // dO·Vᵀ
      __syncthreads();
      probs_and_dscores<T, TL, TL, LDS, LDP>(mask, s_s, dp_s, lse_s, delta_s, p_s, ds_s, q0, k0, p.S);
      __syncthreads();
      if constexpr (L::REG) {
        dv_acc.template mma<TL, true, false, LDP, LDT>(p_s, do_s);  // dV += Pᵀ·dO
        dk_acc.template mma<TL, true, false, LDP, LDT>(ds_s, q_s);  // dK += dSᵀ·Q
      } else {
        block_gemm<TL, DP, TL, true, false, LDP, LDT, LDA>(p_s, do_s, dv_s, true);
        block_gemm<TL, DP, TL, true, false, LDP, LDT, LDA>(ds_s, q_s, dk_s, true);
      }
      __syncthreads();
    }
  }

  if constexpr (L::REG) {  // stage each accumulator through the free score buffers
    dk_acc.store(s_s, LDA);
    __syncthreads();
    store_tile<T, TL, DP, LDA>(static_cast<T*>(p.dk), p.dk_str, s_s, p.scale, b, h, k0, p.S, p.D);
    __syncthreads();
    dv_acc.store(s_s, LDA);
    __syncthreads();
    store_tile<T, TL, DP, LDA>(static_cast<T*>(p.dv), p.dv_str, s_s, 1.0f, b, h, k0, p.S, p.D);
  } else {
    store_tile<T, TL, DP, LDA>(static_cast<T*>(p.dk), p.dk_str, dk_s, p.scale, b, h, k0, p.S, p.D);
    store_tile<T, TL, DP, LDA>(static_cast<T*>(p.dv), p.dv_str, dv_s, 1.0f, b, h, k0, p.S, p.D);
  }
}

// ---------------------------------------------------------------------------
// 16-bit dQ and dK/dV at blocks 64 and 128: one TMA producer warp and two
// consumer warpgroups (wgmma), a four-stage ring of 64-row tiles between them.
// ---------------------------------------------------------------------------

constexpr int HOP_CONSUMER_WARPS = 8;
constexpr int HOP_THREADS = HOP_CONSUMER_WARPS * 32 + 32;
constexpr int HOP_STAGES = 4;
constexpr int TILE = 64;  // rows of a streamed tile, and of one warpgroup's accumulators
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct SparseMaps {
  CUtensorMap q, k, v, dout;
};

// The two consumer warpgroups (256 threads) at named barrier 1: the producer
// warp has returned by the time they meet.
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// Block 64's merge: both warpgroups hold the same (row, column) in the same
// register of the same thread index, so warpgroup 1 stages its registers
// [i][t] and warpgroup 0 adds its twin's values, always in that order.
template <int N>
__device__ __forceinline__ void stage_out(const float (&acc)[N], float* stage, int t) {
#pragma unroll
  for (int i = 0; i < N; ++i) stage[i * 128 + t] = acc[i];
}
template <int N>
__device__ __forceinline__ void add_staged(float (&acc)[N], const float* stage, int t) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += stage[i * 128 + t];
}

// Shared memory of the forward: [Q: BLK x DP][K: STAGES x 64 x DP][V: the
// same], 1024-byte aligned tiles, then the barriers.
template <typename T, int DP, int BLK>
struct HopFwd {
  static constexpr int Q_ELEMS = BLK * DP, KV_ELEMS = TILE * DP;
  static constexpr size_t bytes =
      1024 + (Q_ELEMS + 2 * HOP_STAGES * KV_ELEMS) * sizeof(T) + (1 + 2 * HOP_STAGES) * sizeof(uint64_t);
};

// The forward of one query block: Q loaded once, the K/V tiles of its list
// through the ring. S = Q·Kᵀ with both operands K-major; the online softmax
// in base 2 with each row's max and sum in registers (a row's four threads
// are a quad); O += P·V with V MN-major and P as the register A.
template <typename T, int DP, int BLK>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    sparse_fwd_hopper(const SparseParams p, const __grid_constant__ SparseMaps maps) {
  using L = HopFwd<T, DP, BLK>;
  constexpr int ST = HOP_STAGES, TPB = BLK / TILE;  // key tiles per block
  constexpr bool PARITY = BLK == TILE;              // the warpgroups split the tiles, not the rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + L::Q_ELEMS;  // stage s at k_s + s * KV_ELEMS
  T* v_s = k_s + ST * L::KV_ELEMS;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(v_s + ST * L::KV_ELEMS);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + ST;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int qi = p.dq_order[blockIdx.y];  // the longest lists first
  const int q0 = qi * BLK;
  const int* list = p.k_lists + static_cast<long long>(qi) * p.max_a;
  const int n_tiles = p.k_counts[qi] * TPB;  // 0 for an empty list: O = 0, lse = NEG_INF

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PARITY ? HOP_CONSUMER_WARPS / 2 : HOP_CONSUMER_WARPS);  // the warps that read it
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == HOP_CONSUMER_WARPS) {  // producer: Q once, then the list's K/V tiles
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_bar, L::Q_ELEMS * sizeof(T));
      tma_load_rows<BLK, DP>(q_s, &maps.q, q_bar, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST, k0 = list[j / TPB] * BLK + (j % TPB) * TILE;
        if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::KV_ELEMS * sizeof(T));
        tma_load_rows<TILE, DP>(k_s + s * L::KV_ELEMS, &maps.k, &full[s], k0, h, b);
        tma_load_rows<TILE, DP>(v_s + s * L::KV_ELEMS, &maps.v, &full[s], k0, h, b);
      }
    }
    return;
  }

  // Consumers: this thread holds query rows row0 and row0 + 8 (of warpgroup
  // wg's 64 at block 128, of the block's 64 at block 64).
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int wrow = PARITY ? 0 : 64 * wg;
  const int row0 = q0 + wrow + acc_row(0, t);
  const T* q_w = q_s + wrow * 64;  // this warpgroup's rows in each column atom
  const float scale2 = p.scale * LOG2E;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  if (n_tiles > 0) mbar_wait(q_bar, 0);
  for (int j = PARITY ? wg : 0; j < n_tiles; j += PARITY ? 2 : 1) {
    const int s = j % ST, kj = list[j / TPB], k0 = kj * BLK + (j % TPB) * TILE;
    const T* k_t = k_s + s * L::KV_ELEMS;
    const T* v_t = v_s + s * L::KV_ELEMS;
    const bool diag = p.causal && kj == qi;
    mbar_wait(&full[s], (j / ST) & 1);
    // At block 128 the diagonal block's second tile lies wholly above
    // warpgroup 0's rows: every score masked, nothing to add.
    if (!(diag && k0 > q0 + wrow + TILE - 1)) {
      float sc[TILE / 2];
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) sc[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {  // S = Q·Kᵀ, both K-major
        const int off = (kk % 4) * 16;        // column atom kk / 4, 32 bytes per step inside it
        wgmma_ss<T, TILE, 0>(sc, desc_b128(q_w + (kk / 4) * BLK * 64 + off, 16),
                             desc_b128(k_t + (kk / 4) * TILE * 64 + off, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Only the causal diagonal block holds masked pairs. Elsewhere the
      // raw products are kept: the scaled row max is the raw one times the
      // (positive) scale, and one FMA inside exp2 scales and shifts each.
      const bool raw = !diag && scale2 > 0.0f;
      if (!raw) {
#pragma unroll
        for (int i = 0; i < TILE / 2; ++i) {
          const int qpos = row0 + 8 * ((i >> 1) & 1), kpos = k0 + acc_col(i, t);
          sc[i] = diag && qpos < kpos ? NEG_INF : sc[i] * scale2;
        }
      }
      const float mul = raw ? scale2 : 1.0f;
      float mx[2] = {NEG_INF, NEG_INF}, alpha[2];
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
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
      for (int i = 0; i < TILE / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2f(fmaf(sc[i], mul, -m[r]));
        l[r] += sc[i];  // this thread's part of the row sum; the quad adds up at the end
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      uint32_t pa[TILE / 16][4];  // P in the input type, as the A operand of P·V
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) acc_to_a<T>(sc, kk, pa[kk]);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk)  // O += P·V, V MN-major: 16 keys = 16 rows per step
        wgmma_rs<T, DP, 1>(o, pa[kk], desc_b128(v_t + kk * 16 * 64, TILE * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if constexpr (PARITY) {  // warpgroup 0 merges warpgroup 1's (m, l, O) into its own
    float* stage = reinterpret_cast<float*>(k_s);  // the ring: every tile loaded into it has been consumed
    float* stage_ml = stage + (DP / 2) * 128;      // [m0, m1, l0, l1][t]
    consumers_sync();
    if (wg == 1) {
      stage_out(o, stage, t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        stage_ml[r * 128 + t] = m[r];
        stage_ml[(2 + r) * 128 + t] = l[r];
      }
    }
    consumers_sync();
    if (wg == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = stage_ml[r * 128 + t], l1 = stage_ml[(2 + r) * 128 + t];
      const float m_new = fmaxf(m[r], m1);
      a0[r] = exp2f(m[r] - m_new);
      a1[r] = exp2f(m1 - m_new);
      l[r] = l[r] * a0[r] + l1 * a1[r];
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      const int r = (i >> 1) & 1;
      o[i] = o[i] * a0[r] + stage[i * 128 + t] * a1[r];
    }
  }

  // Epilogue: O / l in the input type, lse = m·ln 2 + log(l), l = 0 taken
  // as 1; an empty list writes O = 0 and lse = NEG_INF (the Pallas kernel's
  // m + log(l_safe) with m never raised).
  float inv[2], lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float ls = l[r] == 0.0f ? 1.0f : l[r];
    inv[r] = 1.0f / ls;
    lse[r] = n_tiles == 0 ? NEG_INF : m[r] * LN2 + logf(ls);
  }
  T* out = static_cast<T*>(p.out) + b * p.out_str[0] + h * p.out_str[2];
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int r = (i >> 1) & 1, row = row0 + 8 * r, col = acc_col(i, t);
    if (col < p.D) {
      *reinterpret_cast<uint32_t*>(out + row * p.out_str[1] + col) = pack2<T>(o[i] * inv[r], o[i + 1] * inv[r]);
    }
  }
  if (t % 4 == 0) {
    float* lse_g = p.lse + (static_cast<long long>(b) * p.H + h) * p.S;
#pragma unroll
    for (int r = 0; r < 2; ++r) lse_g[row0 + 8 * r] = lse[r];
  }
}

// Shared memory of dQ: [Q: BLK x DP][dO: the same][K: STAGES x 64 x DP][V:
// the same], 1024-byte aligned tiles, then the barriers.
template <typename T, int DP, int BLK>
struct HopDq {
  static constexpr int Q_ELEMS = BLK * DP, KV_ELEMS = TILE * DP;
  static constexpr size_t bytes =
      1024 + (2 * Q_ELEMS + 2 * HOP_STAGES * KV_ELEMS) * sizeof(T) + (1 + 2 * HOP_STAGES) * sizeof(uint64_t);
};

// dQ of one query block: Q and dO loaded once, the K/V tiles of its list
// through the ring. S = Q·Kᵀ and dP = dO·Vᵀ with both operands K-major,
// dQ += dS·K with K MN-major and dS as the register A.
template <typename T, int DP, int BLK>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    sparse_bwd_dq_hopper(const SparseParams p, const __grid_constant__ SparseMaps maps) {
  using L = HopDq<T, DP, BLK>;
  constexpr int ST = HOP_STAGES, TPB = BLK / TILE;  // key tiles per block
  constexpr bool PARITY = BLK == TILE;              // the warpgroups split the tiles, not the rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + L::Q_ELEMS;
  T* k_s = do_s + L::Q_ELEMS;  // stage s at k_s + s * KV_ELEMS
  T* v_s = k_s + ST * L::KV_ELEMS;
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(v_s + ST * L::KV_ELEMS);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + ST;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int qi = p.dq_order[blockIdx.y];  // the longest lists first
  const int q0 = qi * BLK;
  const int* list = p.k_lists + static_cast<long long>(qi) * p.max_a;
  const int n_tiles = p.k_counts[qi] * TPB;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PARITY ? HOP_CONSUMER_WARPS / 2 : HOP_CONSUMER_WARPS);  // the warps that read it
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == HOP_CONSUMER_WARPS) {  // producer: Q and dO once, then the list's K/V tiles
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, 2 * L::Q_ELEMS * sizeof(T));
      tma_load_rows<BLK, DP>(q_s, &maps.q, q_bar, q0, h, b);
      tma_load_rows<BLK, DP>(do_s, &maps.dout, q_bar, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST, k0 = list[j / TPB] * BLK + (j % TPB) * TILE;
        if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::KV_ELEMS * sizeof(T));
        tma_load_rows<TILE, DP>(k_s + s * L::KV_ELEMS, &maps.k, &full[s], k0, h, b);
        tma_load_rows<TILE, DP>(v_s + s * L::KV_ELEMS, &maps.v, &full[s], k0, h, b);
      }
    }
    return;
  }

  // Consumers: this thread holds query rows row0 and row0 + 8 (of warpgroup
  // wg's 64 at block 128, of the block's 64 at block 64) for the whole CTA,
  // so their lse (base 2, as the scores) and Δ live in registers.
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int wrow = PARITY ? 0 : 64 * wg;
  const int row0 = q0 + wrow + acc_row(0, t);
  const T* q_w = q_s + wrow * 64;  // this warpgroup's rows in each column atom
  const T* do_w = do_s + wrow * 64;
  const float scale2 = p.scale * LOG2E;
  const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = p.lse[row_base + row0 + 8 * r] * LOG2E;
    dlt[r] = p.delta[row_base + row0 + 8 * r];
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;

  mbar_wait(q_bar, 0);
  for (int j = PARITY ? wg : 0; j < n_tiles; j += PARITY ? 2 : 1) {
    const int s = j % ST, kj = list[j / TPB], k0 = kj * BLK + (j % TPB) * TILE;
    const T* k_t = k_s + s * L::KV_ELEMS;
    const T* v_t = v_s + s * L::KV_ELEMS;
    mbar_wait(&full[s], (j / ST) & 1);

    float sc[TILE / 2], dp[TILE / 2];  // S = Q·Kᵀ and dP = dO·Vᵀ
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      sc[i] = 0.0f;
      dp[i] = 0.0f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk % 4) * 16;  // column atom kk / 4, 32 bytes per step inside it
      wgmma_ss<T, TILE, 0>(sc, desc_b128(q_w + (kk / 4) * BLK * 64 + off, 16),
                           desc_b128(k_t + (kk / 4) * TILE * 64 + off, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk % 4) * 16;
      wgmma_ss<T, TILE, 0>(dp, desc_b128(do_w + (kk / 4) * BLK * 64 + off, 16),
                           desc_b128(v_t + (kk / 4) * TILE * 64 + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P = exp2(S·scale·log2 e − lse₂), then dS = P∘(dP − Δ) rounded to T.
    // Only the causal diagonal block holds masked pairs; elsewhere one FMA
    // scales and shifts each raw product.
    if (p.causal && kj == qi) {
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) {
        const int r = (i >> 1) & 1, qpos = row0 + 8 * r, kpos = k0 + acc_col(i, t);
        sc[i] = exp2f((qpos < kpos ? NEG_INF : sc[i] * scale2) - lse2[r]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) sc[i] = exp2f(fmaf(sc[i], scale2, -lse2[(i >> 1) & 1]));
    }
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) dp[i] = sc[i] * (dp[i] - dlt[(i >> 1) & 1]);
    uint32_t da[TILE / 16][4];  // dS in the input type, as the A operand of dS·K
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) acc_to_a<T>(dp, kk, da[kk]);
    fence_regs(dq);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)  // dQ += dS·K, K MN-major: 16 keys = 16 rows per step
      wgmma_rs<T, DP, 1>(dq, da[kk], desc_b128(k_t + kk * 16 * 64, TILE * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if constexpr (PARITY) {
    float* stage = reinterpret_cast<float*>(k_s);  // the ring: every tile loaded into it has been consumed
    consumers_sync();
    if (wg == 1) stage_out(dq, stage, t);
    consumers_sync();
    if (wg == 1) return;
    add_staged(dq, stage, t);
  }

  // Epilogue: dQ · scale in the input type.
  T* dq_g = static_cast<T*>(p.dq) + b * p.dq_str[0] + h * p.dq_str[2];
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int row = row0 + 8 * ((i >> 1) & 1), col = acc_col(i, t);
    if (col < p.D) {
      *reinterpret_cast<uint32_t*>(dq_g + row * p.dq_str[1] + col) = pack2<T>(dq[i] * p.scale, dq[i + 1] * p.scale);
    }
  }
}

// Shared memory of dK/dV: [K: BLK x DP][V: the same][Q: STAGES x 64 x DP]
// [dO: the same][lse·log2 e: STAGES x 64][Δ: the same], then the barriers.
template <typename T, int DP, int BLK>
struct HopDkdv {
  static constexpr int KV_ELEMS = BLK * DP, Q_ELEMS = TILE * DP;
  static constexpr size_t bytes = 1024 + (2 * KV_ELEMS + 2 * HOP_STAGES * Q_ELEMS) * sizeof(T) +
                                  2 * HOP_STAGES * TILE * sizeof(float) + (1 + 2 * HOP_STAGES) * sizeof(uint64_t);
};

// dK/dV of one key block: K and V loaded once, the Q/dO tiles of its list (with lse and Δ) through the ring. Sᵀ = K·Qᵀ and
// dPᵀ = V·dOᵀ put the keys in rows, so Pᵀ and dSᵀ land in registers as the A
// of dV += Pᵀ·dO and dK += dSᵀ·Q, with dO and Q read MN-major.
template <typename T, int DP, int BLK>
__global__ void __launch_bounds__(HOP_THREADS, 1)
    sparse_bwd_dkdv_hopper(const SparseParams p, const __grid_constant__ SparseMaps maps) {
  using L = HopDkdv<T, DP, BLK>;
  constexpr int ST = HOP_STAGES, TPB = BLK / TILE;  // query tiles per block
  constexpr bool PARITY = BLK == TILE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + L::KV_ELEMS;
  T* q_s = v_s + L::KV_ELEMS;  // stage s at q_s + s * Q_ELEMS
  T* do_s = q_s + ST * L::Q_ELEMS;
  float* lse_s = reinterpret_cast<float*>(do_s + ST * L::Q_ELEMS);  // stage s at lse_s + s * TILE
  float* delta_s = lse_s + ST * TILE;
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(delta_s + ST * TILE);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + ST;

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kj = p.dkdv_order[blockIdx.y];  // the longest lists first
  const int k0 = kj * BLK;
  const int* list = p.q_lists + static_cast<long long>(kj) * p.max_aq;
  const int n_tiles = p.q_counts[kj] * TPB;  // 0 for a key block no query attends

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes: lse/Δ stores, and lane 0's TMA bytes
      mbar_init(&empty[s], PARITY ? HOP_CONSUMER_WARPS / 2 : HOP_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == HOP_CONSUMER_WARPS) {  // producer
    if (lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(kv_bar, 2 * L::KV_ELEMS * sizeof(T));
      tma_load_rows<BLK, DP>(k_s, &maps.k, kv_bar, k0, h, b);
      tma_load_rows<BLK, DP>(v_s, &maps.v, kv_bar, k0, h, b);
    }
    const long long row_base = (static_cast<long long>(b) * p.H + h) * p.S;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST, q0 = list[j / TPB] * BLK + (j % TPB) * TILE;
      if (j >= ST) mbar_wait(&empty[s], ((j / ST) - 1) & 1);
      for (int r = lane; r < TILE; r += 32) {
        lse_s[s * TILE + r] = p.lse[row_base + q0 + r] * LOG2E;  // base 2, as the scores
        delta_s[s * TILE + r] = p.delta[row_base + q0 + r];
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * L::Q_ELEMS * sizeof(T));
        tma_load_rows<TILE, DP>(q_s + s * L::Q_ELEMS, &maps.q, &full[s], q0, h, b);
        tma_load_rows<TILE, DP>(do_s + s * L::Q_ELEMS, &maps.dout, &full[s], q0, h, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers: this thread holds key rows key0 and key0 + 8 (of warpgroup
  // wg's 64 at block 128, of the block's 64 at block 64), query columns
  // acc_col(i, t).
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int wrow = PARITY ? 0 : 64 * wg;
  const int key0 = k0 + wrow + acc_row(0, t);
  const T* k_w = k_s + wrow * 64;
  const T* v_w = v_s + wrow * 64;
  const float scale2 = p.scale * LOG2E;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }

  if (n_tiles > 0) mbar_wait(kv_bar, 0);
  for (int j = PARITY ? wg : 0; j < n_tiles; j += PARITY ? 2 : 1) {
    const int s = j % ST, qi = list[j / TPB], q0 = qi * BLK + (j % TPB) * TILE;
    const T* q_t = q_s + s * L::Q_ELEMS;
    const T* do_t = do_s + s * L::Q_ELEMS;
    const float* lse_t = lse_s + s * TILE;
    const float* delta_t = delta_s + s * TILE;
    mbar_wait(&full[s], (j / ST) & 1);

    float st[TILE / 2], dpt[TILE / 2];  // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, keys as rows
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      st[i] = 0.0f;
      dpt[i] = 0.0f;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk % 4) * 16;
      wgmma_ss<T, TILE, 0>(st, desc_b128(k_w + (kk / 4) * BLK * 64 + off, 16),
                           desc_b128(q_t + (kk / 4) * TILE * 64 + off, 16), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int off = (kk % 4) * 16;
      wgmma_ss<T, TILE, 0>(dpt, desc_b128(v_w + (kk / 4) * BLK * 64 + off, 16),
                           desc_b128(do_t + (kk / 4) * TILE * 64 + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // Pᵀ = exp(Sᵀ − lse) and dSᵀ = Pᵀ∘(dPᵀ − Δ), lse (base 2) and Δ per
    // column; the causal diagonal block masks q < k, elsewhere one FMA.
    if (p.causal && qi == kj) {
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) {
        const int c = acc_col(i, t), key = key0 + 8 * ((i >> 1) & 1);
        st[i] = exp2f((q0 + c < key ? NEG_INF : st[i] * scale2) - lse_t[c]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < TILE / 2; ++i) st[i] = exp2f(fmaf(st[i], scale2, -lse_t[acc_col(i, t)]));
    }
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) dpt[i] = st[i] * (dpt[i] - delta_t[acc_col(i, t)]);
    uint32_t pa[TILE / 16][4], da[TILE / 16][4];  // Pᵀ and dSᵀ in the input type
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk) {
      acc_to_a<T>(st, kk, pa[kk]);
      acc_to_a<T>(dpt, kk, da[kk]);
    }
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)  // dV += Pᵀ·dO, dO MN-major
      wgmma_rs<T, DP, 1>(dv, pa[kk], desc_b128(do_t + kk * 16 * 64, TILE * 128), 1);
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)  // dK += dSᵀ·Q, Q MN-major
      wgmma_rs<T, DP, 1>(dk, da[kk], desc_b128(q_t + kk * 16 * 64, TILE * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  if constexpr (PARITY) {
    float* stage = reinterpret_cast<float*>(q_s);  // the Q/dO ring: every tile loaded into it has been consumed
    consumers_sync();
    if (wg == 1) {
      stage_out(dk, stage, t);
      stage_out(dv, stage + (DP / 2) * 128, t);
    }
    consumers_sync();
    if (wg == 1) return;
    add_staged(dk, stage, t);
    add_staged(dv, stage + (DP / 2) * 128, t);
  }

  // dK · scale and dV in the input type
  T* dk_g = static_cast<T*>(p.dk) + b * p.dk_str[0] + h * p.dk_str[2];
  T* dv_g = static_cast<T*>(p.dv) + b * p.dv_str[0] + h * p.dv_str[2];
#pragma unroll
  for (int i = 0; i < DP / 2; i += 2) {
    const int key = key0 + 8 * ((i >> 1) & 1), col = acc_col(i, t);
    if (col < p.D) {
      *reinterpret_cast<uint32_t*>(dk_g + key * p.dk_str[1] + col) = pack2<T>(dk[i] * p.scale, dk[i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dv_g + key * p.dv_str[1] + col) = pack2<T>(dv[i], dv[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

enum Which { FWD, DQ, DKDV };

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// PR 4's kernels: one CTA per tile of TL rows.
template <typename T, int DP, int TL, Which W>
int launch_tiled(const SparseParams& p, cudaStream_t stream) {
  void (*kernel)(const SparseParams);
  size_t smem;
  if constexpr (W == FWD) {
    kernel = sparse_fwd_kernel<T, DP, TL>;
    smem = FwdSmem<T, DP, TL>::bytes;
  } else if constexpr (W == DQ) {
    kernel = sparse_bwd_dq_kernel<T, DP, TL>;
    smem = DqSmem<T, DP, TL>::bytes;
  } else {
    kernel = sparse_bwd_dkdv_kernel<T, DP, TL>;
    smem = DkdvSmem<T, DP, TL>::bytes;
  }
  const int e = set_smem(kernel, smem);
  if (e != 0) return e;
  kernel<<<dim3(p.S / TL, p.H, p.B), NUM_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The Hopper kernels. Their inputs need TMA's 16-byte rows and strides,
// their outputs 4-byte pairs; the wrapper pads anything else.
template <typename T, int DP, int BLK, Which W>
int launch_hopper(const SparseParams& p, cudaStream_t stream) {
  const bool reads_do = W != FWD;
  if (p.D % 8 != 0 || !aligned16(p.q, p.q_str) || !aligned16(p.k, p.k_str) || !aligned16(p.v, p.v_str) ||
      (reads_do && !aligned16(p.dout, p.do_str))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool is_bf16 = std::is_same<T, bf16>::value;
  constexpr int Q_ROWS = W == DKDV ? TILE : BLK, K_ROWS = W == DKDV ? BLK : TILE;  // the boxes each kernel loads
  SparseMaps maps;
  memset(&maps, 0, sizeof(maps));
  if (!tile_map(&maps.q, p.q, is_bf16, p.q_str, p.B, p.S, p.H, p.D, Q_ROWS) ||
      (reads_do && !tile_map(&maps.dout, p.dout, is_bf16, p.do_str, p.B, p.S, p.H, p.D, Q_ROWS)) ||
      !tile_map(&maps.k, p.k, is_bf16, p.k_str, p.B, p.S, p.H, p.D, K_ROWS) ||
      !tile_map(&maps.v, p.v, is_bf16, p.v_str, p.B, p.S, p.H, p.D, K_ROWS)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  const dim3 grid(p.B * p.H, p.S / BLK);
  if constexpr (W == FWD) {
    using L = HopFwd<T, DP, BLK>;
    if (!even(p.out, p.out_str) || p.dq_order == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int e = set_smem(sparse_fwd_hopper<T, DP, BLK>, L::bytes);
    if (e != 0) return e;
    sparse_fwd_hopper<T, DP, BLK><<<grid, HOP_THREADS, L::bytes, stream>>>(p, maps);
  } else if constexpr (W == DQ) {
    using L = HopDq<T, DP, BLK>;
    if (!even(p.dq, p.dq_str) || p.dq_order == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int e = set_smem(sparse_bwd_dq_hopper<T, DP, BLK>, L::bytes);
    if (e != 0) return e;
    sparse_bwd_dq_hopper<T, DP, BLK><<<grid, HOP_THREADS, L::bytes, stream>>>(p, maps);
  } else {
    using L = HopDkdv<T, DP, BLK>;
    if (!even(p.dk, p.dk_str) || !even(p.dv, p.dv_str) || p.dkdv_order == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int e = set_smem(sparse_bwd_dkdv_hopper<T, DP, BLK>, L::bytes);
    if (e != 0) return e;
    sparse_bwd_dkdv_hopper<T, DP, BLK><<<grid, HOP_THREADS, L::bytes, stream>>>(p, maps);
  }
  return static_cast<int>(cudaGetLastError());
}

// The route, from the type and the block alone: the 16-bit forward, dQ and
// dK/dV at blocks 64 and 128 take the Hopper kernels; everything else the
// tiled kernels, with the block itself as the tile for 16-bit inputs (16 or 32
// rows) and tiles of 16 or 32 rows for fp32.
template <typename T, int DP, Which W>
int dispatch_block(const SparseParams& p, cudaStream_t stream) {
  if (p.block == 16) return launch_tiled<T, DP, 16, W>(p, stream);
  if constexpr (!IS_16BIT<T>) {
    return launch_tiled<T, DP, 32, W>(p, stream);
  } else {
    if (p.block == 32) return launch_tiled<T, DP, 32, W>(p, stream);
    return p.block == 64 ? launch_hopper<T, DP, 64, W>(p, stream) : launch_hopper<T, DP, 128, W>(p, stream);
  }
}

template <typename T, Which W>
int dispatch_d(const SparseParams& p, cudaStream_t stream) {
  return p.D <= 64 ? dispatch_block<T, 64, W>(p, stream) : dispatch_block<T, 128, W>(p, stream);
}

template <Which W>
int dispatch(const SparseParams* p, void* stream) {
  if (p == nullptr || p->D < 1 || p->D > MAX_D || p->B < 1 || p->B > 65535 || p->H < 1 || p->H > 65535 ||
      static_cast<long long>(p->B) * p->H > 2147483647LL ||
      !(p->block == 16 || p->block == 32 || p->block == 64 || p->block == 128) || p->S < p->block ||
      p->S % p->block != 0 || p->max_a < 1 || p->max_aq < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return dispatch_d<float, W>(*p, s);
  if (p->dtype == 1) return dispatch_d<bf16, W>(*p, s);
  if (p->dtype == 2) return dispatch_d<half, W>(*p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The caller has checked shapes, dtypes,
// devices, a contiguous last dimension, 1 <= D <= 128, block in {16, 32, 64, 128},
// S a multiple of block, the lists and tables (int32, on the device, built from one
// layout), and for the Hopper route the alignment above.
extern "C" int dstt_sparse_fwd(const SparseParams* p, void* stream) { return dispatch<FWD>(p, stream); }
extern "C" int dstt_sparse_bwd_dq(const SparseParams* p, void* stream) { return dispatch<DQ>(p, stream); }
extern "C" int dstt_sparse_bwd_dkdv(const SparseParams* p, void* stream) { return dispatch<DKDV>(p, stream); }
