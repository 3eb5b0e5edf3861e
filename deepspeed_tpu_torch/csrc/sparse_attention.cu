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
// Grid. The Pallas grid is (B·H, nq, max_a) with pl.when skipping padded
// list entries; here the list walk is a loop inside one CTA:
//   forward and dQ: one CTA per (query tile, h, b), looping over
//                   k_lists[qi][0 .. k_counts[qi]), so padding costs nothing;
//   dK/dV:          one CTA per (key tile, h, b), looping over
//                   q_lists[kj][0 .. q_counts[kj]).
// A tile is TL rows: the block itself up to 64 rows (32 for fp32 inputs); a
// block of 128 is walked as two tiles of 64. Inside the diagonal block, tiles
// wholly above the diagonal are skipped with their loads. No atomics, so
// every result is deterministic and resume stays bitwise.
//
// Input types: fp32, bf16 and fp16. 16-bit rounding follows the Pallas
// kernels: P is cast to the input type before P·V and before Pᵀ·dO, dS before
// dS·K and dSᵀ·Q; every product accumulates in fp32 and O, dQ, dK, dV are
// written in the input type from fp32 accumulators.
//
// What bounds it on this card. Each active block pair is a 64x64 (or
// 128x128) flash tile: at the slice's shape (S = 8192, block 64, D = 64,
// bf16, 2,304 active pairs per (b, h) out of 8,256 causal ones) the forward
// reads q/k/v about (1 + 18 avg list length) tiles per query tile and does
// 4·64²·64 flops per pair, so it is bound by the tensor cores like the dense
// flash kernels; the design is theirs (common.cuh wmma products from shared
// memory, fp32 accumulators, dQ/dK/dV accumulators in registers). dK/dV is
// load-imbalanced: the global key blocks of the fixed layout are attended
// by up to 125 query blocks, the others by about 2 to 4, and one CTA walks a
// whole list. Left to later work: splitting a long key list across CTAs
// with a deterministic second-pass sum, wgmma and TMA.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute).

#include "attention.cuh"

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
// Launch
// ---------------------------------------------------------------------------

enum Which { FWD, DQ, DKDV };

template <typename T, int DP, int TL>
int launch(const SparseParams& p, Which which, cudaStream_t stream) {
  void (*kernel)(const SparseParams);
  size_t smem;
  if (which == FWD) {
    kernel = sparse_fwd_kernel<T, DP, TL>;
    smem = FwdSmem<T, DP, TL>::bytes;
  } else if (which == DQ) {
    kernel = sparse_bwd_dq_kernel<T, DP, TL>;
    smem = DqSmem<T, DP, TL>::bytes;
  } else {
    kernel = sparse_bwd_dkdv_kernel<T, DP, TL>;
    smem = DkdvSmem<T, DP, TL>::bytes;
  }
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(p.S / TL, p.H, p.B), NUM_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The tile: the block itself up to 64 rows for 16-bit inputs (32 for fp32,
// whose scalar products and shared-memory accumulators need the room).
template <typename T, int DP>
int dispatch_tile(const SparseParams& p, Which which, cudaStream_t stream) {
  if (p.block == 16) return launch<T, DP, 16>(p, which, stream);
  if constexpr (IS_16BIT<T>) {
    if (p.block == 32) return launch<T, DP, 32>(p, which, stream);
    return launch<T, DP, 64>(p, which, stream);
  } else {
    return launch<T, DP, 32>(p, which, stream);
  }
}

template <typename T>
int dispatch_d(const SparseParams& p, Which which, cudaStream_t stream) {
  if (p.D <= 64) return dispatch_tile<T, 64>(p, which, stream);
  return dispatch_tile<T, 128>(p, which, stream);
}

int dispatch(const SparseParams* p, Which which, void* stream) {
  if (p == nullptr || p->D < 1 || p->D > MAX_D || p->B < 1 || p->B > 65535 || p->H < 1 ||
      p->H > 65535 || !(p->block == 16 || p->block == 32 || p->block == 64 || p->block == 128) ||
      p->S < p->block || p->S % p->block != 0 || p->max_a < 1 || p->max_aq < 1) {
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
// devices, a contiguous last dimension, 1 <= D <= 128, block in {16, 32, 64, 128},
// S a multiple of block, and the lists (int32, on the device, built from one layout).
extern "C" int dstt_sparse_fwd(const SparseParams* p, void* stream) { return dispatch(p, FWD, stream); }
extern "C" int dstt_sparse_bwd_dq(const SparseParams* p, void* stream) { return dispatch(p, DQ, stream); }
extern "C" int dstt_sparse_bwd_dkdv(const SparseParams* p, void* stream) { return dispatch(p, DKDV, stream); }
