// Fused vocab projection + cross-entropy on Hopper (sm_90a): forward, dH, dW.
//
// Replaces the three Pallas kernels of deepspeed_tpu/ops/pallas/fused_xent.py:
//   dstt_xent_fwd     <- _fwd_kernel    (:73,  pallas_call :123)
//   dstt_xent_bwd_dh  <- _bwd_dh_kernel (:171, pallas_call :235)
//   dstt_xent_bwd_dw  <- _bwd_dw_kernel (:193, pallas_call :250)
//
// What they compute, for hidden H [N, D], head W [D, V] and labels y [N]
// (y < 0 is an ignored row), with logits L = H·W in fp32 and columns past V
// masked:
//   forward: lse[n] = logsumexp_v L[n, v], nll[n] = lse[n] − L[n, y[n]]
//            (the gold logit is 0 when no column matches y[n]);
//   dH:      dH = ds·Wᵀ, ds = (exp(L − lse) − onehot(y))·g[n] rounded to W's type;
//   dW:      dW = Hᵀ·ds, ds rounded to H's type;
// with g [N] the cotangent of nll. The logits never reach device memory: each
// kernel recomputes the [rows, vocab] tile it needs in shared memory.
//
// Layout. H, dH: [N, D] with row/column strides; W, dW: [D, V] with d/v
// strides, so the tied head wteᵀ (a [V, D] row-major buffer, d stride 1) is
// read where it lies, and dW is written in the layout of the head it is the
// gradient of (for the tied head, the layout wte's gradient needs). Inputs
// and outputs share one type: fp32, bf16 or fp16.
//
// Grid. The Pallas kernels accumulate over a sequential grid axis in VMEM;
// here that axis is a loop inside one CTA, and nothing is shared between CTAs
// (no atomics: every result is deterministic run to run):
//   forward: one CTA per 64-row tile, looping over 128-column vocab tiles,
//            with a running row max, row sum and gold logit in shared memory;
//            the contraction over D goes in 64-wide chunks of H and W staged
//            in shared memory, the logits tile in tensor-core fragments;
//   dH:      one CTA per 32-row tile (its H rows resident in shared memory),
//            looping over 64-column vocab tiles: each loads its [64, D] slice
//            of W once, recomputes the logits tile, forms ds, and adds
//            ds·W_tile to the dH accumulator;
//   dW:      one CTA per 32-column vocab tile (its W slice resident), looping
//            over 64-row tiles: each loads its H rows once, recomputes the
//            logits tile, forms ds, and adds H_tileᵀ·ds to the dW accumulator.
// The ragged edges (N, D and V not multiples of the tiles) are
// bounds-checked: rows past N load as zeros and carry g = 0, columns past V
// are masked, D is zero-padded to a multiple of 64. fp32 inputs take the same
// loops with 16-row tiles and scalar FMAs.
//
// Accumulators. The backward kernels keep dH [32, D] and dW [D, 32] in
// registers for the whole loop: tensor-core fragments, each warp owning
// 16-wide slices of D, 12 fragments (96 fp32 values a thread) at D = 768 and
// 16 at D = 1024, the most the wrapper allows (MAX_D). That is why dH takes 32
// rows and dW 32 columns: at 64 the accumulator would be 192 values a thread
// at D = 768, beyond what 255 registers hold with the rest. Shared memory
// then holds the resident operand and one streamed tile: 159 KB (dH) and
// 160 KB (dW) at D = 768, 207 KB and 208 KB at D = 1024.
//
// What bounds it on this card. At the training shape (N = 16384, D = 768,
// V = 50304, bf16) the forward does 2·N·D·V = 1.27 TFLOP, each backward
// 2.53 TFLOP (the logits again, then the product), on about 80 MB of H and
// W: all three are bound by tensor-core operations (1.28 ms and 2.56 ms at
// 989 TFLOP/s). The design is simple first: wmma (mma.sync) from shared
// memory, one CTA of 8 warps per SM in the backward, no overlap of the
// streamed tile's load with the products, and W (forward, dH) or H (dW)
// re-read from L2 once per CTA. Left to later work: wgmma with TMA-fed
// multi-stage buffers, and larger tiles so the streamed operand is re-read
// less.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute).

#include "common.cuh"

struct XentParams {
  const void* h;        // hidden [N, D]
  const void* w;        // head [D, V]
  const int* y;         // labels [N] int32; < 0 = ignored row
  const float* lse_in;  // [N] (backward)
  const float* g;       // [N] cotangent of nll (backward)
  float* lse;           // [N] (forward)
  float* nll;           // [N] (forward)
  void* dh;             // [N, D] (dH)
  void* dw;             // [D, V] (dW)
  long long h_str[2];   // row, column
  long long w_str[2];   // d, v
  long long dh_str[2];  // row, column
  long long dw_str[2];  // d, v
  int N, D, V, dtype;
};

namespace {

constexpr int MAX_D = 1024;
constexpr int DC = 64;  // contraction chunk over D
constexpr int FWD_R = 64, FWD_V = 128;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// dst [R][ld] = rows [row0, row0 + R) x columns [col0, col0 + C) of a strided
// matrix whose element (r, c) lies at src[r·s_row + c·s_col]; zeros past
// nrows and ncols. col0 and C are multiples of 64. 16-byte loads when the
// columns are contiguous and aligned; otherwise one element per thread,
// neighbouring threads on the contiguous dimension.
template <typename T, int R>
__device__ void load_tile(T* dst, int ld, const T* src, long long s_row, long long s_col, int row0, int nrows,
                          int col0, int C, int ncols) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = s_col == 1 && ncols % VEC == 0 && s_row % VEC == 0 &&
                   reinterpret_cast<size_t>(src) % 16 == 0;
  if (vec) {
    const int per_row = C / VEC;
    for (int i = threadIdx.x; i < R * per_row; i += NUM_THREADS) {
      const int r = i / per_row, c = (i % per_row) * VEC;
      const int row = row0 + r, col = col0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < nrows && col < ncols) val = *reinterpret_cast<const uint4*>(src + row * s_row + col);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
    return;
  }
  const bool rows_contiguous = s_row == 1;
  for (int i = threadIdx.x; i < R * C; i += NUM_THREADS) {
    const int r = rows_contiguous ? i % R : i / C, c = rows_contiguous ? i / R : i % C;
    const int row = row0 + r, col = col0 + c;
    dst[r * ld + c] = (row < nrows && col < ncols) ? src[row * s_row + col * s_col] : from_float<T>(0.0f);
  }
}

// Per-row values for rows [row0, row0 + R): lse and g (0 past N), labels (−1 past N).
template <int R>
__device__ void load_row_state(const XentParams& p, int row0, float* lse_s, float* g_s, int* y_s) {
  for (int r = threadIdx.x; r < R; r += NUM_THREADS) {
    const bool in = row0 + r < p.N;
    lse_s[r] = in ? p.lse_in[row0 + r] : 0.0f;
    g_s[r] = in ? p.g[row0 + r] : 0.0f;
    y_s[r] = in ? p.y[row0 + r] : -1;
  }
}

// ds for one [R][BV] logits tile at (row0, v0): (exp(s − lse) − onehot)·g in
// fp32, masked past V, rounded to T (the Pallas kernels' .astype before the
// product).
template <typename T, int R, int BV, int LDS, int LDD>
__device__ void dscores(const float* s_s, const float* lse_s, const float* g_s, const int* y_s, T* ds_s,
                        int v0, int V) {
  for (int i = threadIdx.x; i < R * BV; i += NUM_THREADS) {
    const int r = i / BV, c = i % BV, col = v0 + c;
    const float pv = col < V ? expf(s_s[r * LDS + c] - lse_s[r]) : 0.0f;
    ds_s[r * LDD + c] = from_float<T>((pv - (col == y_s[r] ? 1.0f : 0.0f)) * g_s[r]);
  }
}

// ---------------------------------------------------------------------------
// Forward: one CTA per 64-row tile, looping over vocab tiles.
// ---------------------------------------------------------------------------

template <typename T>
struct FwdSmem {
  static constexpr int R = FWD_R, BV = FWD_V, LDT = ld_t<T, DC>(), LDS = ld_f<BV>();
  static constexpr size_t bytes = (R * LDT + BV * LDT) * sizeof(T) + (R * LDS + 3 * R) * sizeof(float) +
                                  R * sizeof(int);
};

template <typename T>
__global__ void __launch_bounds__(NUM_THREADS) xent_fwd_kernel(const XentParams p) {
  using L = FwdSmem<T>;
  constexpr int R = L::R, BV = L::BV, LDT = L::LDT, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  T* h_s = reinterpret_cast<T*>(smem);                  // [R][LDT] H chunk
  T* w_s = h_s + R * LDT;                                // [BV][LDT] W chunk, vocab-major
  float* s_s = reinterpret_cast<float*>(w_s + BV * LDT);  // [R][LDS] logits tile
  float* m_s = s_s + R * LDS;                            // [R] running max
  float* l_s = m_s + R;                                  // [R] running sum
  float* gold_s = l_s + R;                               // [R] gold logit
  int* y_s = reinterpret_cast<int*>(gold_s + R);         // [R] labels

  const int row0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* h = static_cast<const T*>(p.h);
  const T* w = static_cast<const T*>(p.w);
  for (int r = threadIdx.x; r < R; r += NUM_THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
    gold_s[r] = 0.0f;
    y_s[r] = row0 + r < p.N ? p.y[row0 + r] : -1;
  }

  RegAcc<T, R, BV> acc;
  for (int v0 = 0; v0 < p.V; v0 += BV) {
    acc.zero();
    for (int d0 = 0; d0 < p.D; d0 += DC) {
      __syncthreads();  // the last chunk's products and the last tile's softmax are done
      load_tile<T, R>(h_s, LDT, h, p.h_str[0], p.h_str[1], row0, p.N, d0, DC, p.D);
      load_tile<T, BV>(w_s, LDT, w, p.w_str[1], p.w_str[0], v0, p.V, d0, DC, p.D);
      __syncthreads();
      acc.template mma<DC, false, true, LDT, LDT>(h_s, w_s);  // L += H_c · W_c
    }
    acc.store(s_s, LDS);
    __syncthreads();

    // Online logsumexp and the gold pick, one warp per row.
    for (int r = warp; r < R; r += NUM_WARPS) {
      const int yr = y_s[r];
      float sv[BV / 32];
      float mx = NEG_INF, gold = 0.0f;
#pragma unroll
      for (int j = 0; j < BV / 32; ++j) {
        const int col = v0 + lane + 32 * j;
        sv[j] = col < p.V ? s_s[r * LDS + lane + 32 * j] : NEG_INF;
        mx = fmaxf(mx, sv[j]);
        if (col == yr) gold += sv[j];
      }
      mx = warp_max(mx);
      gold = warp_sum(gold);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BV / 32; ++j) sum += v0 + lane + 32 * j < p.V ? expf(sv[j] - m_new) : 0.0f;
      sum = warp_sum(sum);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * expf(m_old - m_new) + sum;
        gold_s[r] += gold;
      }
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += NUM_THREADS) {
    if (row0 + r < p.N) {
      const float l = l_s[r] == 0.0f ? 1.0f : l_s[r];
      const float lse = m_s[r] + logf(l);
      p.lse[row0 + r] = lse;
      p.nll[row0 + r] = lse - gold_s[r];
    }
  }
}

// ---------------------------------------------------------------------------
// The backward kernels keep their operands resident in shared memory for the
// whole contraction over D, and their [rows, D] or [D, columns] accumulator
// in registers across the loop (tensor-core fragments for 16-bit inputs).
// ---------------------------------------------------------------------------

// s [R][lds] fp32 = A · Bᵀ over K (a multiple of 16): A [R][K] and B [BV][K]
// row-major in shared memory (lda, ldb), the whole contraction per output
// tile with no barrier inside.
template <typename T, int R, int BV>
__device__ void logits_tile(const T* A, int lda, const T* B, int ldb, int K, float* s, int lds) {
  if constexpr (IS_16BIT<T>) {
    constexpr int TN = BV / 16;
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < (R / 16) * TN; t += NUM_WARPS) {
      const int m0 = (t / TN) * 16, n0 = (t % TN) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll 4
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + m0 * lda + k0, lda);
        wmma::load_matrix_sync(b, B + n0 * ldb + k0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(s + m0 * lds + n0, c, lds, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < R * BV; i += NUM_THREADS) {
      const int m = i / BV, n = i % BV;
      float acc = 0.0f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) acc = fmaf(A[m * lda + k], B[n * ldb + k], acc);
      s[m * lds + n] = acc;
    }
  }
}

// Per-thread fp32 accumulators for an fp32 [M][N] output (M·N <= MAX_D·32):
// thread t owns elements t, t + NUM_THREADS, ... .
constexpr int SCALAR_PER = MAX_D * 32 / NUM_THREADS;

// ---------------------------------------------------------------------------
// dH: one CTA per row tile (32 rows; fp32 16), looping over vocab tiles (64
// columns; fp32 32). The CTA's H rows stay in shared memory; each vocab tile
// loads its [BV, D] slice of W once, forms the logits and ds from it, and
// adds ds·W_tile to dH [R, D], which lives in registers: warp w owns the
// 16-column slices w, w + 8, ... of D (at most 8 at D = 1024), for both
// 16-row halves.
// ---------------------------------------------------------------------------

template <typename T> struct DhTile { static constexpr int R = 32, BV = 64; };
template <> struct DhTile<float> { static constexpr int R = 16, BV = 32; };

template <typename T>
struct DhSmem {
  static constexpr int R = DhTile<T>::R, BV = DhTile<T>::BV, LDS = ld_f<BV>(), LDD = ld_t<T, BV>();
  __host__ __device__ static int ldh(int DP) { return DP + pad<T>(); }
  // [R][ldh] H rows, [BV][ldh] W tile, [R][LDS] logits, [R][LDD] ds, lse, g, y
  static size_t bytes(int DP) {
    return ((R + BV) * ldh(DP) + R * LDD) * sizeof(T) + (R * LDS + 2 * R) * sizeof(float) + R * sizeof(int);
  }
};

template <typename T>
__global__ void __launch_bounds__(NUM_THREADS) xent_bwd_dh_kernel(const XentParams p) {
  using L = DhSmem<T>;
  constexpr int R = L::R, BV = L::BV, LDS = L::LDS, LDD = L::LDD;
  const int DP = round_up(p.D, DC), LDH = L::ldh(DP);
  extern __shared__ __align__(128) unsigned char smem[];
  T* h_s = reinterpret_cast<T*>(smem);                   // [R][LDH] the CTA's rows of H
  T* w_s = h_s + R * LDH;                                 // [BV][LDH] the vocab tile of W, vocab-major
  T* ds_s = w_s + BV * LDH;                               // [R][LDD]
  float* s_s = reinterpret_cast<float*>(ds_s + R * LDD);  // [R][LDS]
  float* lse_s = s_s + R * LDS;                           // [R]
  float* g_s = lse_s + R;                                 // [R]
  int* y_s = reinterpret_cast<int*>(g_s + R);             // [R]

  const int row0 = blockIdx.x * R;
  const int warp = threadIdx.x / 32;
  const T* w = static_cast<const T*>(p.w);
  load_tile<T, R>(h_s, LDH, static_cast<const T*>(p.h), p.h_str[0], p.h_str[1], row0, p.N, 0, DP, p.D);
  load_row_state<R>(p, row0, lse_s, g_s, y_s);

  constexpr int NT = MAX_D / 16 / NUM_WARPS;  // column slices of D a warp can own
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NT];
  float sacc[SCALAR_PER];
  if constexpr (IS_16BIT<T>) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      wmma::fill_fragment(acc[0][i], 0.0f);
      wmma::fill_fragment(acc[1][i], 0.0f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < SCALAR_PER; ++i) sacc[i] = 0.0f;
  }

  for (int v0 = 0; v0 < p.V; v0 += BV) {
    __syncthreads();  // the last tile's products have read w_s and ds_s
    load_tile<T, BV>(w_s, LDH, w, p.w_str[1], p.w_str[0], v0, p.V, 0, DP, p.D);
    __syncthreads();
    logits_tile<T, R, BV>(h_s, LDH, w_s, LDH, DP, s_s, LDS);
    __syncthreads();
    dscores<T, R, BV, LDS, LDD>(s_s, lse_s, g_s, y_s, ds_s, v0, p.V);
    __syncthreads();
    // dH += ds · W_tile: A = ds [R][BV], B = W_tile [BV][D] row-major
    if constexpr (IS_16BIT<T>) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[2][BV / 16];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int k = 0; k < BV / 16; ++k) wmma::load_matrix_sync(a[m][k], ds_s + m * 16 * LDD + k * 16, LDD);
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int nt = warp + i * NUM_WARPS;
        if (nt < DP / 16) {
#pragma unroll
          for (int k = 0; k < BV / 16; ++k) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
            wmma::load_matrix_sync(b, w_s + k * 16 * LDH + nt * 16, LDH);
            wmma::mma_sync(acc[0][i], a[0][k], b, acc[0][i]);
            wmma::mma_sync(acc[1][i], a[1][k], b, acc[1][i]);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < SCALAR_PER; ++i) {
        const int e = threadIdx.x + i * NUM_THREADS;
        if (e < R * DP) {
          const int r = e / DP, d = e % DP;
          float sum = sacc[i];
          for (int k = 0; k < BV; ++k) sum = fmaf(to_float(ds_s[r * LDD + k]), to_float(w_s[k * LDH + d]), sum);
          sacc[i] = sum;
        }
      }
    }
  }

  // Stage dH through shared memory (fp32 [R][DP + 4], over h_s and w_s) and
  // write it in the input type.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
  const int LDO = DP + 4;
  if constexpr (IS_16BIT<T>) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int nt = warp + i * NUM_WARPS;
      if (nt < DP / 16) {
        wmma::store_matrix_sync(stage + nt * 16, acc[0][i], LDO, wmma::mem_row_major);
        wmma::store_matrix_sync(stage + 16 * LDO + nt * 16, acc[1][i], LDO, wmma::mem_row_major);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < SCALAR_PER; ++i) {
      const int e = threadIdx.x + i * NUM_THREADS;
      if (e < R * DP) stage[(e / DP) * LDO + e % DP] = sacc[i];
    }
  }
  __syncthreads();
  T* dh = static_cast<T*>(p.dh);
  for (int i = threadIdx.x; i < R * DP; i += NUM_THREADS) {
    const int r = i / DP, d = i % DP;
    if (row0 + r < p.N && d < p.D) dh[(row0 + r) * p.dh_str[0] + d * p.dh_str[1]] = from_float<T>(stage[r * LDO + d]);
  }
}

// ---------------------------------------------------------------------------
// dW: one CTA per 32-column vocab tile, looping over row tiles (64 rows;
// fp32 16). The CTA's [32, D] slice of W stays in shared memory; each row
// tile loads its H rows once, forms the logits and ds from them, and adds
// H_tileᵀ·ds to dW [D, 32], which lives in registers: warp w owns the
// 16-row slices w, w + 8, ... of D (at most 8 at D = 1024), for both
// 16-column halves.
// ---------------------------------------------------------------------------

template <typename T> struct DwTile { static constexpr int R = 64, BV = 32; };
template <> struct DwTile<float> { static constexpr int R = 16, BV = 32; };

template <typename T>
struct DwSmem {
  static constexpr int R = DwTile<T>::R, BV = DwTile<T>::BV, LDS = ld_f<BV>(), LDD = ld_t<T, BV>();
  __host__ __device__ static int ldh(int DP) { return DP + pad<T>(); }
  // [BV][ldh] W tile, [R][ldh] H rows, [R][LDS] logits, [R][LDD] ds, lse, g, y
  static size_t bytes(int DP) {
    return ((BV + R) * ldh(DP) + R * LDD) * sizeof(T) + (R * LDS + 2 * R) * sizeof(float) + R * sizeof(int);
  }
};

template <typename T>
__global__ void __launch_bounds__(NUM_THREADS) xent_bwd_dw_kernel(const XentParams p) {
  using L = DwSmem<T>;
  constexpr int R = L::R, BV = L::BV, LDS = L::LDS, LDD = L::LDD;
  const int DP = round_up(p.D, DC), LDH = L::ldh(DP);
  extern __shared__ __align__(128) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);                   // [BV][LDH] the CTA's vocab tile of W
  T* h_s = w_s + BV * LDH;                                // [R][LDH] a row tile of H
  T* ds_s = h_s + R * LDH;                                // [R][LDD]
  float* s_s = reinterpret_cast<float*>(ds_s + R * LDD);  // [R][LDS]
  float* lse_s = s_s + R * LDS;                           // [R]
  float* g_s = lse_s + R;                                 // [R]
  int* y_s = reinterpret_cast<int*>(g_s + R);             // [R]

  const int v0 = blockIdx.x * BV;
  const int warp = threadIdx.x / 32;
  const T* h = static_cast<const T*>(p.h);
  load_tile<T, BV>(w_s, LDH, static_cast<const T*>(p.w), p.w_str[1], p.w_str[0], v0, p.V, 0, DP, p.D);

  constexpr int MT = MAX_D / 16 / NUM_WARPS;  // row slices of D a warp can own
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][2];
  float sacc[SCALAR_PER];
  if constexpr (IS_16BIT<T>) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      wmma::fill_fragment(acc[i][0], 0.0f);
      wmma::fill_fragment(acc[i][1], 0.0f);
    }
  } else {
#pragma unroll
    for (int i = 0; i < SCALAR_PER; ++i) sacc[i] = 0.0f;
  }

  for (int row0 = 0; row0 < p.N; row0 += R) {
    __syncthreads();  // the last tile's products have read h_s, ds_s and the row state
    load_tile<T, R>(h_s, LDH, h, p.h_str[0], p.h_str[1], row0, p.N, 0, DP, p.D);
    load_row_state<R>(p, row0, lse_s, g_s, y_s);
    __syncthreads();
    logits_tile<T, R, BV>(h_s, LDH, w_s, LDH, DP, s_s, LDS);
    __syncthreads();
    dscores<T, R, BV, LDS, LDD>(s_s, lse_s, g_s, y_s, ds_s, v0, p.V);
    __syncthreads();
    // dW += H_tileᵀ · ds: A = H_tileᵀ [D][R] (h_s read column-major), B = ds [R][BV]
    if constexpr (IS_16BIT<T>) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[R / 16][2];
#pragma unroll
      for (int k = 0; k < R / 16; ++k) {
        wmma::load_matrix_sync(b[k][0], ds_s + k * 16 * LDD, LDD);
        wmma::load_matrix_sync(b[k][1], ds_s + k * 16 * LDD + 16, LDD);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int mt = warp + i * NUM_WARPS;
        if (mt < DP / 16) {
#pragma unroll
          for (int k = 0; k < R / 16; ++k) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::col_major> a;
            wmma::load_matrix_sync(a, h_s + k * 16 * LDH + mt * 16, LDH);
            wmma::mma_sync(acc[i][0], a, b[k][0], acc[i][0]);
            wmma::mma_sync(acc[i][1], a, b[k][1], acc[i][1]);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < SCALAR_PER; ++i) {
        const int e = threadIdx.x + i * NUM_THREADS;
        if (e < DP * BV) {
          const int d = e / BV, c = e % BV;
          float sum = sacc[i];
          for (int k = 0; k < R; ++k) sum = fmaf(to_float(h_s[k * LDH + d]), to_float(ds_s[k * LDD + c]), sum);
          sacc[i] = sum;
        }
      }
    }
  }

  // Stage dW through shared memory (fp32 [DP][BV + 4], over w_s and h_s) and
  // write it with the head's strides.
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
  constexpr int LDO = BV + 4;
  if constexpr (IS_16BIT<T>) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = warp + i * NUM_WARPS;
      if (mt < DP / 16) {
        wmma::store_matrix_sync(stage + mt * 16 * LDO, acc[i][0], LDO, wmma::mem_row_major);
        wmma::store_matrix_sync(stage + mt * 16 * LDO + 16, acc[i][1], LDO, wmma::mem_row_major);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < SCALAR_PER; ++i) {
      const int e = threadIdx.x + i * NUM_THREADS;
      if (e < DP * BV) stage[(e / BV) * LDO + e % BV] = sacc[i];
    }
  }
  __syncthreads();
  T* dw = static_cast<T*>(p.dw);
  const bool d_contiguous = p.dw_str[0] == 1;  // the tied head's layout: write along d
  for (int i = threadIdx.x; i < DP * BV; i += NUM_THREADS) {
    const int d = d_contiguous ? i % DP : i / BV, c = d_contiguous ? i / DP : i % BV;
    if (d < p.D && v0 + c < p.V) dw[d * p.dw_str[0] + (v0 + c) * p.dw_str[1]] = from_float<T>(stage[d * LDO + c]);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

enum Which { FWD, DH, DW };

template <typename T>
int launch(const XentParams& p, Which which, cudaStream_t stream) {
  const int DP = round_up(p.D, DC);
  void (*kernel)(const XentParams);
  size_t smem;
  int grid;
  if (which == FWD) {
    kernel = xent_fwd_kernel<T>;
    smem = FwdSmem<T>::bytes;
    grid = (p.N + FWD_R - 1) / FWD_R;
  } else if (which == DH) {
    kernel = xent_bwd_dh_kernel<T>;
    smem = DhSmem<T>::bytes(DP);
    grid = (p.N + DhTile<T>::R - 1) / DhTile<T>::R;
  } else {
    kernel = xent_bwd_dw_kernel<T>;
    smem = DwSmem<T>::bytes(DP);
    grid = (p.V + DwTile<T>::BV - 1) / DwTile<T>::BV;
  }
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, NUM_THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const XentParams* p, Which which, void* stream) {
  if (p == nullptr || p->N < 1 || p->D < 1 || p->D > MAX_D || p->V < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return launch<float>(*p, which, s);
  if (p->dtype == 1) return launch<bf16>(*p, which, s);
  if (p->dtype == 2) return launch<half>(*p, which, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. The caller has checked
// shapes, dtypes, devices, int32 labels and 1 <= D <= 1024.
extern "C" int dstt_xent_fwd(const XentParams* p, void* stream) { return dispatch(p, FWD, stream); }
extern "C" int dstt_xent_bwd_dh(const XentParams* p, void* stream) { return dispatch(p, DH, stream); }
extern "C" int dstt_xent_bwd_dw(const XentParams* p, void* stream) { return dispatch(p, DW, stream); }
