// Fused vocab projection + cross-entropy on Hopper (sm_90a): forward, and the
// backward as three passes over vocab chunks.
//
// Replaces the three Pallas kernels of deepspeed_tpu/ops/pallas/fused_xent.py:
//   dstt_xent_fwd     <- _fwd_kernel    (:73,  pallas_call :123)
//   dstt_xent_bwd_ds, dstt_xent_bwd_dw, dstt_xent_bwd_dh
//                     <- _bwd_dh_kernel (:171, pallas_call :235)
//                      + _bwd_dw_kernel (:193, pallas_call :250)
//
// What they compute, for hidden H [N, D], head W [D, V] and labels y [N]
// (y < 0 is an ignored row), with logits L = H·W in fp32 and columns past V
// masked:
//   forward: lse[n] = logsumexp_v L[n, v], nll[n] = lse[n] − L[n, y[n]]
//            (the gold logit is 0 when no column matches y[n]);
//   dH:      dH = ds·Wᵀ, ds = (exp(L − lse) − onehot(y))·g[n] rounded to W's type;
//   dW:      dW = Hᵀ·ds, ds rounded to H's type (_block_ds, :155, with the
//            .astype of :184 and :207);
// with g [N] the cotangent of nll. The forward's logits never reach device
// memory; the backward's reach it one vocab chunk of ds at a time.
//
// Layout. H, dH: [N, D] with row/column strides; W, dW: [D, V] with d/v
// strides, so the tied head wteᵀ (a [V, D] row-major buffer, d stride 1) is
// read where it lies, and dW is written in the layout of the head it is the
// gradient of (for the tied head, the layout wte's gradient needs). Inputs
// and outputs share one type: fp32, bf16 or fp16.
//
// Forward. One CTA per 64-row tile, looping over 128-column vocab tiles, with
// a running row max, row sum and gold logit in shared memory; the
// contraction over D goes in 64-wide chunks of H and W staged in shared
// memory, the logits tile in tensor-core fragments (fp32: scalar FMAs). It
// does 2·N·D·V = 1.27 TFLOP at the training shape (N = 16384, D = 768,
// V = 50304, bf16): bound by operations at 1.28 ms.
//
// Backward. The caller walks the vocab in chunks [v0, v0 + vc) of a width
// chosen so that a chunk of ds, [N, vc] in the input type, fits a 256 MiB
// scratch (vc = 8192 at N = 16384: 7 chunks), and launches, per chunk and in
// order, three products on one GEMM mainloop with different epilogues:
//   ds pass: S = H·W[:, chunk] (K = D); the epilogue forms
//            ds = (exp(S − lse) − onehot(y))·g in fp32 in registers, rounds
//            it to the input type and stores it into the scratch (rows past
//            N and columns past the chunk are not stored: the products below
//            read them as TMA's zero fill);
//   dW:      dW[:, chunk] = Hᵀ·ds (K = N), stored with the head's strides
//            (as the [vc, D] product dsᵀ·H when the head is d-contiguous, so
//            each thread's column pairs are contiguous in memory);
//   dH:      dH_acc += ds·W[:, chunk]ᵀ (K = vc) into an fp32 [N, D] scratch;
//            the first chunk writes it, the last rounds it into dH.
// The chunks run in a fixed order, and every output tile belongs to one CTA
// (no atomics), so dH and dW are bitwise the same from run to run.
//
// What bounds the backward on this card, at the training shape: the logits
// once and two products, 6·N·D·V = 3.80 TFLOP, bound by operations at 3.84 ms
// (989 TFLOP/s); its traffic, chiefly the scratch (each chunk of ds written
// once and read twice, 0.8 GB per full chunk) and the fp32 dH accumulator
// (50 MB read and written per chunk), is ≈ 6 GB, ≈ 1.8 ms at 3.35 TB/s.
// The first design (one dH kernel and one dW kernel, each recomputing the
// logits: 5.07 TFLOP, at ~8% of the card) was held back by four things, and
// this design answers each:
//   - no tensor-core path and no overlap (wmma from padded shared memory,
//     four CTA-wide barriers a tile): here a TMA producer warp keeps a 3- or
//     4-stage ring of 128-byte-swizzled tiles in flight on mbarriers, and
//     two consumer warpgroups run wgmma m64n128k16 from shared memory with
//     fp32 accumulators in registers, keeping one product in flight while
//     the next stage is waited for;
//   - the logits and ds through fp32 shared memory: here ds is formed in the
//     accumulator registers and stored once, in the input type;
//   - the streamed operand re-read per 32-row or 32-column CTA (40 GB per
//     call): here 128 x 128 output tiles, with the N-tiles of one M-tile in
//     consecutive CTAs so that they share the M-tile's strip in L2;
//   - the logits computed twice: here once per chunk, for both products.
// The cost: a [N, vc] chunk of ds (256 MiB) and the fp32 dH accumulator
// (48 MiB at N = 16384, D = 768) reach device memory; the full [N, V] fp32
// logits (3.3 GB) still never do. Why not larger tiles: a [rows, D] or
// [D, cols] accumulator of full width cannot live in a warpgroup's
// registers at D = 768, so one kernel per gradient would have to split D and
// recompute the logits per slice; three plain products on a scratch need no
// such split and no bound on D.
//
// The 16-bit backward reads its operands by TMA, which needs a unit stride,
// a 16-byte base and the other stride a multiple of 8 elements; the wrapper
// sends any other operand to a padded copy before the launch
// (ops/fused_xent.py). fp32 takes the same three passes on a scalar-FMA
// kernel (64 x 64 tiles staged in shared memory; TF32 tensor cores would
// break the fp32 tolerance), which reads any strides.
//
// Plain C interface, loaded with ctypes. Each entry point launches on the
// caller's stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (or the error of cudaFuncSetAttribute;
// cudaErrorInvalidValue for arguments it does not take, cudaErrorNotSupported
// if cuTensorMapEncodeTiled refuses a tensor map).

#include <cstring>

#include "hopper.cuh"

struct XentParams {
  const void* h;        // hidden [N, D]
  const void* w;        // head [D, V]
  const int* y;         // labels [N] int32; < 0 = ignored row
  const float* lse_in;  // [N] (backward)
  const float* g;       // [N] cotangent of nll (backward)
  float* lse;           // [N] (forward)
  float* nll;           // [N] (forward)
  void* dh;             // [N, D] (backward)
  void* dw;             // [D, V] (backward)
  void* ds;             // [N, ds_ld] the chunk's ds, input type (backward)
  float* dh_acc;        // [N, D] fp32 dH summed over the chunks so far (backward; unused with one chunk)
  long long h_str[2];   // row, column
  long long w_str[2];   // d, v
  long long dh_str[2];  // row, column
  long long dw_str[2];  // d, v
  int N, D, V, dtype;
  int v0, vc, ds_ld;    // the backward's vocab chunk [v0, v0 + vc), the scratch's row stride
};

namespace {

constexpr int DC = 64;  // the forward's contraction chunk over D
constexpr float LOG2E = 1.4426950408889634f;
constexpr int FWD_R = 64, FWD_V = 128;

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
// Backward: per vocab chunk, three products C[M, N] = A·B over K, on one
// mainloop, each with its own epilogue. Operand element (i, k), i along M
// (A) or N (B), lies at base[i·si + k·sk].
// ---------------------------------------------------------------------------

struct Operand {
  const void* base;
  long long si, sk;
  int rows;  // extent along M (A) or N (B); reads past it, or past K, give 0
};

// Two values to adjacent elements p[0], p[1] (4-byte aligned for 16-bit T, 8 for fp32).
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (IS_16BIT<T>) {
    *reinterpret_cast<uint32_t*>(p) = pack2<T>(a, b);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
}

// The epilogues. Each mainloop hands its accumulator to put() as pairs of
// adjacent columns (c even) of row r, after fetching the row's state once.

// ds = (exp(s − lse) − onehot(y))·g in fp32, rounded to T, into the scratch
// [N, ld] (column c is vocab id v0 + c).
template <typename T>
struct DsOut {
  const float* lse;
  const float* g;
  const int* y;
  T* ds;
  long long ld;
  int N, vc, v0;

  struct Row {
    float lse2, g;  // lse·log2 e
    int y;          // label − v0: a column of this chunk, or none
  };
  __device__ __forceinline__ Row row(int r) const {
    return r < N ? Row{lse[r] * LOG2E, g[r], y[r] - v0} : Row{0.0f, 0.0f, -1};
  }
  __device__ __forceinline__ void put(const Row& w, int r, int c, float a, float b) const {
    if (r >= N || c >= vc) return;
    const float d0 = (exp2f(fmaf(a, LOG2E, -w.lse2)) - (c == w.y ? 1.0f : 0.0f)) * w.g;
    const float d1 = (exp2f(fmaf(b, LOG2E, -w.lse2)) - (c + 1 == w.y ? 1.0f : 0.0f)) * w.g;
    T* p = ds + r * ld + c;
    if (c + 1 < vc) {
      store_pair<T>(p, d0, d1);
    } else {
      p[0] = from_float<T>(d0);
    }
  }
};

// dW[:, chunk] in the head's layout: element (r, c) of the product at out[r·sm + c·sn].
template <typename T>
struct DwOut {
  T* out;
  long long sm, sn;
  int M, N;
  bool pairs;  // sn == 1 with 4-byte (16-bit) or 8-byte (fp32) aligned pairs

  struct Row {};
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ void put(Row, int r, int c, float a, float b) const {
    if (r >= M || c >= N) return;
    T* p = out + r * sm + c * sn;
    if (pairs && c + 1 < N) {
      store_pair<T>(p, a, b);
    } else {
      p[0] = from_float<T>(a);
      if (c + 1 < N) p[sn] = from_float<T>(b);
    }
  }
};

// dH: the fp32 accumulator acc [N, D] (+)= the product (written by the first
// chunk, added to by the rest); the last chunk rounds the sum into dH.
template <typename T>
struct DhOut {
  float* acc;
  T* dh;
  long long s0, s1;
  int N, D;
  bool first, last, pairs;  // pairs: D even, dh rows contiguous with 4/8-byte aligned pairs

  struct Row {};
  __device__ __forceinline__ Row row(int) const { return {}; }
  __device__ __forceinline__ void put(Row, int r, int c, float a, float b) const {
    if (r >= N || c >= D) return;
    float* q = acc + static_cast<long long>(r) * D + c;
    if (pairs) {  // D even, so c + 1 < D
      if (!first) {
        const float2 old = *reinterpret_cast<const float2*>(q);
        a += old.x;
        b += old.y;
      }
      if (last) {
        store_pair<T>(dh + r * s0 + c, a, b);
      } else {
        *reinterpret_cast<float2*>(q) = make_float2(a, b);
      }
      return;
    }
    const float v[2] = {a, b};
    for (int e = 0; e < 2 && c + e < D; ++e) {
      const float x = first ? v[e] : v[e] + q[e];
      if (last) {
        dh[r * s0 + (c + e) * s1] = from_float<T>(x);
      } else {
        q[e] = x;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// 16-bit mainloop on Hopper: CTA = a 128 x 128 output tile; one producer warp
// (TMA) and two consumer warpgroups (64 rows each, wgmma m64n128k16, 64 fp32
// accumulators a thread), a ring of 64-deep A and B tiles between them. A
// K-major operand tile is [rows][64] (one 128-byte-swizzled atom); an
// MN-major one is [64][rows] as rows/64 atoms of [64][64] (hopper.cuh).
// ---------------------------------------------------------------------------

constexpr int G_BM = 128, G_BN = 128, G_BK = 64;
constexpr int G_CONSUMER_WARPS = 8;
constexpr int G_THREADS = G_CONSUMER_WARPS * 32 + 32;

// CTAs an SM, and the ring's stages. The ds pass contracts over D only (12
// tiles at D = 768), so its epilogue weighs: two CTAs an SM on 3 stages let
// one CTA's epilogue overlap the other's mainloop. The two long products
// contract over thousands of rows or columns and run faster on one CTA an SM
// with 4 stages (both settings timed for all three on an H100; PERF.md).
template <typename Out> constexpr int CTAS_PER_SM = 1;
template <typename T> constexpr int CTAS_PER_SM<DsOut<T>> = 2;
template <typename Out> constexpr int STAGES = CTAS_PER_SM<Out> == 2 ? 3 : 4;

struct GemmMaps {
  CUtensorMap a, b;
};

template <typename T, int ST>
struct GemmSmem {
  static constexpr int A_ELEMS = G_BM * G_BK, B_ELEMS = G_BN * G_BK;
  static constexpr uint32_t STAGE_BYTES = (A_ELEMS + B_ELEMS) * sizeof(T);
  static constexpr size_t bytes = 1024 + ST * STAGE_BYTES + 2 * ST * sizeof(uint64_t);
};

// One stage of an operand: rows [i0, i0 + R) x depth [k0, k0 + 64).
template <int R, bool MN, typename T>
__device__ __forceinline__ void tma_operand(T* dst, const CUtensorMap* map, uint64_t* bar, int i0, int k0) {
  if constexpr (MN) {
#pragma unroll
    for (int a = 0; a < R / 64; ++a) tma_load_tile(dst + a * 64 * G_BK, map, bar, i0 + 64 * a, k0, 0, 0);
  } else {
    tma_load_tile(dst, map, bar, k0, i0, 0, 0);
  }
}

// Descriptor of depth step kk (16 deep) of an operand tile, from row 64·sub
// on (sub: the warpgroup's 64 rows of A; 0 for B).
template <bool MN, typename T>
__device__ __forceinline__ uint64_t operand_desc(const T* tile, int sub, int kk) {
  if constexpr (MN) {
    return desc_b128(tile + sub * 64 * G_BK + kk * 16 * 64, G_BK * 128);
  } else {
    return desc_b128(tile + sub * 64 * 64 + kk * 16, 16);
  }
}

template <typename T, bool A_MN, bool B_MN, typename Out>
__global__ void __launch_bounds__(G_THREADS, CTAS_PER_SM<Out>)
    xent_gemm_hopper(const __grid_constant__ GemmMaps maps, const int K, const Out out) {
  constexpr int ST = STAGES<Out>;
  using L = GemmSmem<T, ST>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  T* a_s = reinterpret_cast<T*>(smem);  // stage s at a_s + s * A_ELEMS
  T* b_s = a_s + ST * L::A_ELEMS;
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + ST * L::B_ELEMS);
  uint64_t* empty = full + ST;

  const int m0 = blockIdx.y * G_BM, n0 = blockIdx.x * G_BN;  // the N-tiles of one M-tile run side by side
  const int nk = (K + G_BK - 1) / G_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == G_CONSUMER_WARPS) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % ST;
        if (kt >= ST) mbar_wait(&empty[s], ((kt / ST) - 1) & 1);
        mbar_arrive_expect_tx(&full[s], L::STAGE_BYTES);
        tma_operand<G_BM, A_MN>(a_s + s * L::A_ELEMS, &maps.a, &full[s], m0, kt * G_BK);
        tma_operand<G_BN, B_MN>(b_s + s * L::B_ELEMS, &maps.b, &full[s], n0, kt * G_BK);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows m0 + 64·wg + [0, 64) of the tile.
  const int wg = warp / 4, t = threadIdx.x % 128;
  float acc[G_BN / 2];
#pragma unroll
  for (int i = 0; i < G_BN / 2; ++i) acc[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % ST;
    const T* a_t = a_s + s * L::A_ELEMS;
    const T* b_t = b_s + s * L::B_ELEMS;
    mbar_wait(&full[s], (kt / ST) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G_BK / 16; ++kk) {
      wgmma_ss<T, G_BN, B_MN, A_MN>(acc, operand_desc<A_MN>(a_t, wg, kk), operand_desc<B_MN>(b_t, 0, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: hand it back
    fence_regs(acc);
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(kt - 1) % ST]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int r0 = m0 + 64 * wg + acc_row(0, t);
  const typename Out::Row rows[2] = {out.row(r0), out.row(r0 + 8)};
#pragma unroll
  for (int i = 0; i < G_BN / 2; i += 2) {
    const int r = (i >> 1) & 1;
    out.put(rows[r], r0 + 8 * r, n0 + acc_col(i, t), acc[i], acc[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// fp32 mainloop: CTA = a 64 x 64 output tile of 256 threads, 16-deep tiles of
// A and B staged in shared memory (loaded along whichever dimension is
// contiguous), scalar FMAs; thread (ty, tx) owns rows 4·ty + [0, 4) and
// columns 2·tx + {0, 1} and 32 + 2·tx + {0, 1}.
// ---------------------------------------------------------------------------

constexpr int F32_T = 64, F32_K = 16;

__device__ __forceinline__ void load_operand_f32(float (*dst)[F32_T + 4], const Operand& o, int i0, int k0,
                                                 int K) {
  const float* src = static_cast<const float*>(o.base);
  const bool i_fast = o.si == 1;
  for (int e = threadIdx.x; e < F32_T * F32_K; e += NUM_THREADS) {
    const int i = i_fast ? e % F32_T : e / F32_K, k = i_fast ? e / F32_T : e % F32_K;
    const int gi = i0 + i, gk = k0 + k;
    dst[k][i] = gi < o.rows && gk < K ? src[gi * o.si + gk * o.sk] : 0.0f;
  }
}

template <typename Out>
__global__ void __launch_bounds__(NUM_THREADS) xent_gemm_f32(const Operand a, const Operand b, const int K,
                                                             const Out out) {
  __shared__ __align__(16) float a_s[F32_K][F32_T + 4];
  __shared__ __align__(16) float b_s[F32_K][F32_T + 4];
  const int m0 = blockIdx.y * F32_T, n0 = blockIdx.x * F32_T;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float c[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += F32_K) {
    __syncthreads();  // the last tile's products are done
    load_operand_f32(a_s, a, m0, k0, K);
    load_operand_f32(b_s, b, n0, k0, K);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F32_K; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[k][4 * ty]);
      const float2 b0 = *reinterpret_cast<const float2*>(&b_s[k][2 * tx]);
      const float2 b1 = *reinterpret_cast<const float2*>(&b_s[k][32 + 2 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {b0.x, b0.y, b1.x, b1.y};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] = fmaf(ar[i], br[j], c[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
    const typename Out::Row w = out.row(r);
    out.put(w, r, n0 + 2 * tx, c[i][0], c[i][1]);
    out.put(w, r, n0 + 32 + 2 * tx, c[i][2], c[i][3]);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// TMA reads an operand with a unit stride along k (K-major) or along i
// (MN-major), a 16-byte base and the other stride a multiple of 8 elements.
bool tma_readable(const Operand& o, bool mn) {
  const long long unit = mn ? o.si : o.sk, other = mn ? o.sk : o.si;
  return unit == 1 && other > 0 && other % 8 == 0 && reinterpret_cast<size_t>(o.base) % 16 == 0;
}

// The operand as a [1, outer, 1, inner] map (inner: its contiguous
// dimension), boxes of 64 contiguous elements by `box` rows.
bool operand_map(CUtensorMap* map, const Operand& o, int K, bool mn, int box, bool is_bf16) {
  const int inner = mn ? o.rows : K, outer = mn ? K : o.rows;
  const long long ld = mn ? o.sk : o.si;
  const long long str[3] = {ld * outer, ld, ld * outer};  // batch, row, head
  return tile_map(map, o.base, is_bf16, str, 1, outer, 1, inner, box);
}

// C [M, N] = A·B over K, through out. 16-bit: A_MN / B_MN say which operand
// is read MN-major; fp32 reads any strides.
template <typename T, bool A_MN, bool B_MN, typename Out>
int gemm(const Operand& a, const Operand& b, int M, int N, int K, const Out& out, cudaStream_t stream) {
  if constexpr (!IS_16BIT<T>) {
    const dim3 grid((N + F32_T - 1) / F32_T, (M + F32_T - 1) / F32_T);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    xent_gemm_f32<Out><<<grid, NUM_THREADS, 0, stream>>>(a, b, K, out);
  } else {
    using L = GemmSmem<T, STAGES<Out>>;
    if (!tma_readable(a, A_MN) || !tma_readable(b, B_MN)) return static_cast<int>(cudaErrorInvalidValue);
    const bool is_bf16 = std::is_same<T, bf16>::value;
    GemmMaps maps;
    memset(&maps, 0, sizeof(maps));
    if (!operand_map(&maps.a, a, K, A_MN, A_MN ? G_BK : G_BM, is_bf16) ||
        !operand_map(&maps.b, b, K, B_MN, B_MN ? G_BK : G_BN, is_bf16)) {
      return static_cast<int>(cudaErrorNotSupported);
    }
    const dim3 grid((N + G_BN - 1) / G_BN, (M + G_BM - 1) / G_BM);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = xent_gemm_hopper<T, A_MN, B_MN, Out>;
    const int e = set_smem(kernel, L::bytes);
    if (e != 0) return e;
    kernel<<<grid, G_THREADS, L::bytes, stream>>>(maps, K, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The head's columns [v0, v0 + vc).
template <typename T>
const T* head_chunk(const XentParams& p) {
  return static_cast<const T*>(p.w) + p.v0 * p.w_str[1];
}

template <typename T>
bool pair_aligned(const T* p) {
  return reinterpret_cast<size_t>(p) % (2 * sizeof(T)) == 0;
}

// ds pass: S = H·W[:, chunk], M = N, N = vc, K = D; H is read K-major, the
// head K-major when d-contiguous (the tied head) and MN-major otherwise.
template <typename T>
int bwd_ds(const XentParams& p, cudaStream_t stream) {
  const Operand a{p.h, p.h_str[0], p.h_str[1], p.N};
  const Operand b{head_chunk<T>(p), p.w_str[1], p.w_str[0], p.vc};
  const DsOut<T> out{p.lse_in, p.g, p.y, static_cast<T*>(p.ds), p.ds_ld, p.N, p.vc, p.v0};
  return p.w_str[0] == 1 ? gemm<T, false, false>(a, b, p.N, p.vc, p.D, out, stream)
                         : gemm<T, false, true>(a, b, p.N, p.vc, p.D, out, stream);
}

// dW[:, chunk] = Hᵀ·ds, K = N, both operands MN-major: as dsᵀ·H [vc, D] when
// dW is d-contiguous, else as Hᵀ·ds [D, vc].
template <typename T>
int bwd_dw(const XentParams& p, cudaStream_t stream) {
  const Operand h{p.h, p.h_str[1], p.h_str[0], p.D};
  const Operand ds{p.ds, 1, p.ds_ld, p.vc};
  T* base = static_cast<T*>(p.dw) + p.v0 * p.dw_str[1];
  if (p.dw_str[0] == 1) {
    const DwOut<T> out{base, p.dw_str[1], 1, p.vc, p.D, p.dw_str[1] % 2 == 0 && pair_aligned(base)};
    return gemm<T, true, true>(ds, h, p.vc, p.D, p.N, out, stream);
  }
  const DwOut<T> out{base, p.dw_str[0], p.dw_str[1], p.D, p.vc,
                     p.dw_str[1] == 1 && p.dw_str[0] % 2 == 0 && pair_aligned(base)};
  return gemm<T, true, true>(h, ds, p.D, p.vc, p.N, out, stream);
}

// dH (+)= ds·W[:, chunk]ᵀ, M = N, N = D, K = vc; ds read K-major, the head
// MN-major when d-contiguous (the tied head) and K-major otherwise.
template <typename T>
int bwd_dh(const XentParams& p, cudaStream_t stream) {
  const Operand a{p.ds, p.ds_ld, 1, p.N};
  const Operand b{head_chunk<T>(p), p.w_str[0], p.w_str[1], p.D};
  T* dh = static_cast<T*>(p.dh);
  const bool first = p.v0 == 0, last = p.v0 + p.vc >= p.V;
  if (!last && p.dh_acc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const DhOut<T> out{p.dh_acc, dh, p.dh_str[0], p.dh_str[1], p.N, p.D, first, last,
                     p.D % 2 == 0 && p.dh_str[1] == 1 && p.dh_str[0] % 2 == 0 && pair_aligned(dh)};
  return p.w_str[0] == 1 ? gemm<T, false, true>(a, b, p.N, p.D, p.vc, out, stream)
                         : gemm<T, false, false>(a, b, p.N, p.D, p.vc, out, stream);
}

enum Which { FWD, DS, DW, DH };

template <typename T>
int launch(const XentParams& p, Which which, cudaStream_t stream) {
  if (which == DS) return bwd_ds<T>(p, stream);
  if (which == DW) return bwd_dw<T>(p, stream);
  if (which == DH) return bwd_dh<T>(p, stream);
  const int e = set_smem(xent_fwd_kernel<T>, FwdSmem<T>::bytes);
  if (e != 0) return e;
  xent_fwd_kernel<T><<<(p.N + FWD_R - 1) / FWD_R, NUM_THREADS, FwdSmem<T>::bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const XentParams* p, Which which, void* stream) {
  if (p == nullptr || p->N < 1 || p->D < 1 || p->V < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (which != FWD && (p->v0 < 0 || p->vc < 1 || p->v0 + p->vc > p->V || p->ds_ld < p->vc)) {
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
// shapes, dtypes, devices and int32 labels, and for the 16-bit backward that
// its operands are TMA-readable (see above).
extern "C" int dstt_xent_fwd(const XentParams* p, void* stream) { return dispatch(p, FWD, stream); }
extern "C" int dstt_xent_bwd_ds(const XentParams* p, void* stream) { return dispatch(p, DS, stream); }
extern "C" int dstt_xent_bwd_dw(const XentParams* p, void* stream) { return dispatch(p, DW, stream); }
extern "C" int dstt_xent_bwd_dh(const XentParams* p, void* stream) { return dispatch(p, DH, stream); }
