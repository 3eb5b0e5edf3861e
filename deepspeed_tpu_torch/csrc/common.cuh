// Building blocks shared by the port's tiled kernels (flash_attention.cu,
// fused_xent.cu): element types, warp reductions, and CTA-wide products of
// tiles staged in shared memory.
//
// Element types: float, and the two 16-bit types bf16 and fp16. A product of
// 16-bit tiles runs on the tensor cores through nvcuda::wmma 16x16x16
// fragments with fp32 accumulators; a product of fp32 tiles runs as scalar
// FMAs. Every CTA has NUM_WARPS warps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;
using half = __half;

constexpr int NUM_WARPS = 8;
constexpr int NUM_THREADS = NUM_WARPS * 32;
// Finite "minus infinity", as in the TPU kernels: exp(NEG_INF - m) is 0 for
// any real m, and no inf - inf NaN can arise.
constexpr float NEG_INF = -1e30f;

template <typename T> constexpr bool IS_16BIT = !std::is_same<T, float>::value;

// Shared-memory rows are padded by 16 bytes (fp32 buffers by 4 floats), so
// the 16 rows of a tensor-core fragment fall in different banks.
template <typename T> constexpr int pad() { return 16 / static_cast<int>(sizeof(T)); }
template <typename T, int W> constexpr int ld_t() { return W + pad<T>(); }  // a [rows][W] T tile
template <int W> constexpr int ld_f() { return W + 4; }                     // a [rows][W] fp32 buffer

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ half from_float<half>(float x) { return __float2half(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// C[M][N] (=, or += with accumulate) op(A)·op(B), everything in shared memory,
// C fp32 row-major with leading dimension LDC. A is [M][K] row-major, or with
// A_T its transpose is stored ([K][M]); B is [K][N] row-major, or with B_T
// its transpose is stored ([N][K]); LDA/LDB are the stored row lengths.
// 16-bit inputs: tensor cores, one 16x16 output tile per warp at a time.
// fp32 inputs: scalar FMAs, one output element per thread at a time.
template <int M, int N, int K, bool A_T, bool B_T, int LDA, int LDB, int LDC, typename T>
__device__ void block_gemm(const T* A, const T* B, float* C, bool accumulate) {
  if constexpr (IS_16BIT<T>) {
    using LA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
    constexpr int TN = N / 16;
    const int warp = threadIdx.x / 32;
    for (int t = warp; t < (M / 16) * TN; t += NUM_WARPS) {
      const int m0 = (t / TN) * 16, n0 = (t % TN) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate) {
        wmma::load_matrix_sync(c, C + m0 * LDC + n0, LDC, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(c, 0.0f);
      }
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> bb;
        wmma::load_matrix_sync(a, A_T ? A + k0 * LDA + m0 : A + m0 * LDA + k0, LDA);
        wmma::load_matrix_sync(bb, B_T ? B + n0 * LDB + k0 : B + k0 * LDB + n0, LDB);
        wmma::mma_sync(c, a, bb, c);
      }
      wmma::store_matrix_sync(C + m0 * LDC + n0, c, LDC, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < M * N; i += NUM_THREADS) {
      const int m = i / N, n = i % N;
      float acc = accumulate ? C[m * LDC + n] : 0.0f;
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float a = A_T ? A[k * LDA + m] : A[m * LDA + k];
        const float b = B_T ? B[n * LDB + k] : B[k * LDB + n];
        acc = fmaf(a, b, acc);
      }
      C[m * LDC + n] = acc;
    }
  }
}

// An M x N fp32 accumulator kept in registers across calls. 16-bit inputs:
// tensor-core fragments, warp w owning output tiles w, w + NUM_WARPS, ... .
// Operands as in block_gemm.
template <typename T, int M, int N>
struct RegAcc {
  static constexpr int TN = N / 16, TILES = (M / 16) * TN, PER = (TILES + NUM_WARPS - 1) / NUM_WARPS;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[PER];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) wmma::fill_fragment(c[i], 0.0f);
  }

  // this += op(A)·op(B)
  template <int K, bool A_T, bool B_T, int LDA, int LDB>
  __device__ void mma(const T* A, const T* B) {
    using LA = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = warp + i * NUM_WARPS;
      if (t >= TILES) break;
      const int m0 = (t / TN) * 16, n0 = (t % TN) * 16;
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> bb;
        wmma::load_matrix_sync(a, A_T ? A + k0 * LDA + m0 : A + m0 * LDA + k0, LDA);
        wmma::load_matrix_sync(bb, B_T ? B + n0 * LDB + k0 : B + k0 * LDB + n0, LDB);
        wmma::mma_sync(c[i], a, bb, c[i]);
      }
    }
  }

  // -> C [M][LDC] fp32 in shared memory
  __device__ void store(float* C, int LDC) const {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = warp + i * NUM_WARPS;
      if (t >= TILES) break;
      wmma::store_matrix_sync(C + (t / TN) * 16 * LDC + (t % TN) * 16, c[i], LDC, wmma::mem_row_major);
    }
  }
};

// fp32 inputs: scalar FMAs, thread t owning output elements t, t + NUM_THREADS, ... .
template <int M, int N>
struct RegAcc<float, M, N> {
  static constexpr int PER = (M * N + NUM_THREADS - 1) / NUM_THREADS;
  float c[PER];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) c[i] = 0.0f;
  }

  template <int K, bool A_T, bool B_T, int LDA, int LDB>
  __device__ void mma(const float* A, const float* B) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NUM_THREADS;
      if (e >= M * N) break;
      const int m = e / N, n = e % N;
      float acc = c[i];
#pragma unroll 8
      for (int k = 0; k < K; ++k) {
        const float a = A_T ? A[k * LDA + m] : A[m * LDA + k];
        const float b = B_T ? B[n * LDB + k] : B[k * LDB + n];
        acc = fmaf(a, b, acc);
      }
      c[i] = acc;
    }
  }

  __device__ void store(float* C, int LDC) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * NUM_THREADS;
      if (e >= M * N) break;
      C[(e / N) * LDC + e % N] = c[i];
    }
  }
};

}  // namespace
