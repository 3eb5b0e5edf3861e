// Tile helpers shared by the attention kernels (flash_attention.cu,
// sparse_attention.cu): q/k/v/dO tiles of a [B, S, H, D] tensor read through
// its batch/sequence/head strides into shared memory, fp32 accumulators
// written back in the input type, per-row fp32 statistics ([B, H, S]), and
// the backward's P / dS tile.

#pragma once

#include "common.cuh"

namespace {

// Rows [row0, row0 + R) of a [B, S, H, D] tensor at (b, h) into shared
// memory [R][LD]; zeros past S and past D. 16-byte loads when the row
// starts and D allow them (coalesced: a row of D elements is contiguous).
template <typename T, int R, int DP, int LD>
__device__ void load_tile(T* dst, const T* src, const long long* str, int b, int h, int row0,
                          int S, int D) {
  constexpr int VEC = 16 / sizeof(T);
  const T* base = src + b * str[0] + h * str[2];
  const bool vec = D % VEC == 0 && str[1] % VEC == 0 && reinterpret_cast<size_t>(base) % 16 == 0;
  if (vec) {
    for (int i = threadIdx.x; i < R * (DP / VEC); i += NUM_THREADS) {
      const int r = i / (DP / VEC), d = (i % (DP / VEC)) * VEC;
      const int row = row0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < S && d < D) val = *reinterpret_cast<const uint4*>(base + row * str[1] + d);
      *reinterpret_cast<uint4*>(dst + r * LD + d) = val;
    }
    return;
  }
  for (int i = threadIdx.x; i < R * DP; i += NUM_THREADS) {
    const int r = i / DP, d = i % DP;
    const int row = row0 + r;
    dst[r * LD + d] = (row < S && d < D) ? base[row * str[1] + d] : from_float<T>(0.0f);
  }
}

// acc [R][LD] fp32 · factor -> rows [row0, row0 + R) of a [B, S, H, D] tensor.
template <typename T, int R, int DP, int LD>
__device__ void store_tile(T* dst, const long long* str, const float* acc, float factor, int b,
                           int h, int row0, int S, int D) {
  T* base = dst + b * str[0] + h * str[2];
  for (int i = threadIdx.x; i < R * DP; i += NUM_THREADS) {
    const int r = i / DP, d = i % DP;
    const int row = row0 + r;
    if (row < S && d < D) base[row * str[1] + d] = from_float<T>(acc[r * LD + d] * factor);
  }
}

// Per-row fp32 values ([B, H, S] layout) for rows [row0, row0 + R); 0 past S.
template <int R>
__device__ void load_rows(float* dst, const float* src, int b, int h, int H, int row0, int S) {
  const float* base = src + (static_cast<long long>(b) * H + h) * S;
  for (int r = threadIdx.x; r < R; r += NUM_THREADS) dst[r] = row0 + r < S ? base[row0 + r] : 0.0f;
}

// P = exp(s − lse) and dS = P∘(dP − Δ) for one [BQ][BK] tile, both rounded to
// the input type; s_s holds the raw Q·Kᵀ, dp_s holds dO·Vᵀ (leading dimension
// LDS), P and dS are written with leading dimension LDP. ``mask(dot, q, k)``
// turns a raw product into the masked, scaled score. Rows past Sq give 0.
template <typename T, int BQ, int BK, int LDS, int LDP, typename MaskT>
__device__ void probs_and_dscores(const MaskT& mask, const float* s_s, const float* dp_s,
                                  const float* lse_s, const float* delta_s, T* p_s, T* ds_s,
                                  int q0, int k0, int Sq) {
  for (int i = threadIdx.x; i < BQ * BK; i += NUM_THREADS) {
    const int r = i / BK, c = i % BK;
    const float pv = q0 + r < Sq ? expf(mask(s_s[r * LDS + c], q0 + r, k0 + c) - lse_s[r]) : 0.0f;
    if (p_s != nullptr) p_s[r * LDP + c] = from_float<T>(pv);
    ds_s[r * LDP + c] = from_float<T>(pv * (dp_s[r * LDS + c] - delta_s[r]));
  }
}

}  // namespace
