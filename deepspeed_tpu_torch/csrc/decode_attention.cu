// Single-token decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces deepspeed_tpu/ops/pallas/decode_attention.py::_decode_kernel.
//
//   out[b,h,:] = sum_k softmax_k(q[b,h]·k[b,k,h]·scale + slope_h·(k − pos[b])) · v[b,k,h,:]
//   over keys k in [0, pos[b]], fp32 accumulation, output in the input dtype.
//
// Layouts (all contiguous): q [B,H,D], k/v [B,Smax,H,D], pos [B] int32,
// slopes [H] fp32 or null (no ALiBi), out [B,H,D]. D <= 256, dtype fp32 or bf16.
//
// What bounds it: HBM bytes. Each (b,h) reads (pos[b]+1)·D keys and values
// once and does 4·D flops per key, about one flop per byte in bf16, far
// below the card's ~295 flops/byte ridge. The design therefore only aims
// to read the live prefix once, coalesced, and nothing past it:
//   * one CTA per (b,h); the CTA reads pos[b] from device memory itself,
//     so the grid never depends on a host-read position (a decode step
//     stays capturable as a CUDA graph);
//   * NUM_WARPS warps stride over keys 0..pos[b], KEYS_PER_ITER keys per
//     warp per iteration with all their loads issued before any math, so
//     a warp keeps several rows in flight; keys past pos[b] are never read;
//   * lane l owns elements l, l+32, ... of D, so a warp's load of one key
//     row (contiguous for fixed (b,h): 128 B at D=64 in bf16) is coalesced;
//   * each warp keeps its own running max, sum and accumulator (online
//     softmax); the warps' partial states are merged once in shared memory,
//     the same combine a split-KV (flash-decoding) version does across CTAs.
// Known limits, left to later work: B·H = 96 CTAs on the main path do not
// fill 132 SMs, and one warp keeps only KEYS_PER_ITER rows in flight.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NUM_WARPS = 16;
constexpr int KEYS_PER_ITER = 4;
constexpr int MAX_D = 256;
// Finite "minus infinity", as in the TPU kernel: exp(NEG_INF - m) is 0 for
// any real score m, and no inf - inf NaN can arise.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DPL: elements of D owned by each lane (D <= 32 * DPL).
template <typename T, int DPL>
__global__ void __launch_bounds__(NUM_WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        const float* __restrict__ slopes, T* __restrict__ out,
                        int Smax, int H, int D, float scale) {
  __shared__ float m_s[NUM_WARPS];
  __shared__ float l_s[NUM_WARPS];
  __shared__ float acc_s[NUM_WARPS][MAX_D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // Keys past the cache end do not exist: clamp, as the TPU kernel's block
  // index clamp does. A negative position reads nothing and writes zeros.
  const int p = min(pos[b], Smax - 1);
  const float slope = slopes != nullptr ? slopes[h] : 0.0f;

  const size_t key_stride = static_cast<size_t>(H) * D;
  const size_t head_off = (static_cast<size_t>(b) * Smax * H + h) * D;
  const T* kb = k + head_off;
  const T* vb = v + head_off;
  const T* qb = q + (static_cast<size_t>(b) * H + h) * D;

  float qr[DPL], acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < D ? to_float(qb[d]) : 0.0f;
    acc[j] = 0.0f;
  }
  float m = NEG_INF, l = 0.0f;

  for (int k0 = warp * KEYS_PER_ITER; k0 <= p; k0 += NUM_WARPS * KEYS_PER_ITER) {
    float kr[KEYS_PER_ITER][DPL], vr[KEYS_PER_ITER][DPL];
#pragma unroll
    for (int u = 0; u < KEYS_PER_ITER; ++u) {
      const int kk = k0 + u;
      const bool live = kk <= p;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const int d = lane + 32 * j;
        const bool ok = live && d < D;
        kr[u][j] = ok ? to_float(kb[kk * key_stride + d]) : 0.0f;
        vr[u][j] = ok ? to_float(vb[kk * key_stride + d]) : 0.0f;
      }
    }
    float s[KEYS_PER_ITER];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < KEYS_PER_ITER; ++u) {
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) part += qr[j] * kr[u][j];
      const int kk = k0 + u;
      s[u] = warp_sum(part) * scale + slope * static_cast<float>(kk - p);
      if (kk > p) s[u] = NEG_INF;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < KEYS_PER_ITER; ++u) {
      const float pu = k0 + u <= p ? expf(s[u] - m_new) : 0.0f;
      l += pu;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[j] += pu * vr[u][j];
    }
    m = m_new;
  }

  // Merge the warps' partial softmax states.
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + 32 * j;
    if (d < D) acc_s[warp][d] = acc[j];
  }
  __syncthreads();

  float m_all = NEG_INF;
#pragma unroll
  for (int w = 0; w < NUM_WARPS; ++w) m_all = fmaxf(m_all, m_s[w]);
  float l_all = 0.0f;
#pragma unroll
  for (int w = 0; w < NUM_WARPS; ++w) l_all += l_s[w] * expf(m_s[w] - m_all);
  const float inv_l = l_all > 0.0f ? 1.0f / l_all : 0.0f;

  T* ob = out + (static_cast<size_t>(b) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += NUM_WARPS * 32) {
    float o = 0.0f;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) o += acc_s[w][d] * expf(m_s[w] - m_all);
    store(ob + d, o * inv_l);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const void* pos,
            const void* slopes, void* out, int B, int Smax, int H, int D,
            float scale, cudaStream_t stream) {
  const dim3 grid(H, B);
  const dim3 block(NUM_WARPS * 32);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* pt = static_cast<const int*>(pos);
  const float* st = static_cast<const float*>(slopes);
  T* ot = static_cast<T*>(out);
  if (D <= 32) {
    decode_attention_kernel<T, 1><<<grid, block, 0, stream>>>(qt, kt, vt, pt, st, ot, Smax, H, D, scale);
  } else if (D <= 64) {
    decode_attention_kernel<T, 2><<<grid, block, 0, stream>>>(qt, kt, vt, pt, st, ot, Smax, H, D, scale);
  } else if (D <= 128) {
    decode_attention_kernel<T, 4><<<grid, block, 0, stream>>>(qt, kt, vt, pt, st, ot, Smax, H, D, scale);
  } else {
    decode_attention_kernel<T, 8><<<grid, block, 0, stream>>>(qt, kt, vt, pt, st, ot, Smax, H, D, scale);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The caller has checked shapes, dtypes,
// contiguity, 1 <= D <= 256 and 1 <= B <= 65535.
extern "C" int dstt_decode_attention(const void* q, const void* k, const void* v,
                                     const void* pos, const void* slopes, void* out,
                                     int B, int Smax, int H, int D, int dtype,
                                     float scale, void* stream) {
  if (D < 1 || D > MAX_D || B < 1 || H < 1 || Smax < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(q, k, v, pos, slopes, out, B, Smax, H, D, scale, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, pos, slopes, out, B, Smax, H, D, scale, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
