// Single-token decode attention over a KV cache, split across CTAs, for
// Hopper (sm_90a).
//
// Replaces deepspeed_tpu/ops/pallas/decode_attention.py::_decode_kernel (:54,
// pallas_call :170).
//
//   out[b,h,:] = sum_k softmax_k(q[b,h]·k[b,k,h]·scale + slope_h·(k − pos[b])) · v[b,k,h,:]
//   over keys k in [0, pos[b]], fp32 accumulation, output in the input dtype.
//
// Layouts (all contiguous): q [B,H,D], k/v [B,Smax,H,D], pos [B] int32,
// slopes [H] fp32 or null (no ALiBi), out [B,H,D]. D <= 256, dtype fp32 or
// bf16. A position past Smax − 1 is clamped to it; a negative position reads
// nothing and writes zeros.
//
// What bounds it: HBM bytes. Each (b,h) reads (pos[b]+1)·D keys and values
// once and does 4·D flops per key, about one flop per byte in bf16, far
// below the card's ~295 flops/byte ridge. So the design aims to keep enough
// bytes in flight to fill the card, read the live prefix once with 16-byte
// loads, and read nothing past it:
//   * split-KV: split s of (b,h) covers keys [s·SPLIT_KEYS, (s+1)·SPLIT_KEYS),
//     one CTA each. The number of splits, ceil(Smax / SPLIT_KEYS), comes from
//     the cache length on the host and never from pos, so the grid does not
//     depend on a position and a decode step stays capturable as a CUDA
//     graph. A CTA reads pos[b] itself; if its split starts past pos[b] it
//     writes an empty partial (m = NEG_INF, l = 0) and returns. At the
//     serving shape (B = 8, H = 12, Smax = 1024) that is 768 CTAs on 132 SMs
//     where one CTA per (b,h) gave 96;
//   * G lanes share a key row, each loading 16 bytes (8 bf16 or 4 fp32): at
//     D = 64 in bf16, 8 lanes a row and 16 rows per pass of 128 threads;
//     q·k reduces over the G lanes by shuffles;
//   * a chunk's K and V rows (the whole 128-key split at D = 64 in bf16: 32 KB
//     a CTA) are loaded into registers before any math;
//   * each group of G lanes keeps an online softmax over its rows; the groups
//     merge in shared memory into one partial per split (m, l, acc[D] in
//     fp32, unnormalised) in a scratch [B, H, splits, D + 2] the wrapper
//     allocates;
//   * a second kernel merges the live splits of each (b,h) in split order,
//     so the result is deterministic, and normalises. It is launched as a
//     programmatic dependent of the first (griddepcontrol), so its launch
//     overlaps the split kernel's run; measured on an H100 that took ~1.5 µs
//     off the pair's 25 µs.
// A row that is not a multiple of 16 bytes (or a cache base that is not
// 16-byte aligned) takes a per-element load path, which the wrapper chooses
// from D and the bases.
//
// Plain C interface, loaded with ctypes. One call launches both kernels on
// the caller's stream, allocates nothing, does not synchronise, and returns
// the first launch error (cudaErrorInvalidValue for arguments it does not
// take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int SPLIT_KEYS = 128;  // keys per split (the wrapper's SPLIT_KEYS)
constexpr int SPLIT_THREADS = 128;
constexpr int COMBINE_THREADS = 128;
constexpr int MAX_D = 256;
constexpr int MAX_SPLITS = 4096;  // the combine's shared memory: 8 bytes a split
// Finite "minus infinity", as in the TPU kernel: exp(NEG_INF - m) is 0 for
// any real score m, and no inf - inf NaN can arise.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// W consecutive elements of T as loaded by one instruction: 16 bytes kept raw
// (W = 16 / sizeof(T)), or one element converted to fp32 (W = 1).
template <int W>
using Raw = typename std::conditional<W == 1, float, uint4>::type;

template <typename T, int W>
__device__ __forceinline__ Raw<W> load(const T* ptr, bool ok) {
  if constexpr (W == 1) {
    return ok ? to_float(*ptr) : 0.0f;
  } else {
    return ok ? *reinterpret_cast<const uint4*>(ptr) : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ float2 bf16x2(uint32_t u) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(h);
}

template <typename T, int W>
__device__ __forceinline__ void unpack(const Raw<W>& r, float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = r;
  } else if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  } else {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = bf16x2(u[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

// One split of one (b,h): G lanes per key row, lane g of its group holding
// elements (j·G + g)·W + [0, W) for j < NV.
template <typename T, int W, int G, int NV>
__global__ void __launch_bounds__(SPLIT_THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ pos, const float* __restrict__ slopes, float* __restrict__ part,
                    int Smax, int H, int D, int splits, float scale) {
  constexpr int E = NV * W;                      // elements of a row per lane
  constexpr int GROUPS = SPLIT_THREADS / G;      // rows per pass
  constexpr int PASSES = SPLIT_KEYS / GROUPS;
  constexpr int REGS = NV * static_cast<int>(sizeof(Raw<W>)) / 4;  // registers per loaded row
  constexpr int DEPTH = PASSES < 32 / REGS ? PASSES : 32 / REGS;   // rows loaded before any math
  static_assert(SPLIT_KEYS % GROUPS == 0 && PASSES % DEPTH == 0, "passes split into whole chunks");
  __shared__ float m_s[GROUPS], l_s[GROUPS], w_s[GROUPS];
  __shared__ float acc_s[GROUPS][G * E];

  // The combine may launch once every CTA of this grid has started; it waits
  // for this grid's writes before it reads them.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = threadIdx.x % G, grp = threadIdx.x / G;
  const int p = min(pos[b], Smax - 1);
  const int k0 = split * SPLIT_KEYS;
  float* out = part + ((static_cast<size_t>(b) * H + h) * splits + split) * (D + 2);
  if (k0 > p) {  // the split starts past the position: nothing to read
    if (threadIdx.x == 0) {
      out[0] = NEG_INF;
      out[1] = 0.0f;
    }
    return;
  }
  const int k_last = min(p, k0 + SPLIT_KEYS - 1);
  const float slope = slopes != nullptr ? slopes[h] : 0.0f;
  const size_t row_stride = static_cast<size_t>(H) * D;
  const size_t head_off = (static_cast<size_t>(b) * Smax * H + h) * D;
  const T* kb = k + head_off;
  const T* vb = v + head_off;
  const T* qb = q + (static_cast<size_t>(b) * H + h) * D;

  float qr[E], acc[E];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int e = (j * G + g) * W + w;
      qr[j * W + w] = e < D ? to_float(qb[e]) : 0.0f;
      acc[j * W + w] = 0.0f;
    }
  }
  float m = NEG_INF, l = 0.0f;

  for (int c = 0; c < PASSES; c += DEPTH) {
    if (k0 + c * GROUPS > k_last) break;  // the same for every thread of the CTA
    Raw<W> kr[DEPTH][NV], vr[DEPTH][NV];
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      const int key = k0 + (c + i) * GROUPS + grp;
      const bool live = key <= k_last;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e = (j * G + g) * W;
        const size_t off = static_cast<size_t>(key) * row_stride + e;
        kr[i][j] = load<T, W>(kb + off, live && e < D);
        vr[i][j] = load<T, W>(vb + off, live && e < D);
      }
    }
    float sc[DEPTH];
    float m_new = m;
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float kf[W];
        unpack<T, W>(kr[i][j], kf);
#pragma unroll
        for (int w = 0; w < W; ++w) dot = fmaf(qr[j * W + w], kf[w], dot);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int key = k0 + (c + i) * GROUPS + grp;
      sc[i] = key <= k_last ? dot * scale + slope * static_cast<float>(key - p) : NEG_INF;
      m_new = fmaxf(m_new, sc[i]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      const int key = k0 + (c + i) * GROUPS + grp;
      const float pi = key <= k_last ? expf(sc[i] - m_new) : 0.0f;
      l += pi;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float vf[W];
        unpack<T, W>(vr[i][j], vf);
#pragma unroll
        for (int w = 0; w < W; ++w) acc[j * W + w] = fmaf(pi, vf[w], acc[j * W + w]);
      }
    }
    m = m_new;
  }

  // Merge the groups' softmax states into the split's partial.
  if (g == 0) {
    m_s[grp] = m;
    l_s[grp] = l;
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int w = 0; w < W; ++w) acc_s[grp][(j * G + g) * W + w] = acc[j * W + w];
  }
  __syncthreads();
  if (threadIdx.x < GROUPS) {
    float m_all = NEG_INF;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) m_all = fmaxf(m_all, m_s[i]);
    w_s[threadIdx.x] = expf(m_s[threadIdx.x] - m_all);
    if (threadIdx.x == 0) out[0] = m_all;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l_all = 0.0f;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) l_all += l_s[i] * w_s[i];
    out[1] = l_all;
  }
  for (int d = threadIdx.x; d < D; d += SPLIT_THREADS) {
    float a = 0.0f;
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) a += acc_s[i][d] * w_s[i];
    out[2 + d] = a;
  }
}

// The live splits of one (b,h), merged in split order, normalised. Each
// split's m and l go to shared memory in one parallel pass, then its weight
// exp(m − m_all); each output element sums the splits' acc in order.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_combine_kernel(const float* __restrict__ part, const int* __restrict__ pos, T* __restrict__ out,
                      int Smax, int H, int D, int splits) {
  extern __shared__ float ml_s[];  // [splits] m, then its weight; [splits] l
  float* w_s = ml_s;
  float* l_s = ml_s + splits;
  // Launched as a programmatic dependent of the split kernel: it may start
  // before that grid ends, and waits here until the grid's writes are visible.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y;
  const int p = min(pos[b], Smax - 1);
  const int live = p < 0 ? 0 : p / SPLIT_KEYS + 1;  // the splits the first kernel filled
  const float* pb = part + (static_cast<size_t>(b) * H + h) * splits * (D + 2);
  for (int s = threadIdx.x; s < live; s += COMBINE_THREADS) {
    w_s[s] = pb[s * (D + 2)];
    l_s[s] = pb[s * (D + 2) + 1];
  }
  __syncthreads();
  float m_all = NEG_INF;
  for (int s = 0; s < live; ++s) m_all = fmaxf(m_all, w_s[s]);
  __syncthreads();  // every thread has its m_all before the weights overwrite the m's
  for (int s = threadIdx.x; s < live; s += COMBINE_THREADS) w_s[s] = expf(w_s[s] - m_all);
  __syncthreads();
  float l_all = 0.0f;
  for (int s = 0; s < live; ++s) l_all += l_s[s] * w_s[s];
  const float inv_l = l_all > 0.0f ? 1.0f / l_all : 0.0f;
  T* ob = out + (static_cast<size_t>(b) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += COMBINE_THREADS) {
    float o = 0.0f;
#pragma unroll 8
    for (int s = 0; s < live; ++s) o += pb[s * (D + 2) + 2 + d] * w_s[s];
    store(ob + d, o * inv_l);
  }
}

struct SplitArgs {
  const void *q, *k, *v, *pos, *slopes;
  void* part;
  int B, Smax, H, D, splits;
  float scale;
};

template <typename T, int W, int G, int NV>
void run_split(const SplitArgs& a, cudaStream_t stream) {
  decode_split_kernel<T, W, G, NV><<<dim3(a.splits, a.H, a.B), SPLIT_THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.pos), static_cast<const float*>(a.slopes), static_cast<float*>(a.part), a.Smax,
      a.H, a.D, a.splits, a.scale);
}

// vec: 16-byte loads of each row (the caller checked D and the bases); else
// one element a lane at a time, 32 lanes a row.
template <typename T>
void launch_split(const SplitArgs& a, bool vec, cudaStream_t stream) {
  constexpr int W = 16 / sizeof(T);
  if (vec) {
    const int vpr = (a.D + W - 1) / W;  // 16-byte loads per row
    if (vpr <= 4) {
      run_split<T, W, 4, 1>(a, stream);
    } else if (vpr <= 8) {
      run_split<T, W, 8, 1>(a, stream);
    } else if (vpr <= 16) {
      run_split<T, W, 16, 1>(a, stream);
    } else if (vpr <= 32) {
      run_split<T, W, 32, 1>(a, stream);
    } else if constexpr (W == 4) {  // fp32 rows of 129..256 elements; bf16 rows never pass 32 loads
      run_split<T, W, 32, 2>(a, stream);
    }
  } else if (a.D <= 32) {
    run_split<T, 1, 32, 1>(a, stream);
  } else if (a.D <= 64) {
    run_split<T, 1, 32, 2>(a, stream);
  } else if (a.D <= 128) {
    run_split<T, 1, 32, 4>(a, stream);
  } else {
    run_split<T, 1, 32, 8>(a, stream);
  }
}

bool valid(int B, int Smax, int H, int D, int splits) {
  return D >= 1 && D <= MAX_D && B >= 1 && B <= 65535 && H >= 1 && H <= 65535 && Smax >= 1 &&
         splits == (Smax + SPLIT_KEYS - 1) / SPLIT_KEYS && splits <= MAX_SPLITS;
}

// The combine as a programmatic dependent launch: its launch overlaps the
// split kernel's run instead of following its end.
template <typename T>
int launch_combine(const float* part, const int* pos, T* out, int B, int Smax, int H, int D, int splits,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B);
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.dynamicSmemBytes = 2 * splits * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, part, pos, out, Smax, H, D, splits));
}

}  // namespace

// Both kernels: the split kernel writes partials [B, H, splits, D + 2] fp32
// (m, l, acc[D]) of every split that starts at or before pos[b] into
// ``partials``; the combine writes out [B, H, D] in the input dtype. dtype:
// 0 = float32, 1 = bfloat16. splits must be ceil(Smax / SPLIT_KEYS); vec asks
// for 16-byte loads, which need D·sizeof(T) and the k/v bases to be
// multiples of 16 bytes. The caller has checked shapes, dtypes and
// contiguity.
extern "C" int dstt_decode_attention(const void* q, const void* k, const void* v, const void* pos,
                                     const void* slopes, void* partials, void* out, int B, int Smax, int H, int D,
                                     int splits, int vec, int dtype, float scale, void* stream) {
  if (!valid(B, Smax, H, D, splits) || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const int elt = dtype == 0 ? 4 : 2;
  if (vec && ((D * elt) % 16 != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(v) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SplitArgs a{q, k, v, pos, slopes, partials, B, Smax, H, D, splits, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_split<float>(a, vec != 0, s);
  } else {
    launch_split<bf16>(a, vec != 0, s);
  }
  const int e = static_cast<int>(cudaGetLastError());
  if (e != 0) return e;
  const float* part = static_cast<const float*>(partials);
  const int* pt = static_cast<const int*>(pos);
  if (dtype == 0) return launch_combine<float>(part, pt, static_cast<float*>(out), B, Smax, H, D, splits, s);
  return launch_combine<bf16>(part, pt, static_cast<bf16*>(out), B, Smax, H, D, splits, s);
}
