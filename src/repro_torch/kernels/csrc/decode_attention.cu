// Flash decode: one new query token against a KV-major cache, for Hopper
// (sm_90a), as split-KV with a combine pass.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention_pallas (_decode_kernel).  It computes what that kernel
// computes: for batch row b and kv head n, the G = H / KV query heads
// n G .. n G + G - 1 of q (B, 1, H, hd) attend to the first kv_len[b] rows
// of k and v; q multiplied by hd^-1/2 after its cast to f32, an f32 softmax,
// out = acc / max(l, 1e-30) in q's dtype, so kv_len = 0 gives zeros.  The
// cache is read in the layout the LM keeps, KV-major (B, KV, S, hd), so the
// decode path never transposes it; the TPU wrapper transposed a
// (B, S, KV, hd) cache into that layout before its launch.  A logit
// soft-cap c > 0 (the Pallas kernel has none) replaces each scaled score s
// by tanh(s / c) c in pass 1, with tanhf and a true division, as the JAX
// package's cache_attention does; the launch picks an instantiation by
// c != 0, so c = 0 runs the uncapped body, bitwise the kernel without a cap.
// The combine pass does not see it.
//
// Design.  On the TPU the kv axis is a sequential grid dimension whose
// blocks past kv_len are skipped and whose state sits in VMEM.  Here the
// cache rows are cut into chunks and each chunk gets a CTA of its own:
//   - Pass 1, grid (n_splits, KV, B), n_splits = ceil(S / chunk).  The grid
//     follows the cache's capacity S, a shape, and never the values of
//     kv_len, which the CTA reads on the device: the host reads nothing, so
//     a decode step can be captured in a CUDA graph.  A CTA walks the live
//     rows of its chunk only, 16 bytes a lane (hd / 8 lanes a bf16 row, hd / 4
//     a f32 row), scores them against the G query rows (held in registers,
//     scaled), runs the softmax of each row over the chunk, accumulates P.V
//     with the same lanes, and writes an f32 partial (m, l, acc[hd]) per
//     query head into a scratch tensor the wrapper allocated.  A chunk that
//     starts at or past kv_len[b] writes m = -1e30, l = 0, acc = 0 and exits
//     (-1e30, not -inf, so the combine never computes exp(-inf + inf)).
//   - Pass 2, one CTA per (query head, batch row), hd threads: m* = max m_i,
//     l = sum l_i e^(m_i - m*), out = sum acc_i e^(m_i - m*) / max(l, 1e-30),
//     the splits taken in a fixed order.  No atomics anywhere: two launches
//     on the same inputs give the same bits.
//   Both passes run from the one C entry point on the caller's stream.  G is
//   at most 16 (kMaxG); the kernel is instantiated for G up to 2, 4, 8, 16.
//
// Partial mode (decode_attention_lse_fwd), for a cache cut on its rows over
// several ranks (flash decode across ranks): the same pass 1, and a combine
// that writes out in f32, not rounded to q's dtype, and the log-sum-exp of
// the row's scores, lse = m* + log l, from the same partials.  A row whose
// kv_len is 0 (a rank whose rows hold no live key yet) has l = 0 and gets
// out = 0, lse = -inf.  The caller merges the ranks' (out, lse) with weights
// e^(lse_r - max lse) and rounds once.  The default mode's kernels and
// arithmetic are untouched by it.
//
// Bound on the H100.  Bytes: at the full-width decode shape (4, 1, 16, 128)
// q against a (4, 8, 2080, 128) bf16 cache at kv_len 2048, the kernel must
// read 33.5 MB of K and V, 0.010 ms at 3.35 TB/s; it does 4 flops per cached
// value.  With chunks of 128 rows there are 17 splits x 32 (b, n) = 544
// CTAs, 4 a SM, each reading 64 KB.  What still holds it back: two launches
// and the combine's read of the partials (0.6 MB), a fixed cost of a few
// microseconds next to a 10 us bound; the scores, the softmax and P.V of a
// chunk run one after the other inside the CTA, so its loads come in two
// bursts; a cache of 33.5 MB fits in the 50 MB L2, so back-to-back timings
// read it from L2 and a decode step, which reads every layer's cache in
// turn, finds it cold.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;                  // rows a lane loads before it computes
constexpr int kMaxG = 16;
constexpr float kNegInf = -1e30f;

// 16 bytes of a row as f32
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Shared memory of pass 1, in floats: the scores (then p) [G][chunk], the
// warps' P.V sums [kWarps][G][hd], and m, l of each query row.
int partial_smem_bytes(int G, int hd, int chunk) {
  return static_cast<int>(sizeof(float)) * (G * chunk + kWarps * G * hd + 2 * kMaxG);
}

// part[((b H + h) n_splits + split) (hd + 2) + {0: m, 1: l, 2 + d: acc[d]}]
template <typename T, int HD, int GM, bool kCap>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ kv_len,
                      float* __restrict__ part, int H, int KV, int S, int chunk,
                      float softcap, float sm_scale) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a lane loads
  constexpr int L = HD / E;                 // lanes a cache row
  constexpr int R = 32 / L;                 // rows a warp takes at once
  constexpr int kStep = kWarps * R;         // rows the CTA takes at once
  const int G = H / KV;
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(kv_len[b], 0), S);  // rows past the cache are never read
  const int r0 = split * chunk;
  const int cl = min(chunk, len - r0);      // live rows of this chunk
  const int pstride = n_splits * (HD + 2);  // from one query head's partial to the next
  float* pb = part + (static_cast<size_t>(b) * H + static_cast<size_t>(n) * G) * pstride
              + static_cast<size_t>(split) * (HD + 2);

  if (cl <= 0) {
    for (int idx = threadIdx.x; idx < G * (HD + 2); idx += kThreads) {
      const int g = idx / (HD + 2);
      const int c = idx % (HD + 2);
      pb[g * pstride + c] = c == 0 ? kNegInf : 0.f;
    }
    return;
  }

  extern __shared__ float smem[];
  float* sc = smem;                         // [G][chunk]
  float* red = sc + G * chunk;              // [kWarps][G][HD]
  float* m_s = red + kWarps * G * HD;       // [kMaxG]
  float* l_s = m_s + kMaxG;                 // [kMaxG]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % L;                 // this lane's 16 bytes of a row
  const int rw = lane / L;                  // this lane's row of the warp's R

  float qr[GM][E];
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(n) * G) * HD + sub * E;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      load16(qb + g * HD, qr[g]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[g][e] *= sm_scale;
    }
  }
  const size_t head = (static_cast<size_t>(b) * KV + n) * S * HD
                      + static_cast<size_t>(r0) * HD + sub * E;
  const T* kb = k + head;
  const T* vb = v + head;

  // scores of the live rows; the row's L lanes reduce with shuffles
  for (int j0 = warp * R + rw; j0 - rw < cl; j0 += kUnroll * kStep) {
    float x[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kStep;
      if (j < cl) {
        load16(kb + static_cast<size_t>(j) * HD, x[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) x[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kStep;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) s = fmaf(qr[g][e], x[u][e], s);
#pragma unroll
          for (int off = L / 2; off > 0; off >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, off);
          if constexpr (kCap) s = tanhf(s / softcap) * softcap;
          if (sub == 0 && j < cl) sc[g * chunk + j] = s;
        }
      }
    }
  }
  __syncthreads();

  // the softmax of each query row over the chunk, one warp a row
  for (int g = warp; g < G; g += kWarps) {
    float* sr = sc + g * chunk;
    float mx = kNegInf;
    for (int j = lane; j < cl; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < cl; j += 32) {
      const float p = expf(sr[j] - mx);
      sr[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  __syncthreads();

  // P.V over the same rows, each lane keeping G x E sums of its columns
  float acc[GM][E];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  for (int j0 = warp * R + rw; j0 - rw < cl; j0 += kUnroll * kStep) {
    float x[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kStep;
      if (j < cl) {
        load16(vb + static_cast<size_t>(j) * HD, x[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) x[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * kStep;
      if (j < cl) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float p = sc[g * chunk + j];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, x[u][e], acc[g][e]);
          }
        }
      }
    }
  }
  // the warp's R rows meet over the lanes that share `sub`, then the warps
  // meet in shared memory in warp order
#pragma unroll
  for (int off = L; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (rw == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G)
#pragma unroll
        for (int e = 0; e < E; ++e) red[(warp * G + g) * HD + sub * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    const int d = idx % HD;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[(w * G + g) * HD + d];
    pb[g * pstride + 2 + d] = t;
  }
  if (threadIdx.x < G) {
    pb[threadIdx.x * pstride] = m_s[threadIdx.x];
    pb[threadIdx.x * pstride + 1] = l_s[threadIdx.x];
  }
}

// one CTA per (query head, batch row), one thread per output column; with
// kLse the output is f32 and the row's log-sum-exp goes to lse
template <typename TO, bool kLse>
__global__ void decode_combine_kernel(const float* __restrict__ part, TO* __restrict__ o,
                                      float* __restrict__ lse, int n_splits) {
  const int hd = blockDim.x;
  const int d = threadIdx.x;
  const float* pb = part + static_cast<size_t>(blockIdx.x) * n_splits * (hd + 2);
  float m_star = kNegInf;
  for (int i = 0; i < n_splits; ++i) m_star = fmaxf(m_star, pb[i * (hd + 2)]);
  float l = 0.f, acc = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const float* p = pb + i * (hd + 2);
    const float w = expf(p[0] - m_star);
    l += p[1] * w;
    acc += p[2 + d] * w;
  }
  store1(o + static_cast<size_t>(blockIdx.x) * hd + d, acc / fmaxf(l, 1e-30f));
  if constexpr (kLse) {
    if (d == 0) lse[blockIdx.x] = l > 0.f ? m_star + logf(l) : __int_as_float(0xff800000);  // -inf
  }
}

template <typename T, int HD, int GM>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* o,
           void* lse, void* part, int B, int S, int H, int KV, int chunk, int n_splits,
           float softcap, float sm_scale, cudaStream_t stream) {
  const int bytes = partial_smem_bytes(H / KV, HD, chunk);
  auto kernel = softcap != 0.f ? decode_partial_kernel<T, HD, GM, true>
                               : decode_partial_kernel<T, HD, GM, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_splits, KV, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<float*>(part), H, KV, S, chunk,
      softcap, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lse != nullptr)
    decode_combine_kernel<float, true><<<B * H, HD, 0, stream>>>(
        static_cast<const float*>(part), static_cast<float*>(o), static_cast<float*>(lse),
        n_splits);
  else
    decode_combine_kernel<T, false><<<B * H, HD, 0, stream>>>(
        static_cast<const float*>(part), static_cast<T*>(o), nullptr, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_g(const void* q, const void* k, const void* v, const void* kv_len, void* o,
               void* lse, void* part, int B, int S, int H, int KV, int chunk, int n_splits,
               float softcap, float sm_scale, cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 2)
    return launch<T, HD, 2>(q, k, v, kv_len, o, lse, part, B, S, H, KV, chunk, n_splits,
                                softcap, sm_scale, stream);
  if (G <= 4)
    return launch<T, HD, 4>(q, k, v, kv_len, o, lse, part, B, S, H, KV, chunk, n_splits,
                                softcap, sm_scale, stream);
  if (G <= 8)
    return launch<T, HD, 8>(q, k, v, kv_len, o, lse, part, B, S, H, KV, chunk, n_splits,
                                softcap, sm_scale, stream);
  return launch<T, HD, 16>(q, k, v, kv_len, o, lse, part, B, S, H, KV, chunk, n_splits,
                                softcap, sm_scale, stream);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* kv_len,
                void* o, void* lse, void* part, int B, int S, int H, int KV, int chunk, int n_splits,
                float softcap, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(q, k, v, kv_len, o, lse, part, B, S, H, KV, chunk,
                                          n_splits, softcap, sm_scale, stream);
    case 32: return dispatch_g<T, 32>(q, k, v, kv_len, o, lse, part, B, S, H, KV, chunk,
                                          n_splits, softcap, sm_scale, stream);
    case 64: return dispatch_g<T, 64>(q, k, v, kv_len, o, lse, part, B, S, H, KV, chunk,
                                          n_splits, softcap, sm_scale, stream);
    case 128: return dispatch_g<T, 128>(q, k, v, kv_len, o, lse, part, B, S, H, KV, chunk,
                                          n_splits, softcap, sm_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

namespace {

int entry(const void* q, const void* k, const void* v, const void* kv_len, void* o, void* lse,
          void* part, int B, int S, int H, int KV, int hd, int chunk, int n_splits, int dtype,
          float sm_scale, float softcap, void* cuda_stream) {
  cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (H % KV != 0 || H / KV > kMaxG || chunk < 1 || n_splits < 1 || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, kv_len, o, lse, part, B, S, H, KV, chunk, n_splits,
                              softcap, sm_scale, stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, kv_len, o, lse, part, B, S, H, KV, chunk,
                                      n_splits, softcap, sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, 1, H, hd), k and v (B, KV, S, hd) KV-major, kv_len (B,) int32 on the
// device (clamped to [0, S]; 0 gives zeros), o (B, 1, H, hd), part: scratch
// of B H n_splits (hd + 2) f32; contiguous, 16-byte aligned, q, k, v and o of
// one dtype: 0 = f32, 1 = bf16.  hd is 16, 32, 64 or 128; H is a multiple of
// KV with H / KV <= 16; B and KV are at least 1; chunk >= 1 and n_splits =
// max(1, ceil(S / chunk)); softcap 0 (no cap) or the logit soft-cap c > 0.
// Launches pass 1 and the combine; returns the first cudaError_t (0 =
// success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, void* part, int B,
                                    int S, int H, int KV, int hd, int chunk,
                                    int n_splits, int dtype, float sm_scale,
                                    float softcap, void* cuda_stream) {
  return entry(q, k, v, kv_len, o, nullptr, part, B, S, H, KV, hd, chunk, n_splits, dtype,
               sm_scale, softcap, cuda_stream);
}

// The partial mode: as decode_attention_fwd, but o (B, 1, H, hd) is f32
// whatever q's dtype, and lse (B, H) f32 gets each row's log-sum-exp (-inf
// where kv_len is 0, with o = 0).
extern "C" int decode_attention_lse_fwd(const void* q, const void* k, const void* v,
                                        const void* kv_len, void* o, void* lse, void* part,
                                        int B, int S, int H, int KV, int hd, int chunk,
                                        int n_splits, int dtype, float sm_scale,
                                        float softcap, void* cuda_stream) {
  return entry(q, k, v, kv_len, o, lse, part, B, S, H, KV, hd, chunk, n_splits, dtype,
               sm_scale, softcap, cuda_stream);
}
