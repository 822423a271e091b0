// Flash decode: one new query token against a KV-major cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention_pallas (_decode_kernel).  It computes what that kernel
// computes: for batch row b and kv head n, the G = H / KV query heads
// n G .. n G + G - 1 of q (B, 1, H, hd) attend to the first kv_len[b] rows
// of k and v; q multiplied by hd^-1/2 after its cast to f32, an f32 online
// softmax, out = acc / max(l, 1e-30) in q's dtype, so kv_len = 0 gives zeros.
// The cache is read in the layout the LM keeps, KV-major (B, KV, S, hd), so
// the decode path never transposes it; the TPU wrapper transposed a
// (B, S, KV, hd) cache into that layout before its launch.
//
// Design.  On the TPU the kv axis is a sequential grid dimension whose
// blocks past kv_len are skipped and whose state sits in VMEM.  Here one CTA
// per (kv head, batch row) holds the G query rows in shared memory and walks
// the live rows only, 256 keys at a time: each thread scores one key against
// the G rows (one pass over its K row), the G rows' online softmax runs one
// warp per row, and P.V runs with each warp reading whole V rows (4
// consecutive values a thread) and keeping G x 4 sums in registers.  The
// warps' partial sums meet in shared memory at the end.  Every K and V byte
// of the live rows is read once.  G is at most 16 (kMaxG).
//
// Bound on the H100.  Bytes: at the full-width decode shape (4, 1, 16, 128)
// q against a (4, 8, 2080, 128) bf16 cache at kv_len 2048, the kernel must
// read 33.5 MB of K and V, 0.010 ms at 3.35 TB/s; it does 4 flops per cached
// value.  B x KV = 32 CTAs leave 100 of the 132 SMs idle, and one SM cannot
// keep enough loads in flight to draw its share of the card's bandwidth.
// Splitting the kv rows of one (b, n) across CTAs, with a second pass that
// combines their (m, l, acc), is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads;            // keys scored per pass, one a thread
constexpr int kMaxG = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Shared memory, in floats: the G scaled query rows, then a region that
// holds the G x kChunk scores during the walk and the warps' partial sums
// (kParts x G x HD) at the end, then m, l and the correction of each row.
template <int HD>
__host__ __device__ constexpr int kParts() { return kThreads / (HD / 4); }

template <int HD>
int smem_bytes(int G) {
  const int region = G * kChunk > kParts<HD>() * G * HD ? G * kChunk : kParts<HD>() * G * HD;
  return static_cast<int>(sizeof(float)) * (G * HD + region + 3 * kMaxG);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kv_len,
                        T* __restrict__ o, int H, int KV, int S, float sm_scale) {
  constexpr int kVec = HD / 4;              // float4 groups per row
  constexpr int kP = kParts<HD>();          // threads sharing one column group
  const int G = H / KV;
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int len = min(kv_len[b], S);       // rows past the cache are never read

  extern __shared__ float smem[];
  float* qs = smem;                         // [G][HD], times sm_scale
  float* region = qs + G * HD;              // scores [G][kChunk]; partials [kP][G][HD]
  float* m_run = region + (G * kChunk > kP * G * HD ? G * kChunk : kP * G * HD);
  float* l_run = m_run + kMaxG;
  float* corr = l_run + kMaxG;

  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(n) * G) * HD;
  for (int idx = threadIdx.x; idx < G * kVec; idx += kThreads) {
    float4 x = load4(qb + idx * 4);
    x.x *= sm_scale; x.y *= sm_scale; x.z *= sm_scale; x.w *= sm_scale;
    store4(qs + idx * 4, x);
  }
  if (threadIdx.x < G) {
    m_run[threadIdx.x] = kNegInf;
    l_run[threadIdx.x] = 0.f;
  }
  const size_t head = (static_cast<size_t>(b) * KV + n) * S * HD;
  const T* kb = k + head;
  const T* vb = v + head;

  const int c4 = (threadIdx.x % kVec) * 4;  // this thread's columns in P.V
  const int part = threadIdx.x / kVec;      // and its share of the keys
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[kMaxG][4];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  __syncthreads();

  for (int j0 = 0; j0 < len; j0 += kChunk) {
    const int cl = min(kChunk, len - j0);
    // scores: one key a thread, against every query row of the group
    {
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
      if (threadIdx.x < cl) {
        const T* kr = kb + static_cast<size_t>(j0 + threadIdx.x) * HD;
#pragma unroll 8
        for (int d = 0; d < HD; d += 4) {
          const float4 kk = load4(kr + d);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float4 qq = load4(qs + g * HD + d);
              s[g] = fmaf(qq.x, kk.x, s[g]);
              s[g] = fmaf(qq.y, kk.y, s[g]);
              s[g] = fmaf(qq.z, kk.z, s[g]);
              s[g] = fmaf(qq.w, kk.w, s[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) region[g * kChunk + threadIdx.x] = threadIdx.x < cl ? s[g] : kNegInf;
    }
    __syncthreads();
    // online softmax, one warp per query row
    for (int g = warp; g < G; g += kThreads / 32) {
      float* sr = region + g * kChunk;
      float mx = kNegInf;
      for (int j = lane; j < kChunk; j += 32) mx = fmaxf(mx, sr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[g], mx);
      float sum = 0.f;
      for (int j = lane; j < kChunk; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float c = expf(m_run[g] - m_new);
        corr[g] = c;
        l_run[g] = l_run[g] * c + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
    // P.V: each part of the threads takes every kP-th key of the chunk
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float c = corr[g];
        acc[g][0] *= c; acc[g][1] *= c; acc[g][2] *= c; acc[g][3] *= c;
      }
    }
#pragma unroll 4
    for (int j = part; j < cl; j += kP) {
      const float4 vv = load4(vb + static_cast<size_t>(j0 + j) * HD + c4);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float p = region[g * kChunk + j];
          acc[g][0] = fmaf(p, vv.x, acc[g][0]);
          acc[g][1] = fmaf(p, vv.y, acc[g][1]);
          acc[g][2] = fmaf(p, vv.z, acc[g][2]);
          acc[g][3] = fmaf(p, vv.w, acc[g][3]);
        }
      }
    }
    __syncthreads();                        // the scores are consumed
  }

  // the parts' sums meet in shared memory; then acc / max(l, 1e-30)
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G)
      store4(region + (part * G + g) * HD + c4,
             make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]));
  __syncthreads();
  T* ob = o + (static_cast<size_t>(b) * H + static_cast<size_t>(n) * G) * HD;
  for (int idx = threadIdx.x; idx < G * kVec; idx += kThreads) {
    const int g = idx / kVec;
    const int c = (idx % kVec) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < kP; ++p) {
      const float4 x = load4(region + (p * G + g) * HD + c);
      t.x += x.x; t.y += x.y; t.z += x.z; t.w += x.w;
    }
    const float denom = fmaxf(l_run[g], 1e-30f);
    store4(ob + g * HD + c, make_float4(t.x / denom, t.y / denom, t.z / denom, t.w / denom));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* o,
           int B, int S, int H, int KV, float sm_scale, cudaStream_t stream) {
  const int bytes = smem_bytes<HD>(H / KV);
  auto kernel = decode_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(KV, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(o), H, KV, S, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* kv_len,
                void* o, int B, int S, int H, int KV, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, kv_len, o, B, S, H, KV, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, kv_len, o, B, S, H, KV, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, kv_len, o, B, S, H, KV, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, kv_len, o, B, S, H, KV, sm_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, 1, H, hd), k and v (B, KV, S, hd) KV-major, kv_len (B,) int32
// (clamped to S; 0 or less gives zeros), o (B, 1, H, hd); contiguous, 16-byte aligned, q, k, v
// and o of one dtype: 0 = f32, 1 = bf16.  hd is 16, 32, 64 or 128; H is a
// multiple of KV with H / KV <= 16; B and KV are at least 1.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, int B, int S, int H,
                                    int KV, int hd, int dtype, float sm_scale,
                                    void* cuda_stream) {
  cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (H % KV != 0 || H / KV > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, kv_len, o, B, S, H, KV, sm_scale, stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, kv_len, o, B, S, H, KV, sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
