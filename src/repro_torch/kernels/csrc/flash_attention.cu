// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention_pallas (_flash_kernel).  It computes what that kernel
// computes: q (B, Sq, H, hd) against k, v (B, Skv, KV, hd), q head h reading
// kv head h / (H / KV) with no kv replicated; q aligned to the end of kv
// (query row i sits at position i + Skv - Sq); scores above the diagonal and
// kv rows past Skv set to -1e30; an f32 online softmax; out = acc / max(l,
// 1e-30) in q's dtype.  Inputs are bf16 or f32 and every operation inside is
// f32, with q multiplied by hd^-1/2 after its cast to f32, as the reference.
//
// Design.  On the TPU the kv axis is a sequential grid dimension that carries
// (m, l, acc) in VMEM from one step to the next.  Here it is a loop inside
// one CTA: one CTA per (q tile of 64 rows, head, batch row) walks the kv
// tiles of 64 up to the causal diagonal, so the state never leaves the SM.
// 256 threads in a 16 x 16 grid; thread (ty, tx) owns query rows ty + 16 i
// (i < 4), the scores of kv columns tx + 16 j (j < 4) and the output
// columns 4 tx + 64 g (hd >= 64; tx + 16 c below), so a row's max and sum
// reduce over the 16 lanes that share ty with four shuffles and the row
// statistics stay in registers.  Q (pre-scaled), K and V tiles sit in shared
// memory as f32 in rows padded by 4 floats (conflict-free float4 reads); P
// reuses the K tile's space.  Work is heaviest for the last q tiles, so
// blockIdx.x runs them first.
//
// Bound on the H100.  At the full-width prefill shape (4, 2048, 16, 128) q
// against (4, 2048, 8, 128) k and v in bf16, one call is 68.7 GFLOP with the
// causal half skipped and moves 100.7 MB: 0.069 ms at 989 TFLOP/s on the
// tensor cores, 0.030 ms at 3.35 TB/s, so operations bound it.  This kernel
// does its products on the CUDA cores in f32 (67 TFLOP/s at most, so at
// least 1.0 ms a call): Q.K^T of bf16 inputs would be exact on the tensor
// cores (mma.sync, f32 accumulation), but P.V there would round P to bf16,
// which the reference does not do, and f32 inputs need f32 products.  Moving
// Q.K^T (and, with a tolerance argued for, P.V) to wgmma/mma.sync, with
// cp.async or TMA double buffering of the kv tiles, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 256;
constexpr int kLdP = kBlockKV + 4;          // padded row of P in shared memory
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

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int HD>
constexpr int smem_floats() {
  // Q, V and the larger of K and P
  return 2 * kBlockQ * (HD + 4)
         + (kBlockKV * (HD + 4) > kBlockQ * kLdP ? kBlockKV * (HD + 4) : kBlockQ * kLdP);
}

// Copy rows [r0, r0 + 64) of one head of x (row stride `stride` elements)
// into dst as f32 times `scale`, zeros past `n_rows`.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* x, int r0, int n_rows,
                                          size_t stride, float scale) {
  constexpr int kLd = HD + 4;
  constexpr int kVec = HD / 4;
  for (int idx = threadIdx.x; idx < kBlockQ * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) {
      v = load4(x + static_cast<size_t>(r0 + r) * stride + c);
      v.x *= scale; v.y *= scale; v.z *= scale; v.w *= scale;
    }
    store4(dst + r * kLd + c, v);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                       int H, int KV, int causal, float sm_scale) {
  constexpr int kLd = HD + 4;
  constexpr int kCols = HD / 16;            // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                         // [kBlockQ][kLd], times sm_scale
  float* Vs = Qs + kBlockQ * kLd;           // [kBlockKV][kLd]
  float* Ks = Vs + kBlockKV * kLd;          // [kBlockKV][kLd], then P [kBlockQ][kLdP]
  float* Ps = Ks;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qi * kBlockQ;
  const int offset = Skv - Sq;

  const T* qb = q + (static_cast<size_t>(b) * Sq * H + h) * HD;
  const T* kb = k + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;
  load_tile<T, HD>(Qs, qb, q0, Sq, static_cast<size_t>(H) * HD, sm_scale);

  // the last kv row any query of this tile may see
  const int kv_end = causal ? min(Skv, min(q0 + kBlockQ, Sq) + offset) : Skv;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < kv_end; j0 += kBlockKV) {
    __syncthreads();                        // the last tile's P and V are consumed
    load_tile<T, HD>(Ks, kb, j0, Skv, static_cast<size_t>(KV) * HD, 1.f);
    load_tile<T, HD>(Vs, vb, j0, Skv, static_cast<size_t>(KV) * HD, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = load4(Ks + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qq = load4(Qs + (ty + 16 * i) * kLd + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qq.x, kk[j].x, s[i][j]);
          s[i][j] = fmaf(qq.y, kk[j].y, s[i][j]);
          s[i][j] = fmaf(qq.z, kk[j].z, s[i][j]);
          s[i][j] = fmaf(qq.w, kk[j].w, s[i][j]);
        }
      }
    }

    // mask, then the online softmax of each row over its 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i + offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = j0 + tx + 16 * j;
        if (k_pos >= Skv || (causal && k_pos > q_pos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }

    __syncthreads();                        // every thread is done with K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = s[i][j];
    __syncthreads();

#pragma unroll 2
    for (int jj = 0; jj < kBlockKV; jj += 4) {
      float4 pp[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pp[i] = load4(Ps + (ty + 16 * i) * kLdP + jj);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = Vs + (jj + u) * kLd;
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = u == 0 ? pp[i].x : u == 1 ? pp[i].y : u == 2 ? pp[i].z : pp[i].w;
        if constexpr (HD >= 64) {
#pragma unroll
          for (int g = 0; g < kCols / 4; ++g) {
            const float4 vv = load4(vr + 4 * tx + 64 * g);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][4 * g + 0] = fmaf(p[i], vv.x, acc[i][4 * g + 0]);
              acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
            }
          }
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float vv = vr[tx + 16 * c];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<size_t>(b) * Sq + row) * H + h) * HD;
    if constexpr (HD >= 64) {
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g)
        store4(orow + 4 * tx + 64 * g,
               make_float4(acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
                           acc[i][4 * g + 2] / denom, acc[i][4 * g + 3] / denom));
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) store1(orow + tx + 16 * c, acc[i][c] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int KV, int causal, float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, KV, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B,
                int Sq, int Skv, int H, int KV, int causal, float sm_scale,
                cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, Sq, Skv, H, KV, causal, sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, causal, sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, causal, sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, causal, sm_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, KV, hd), o (B, Sq, H, hd), all
// contiguous, 16-byte aligned, of one dtype: 0 = f32, 1 = bf16.  hd is 16,
// 32, 64 or 128; H is a multiple of KV; with causal, Sq <= Skv.  B, Sq and
// Skv are at least 1.  Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Skv, int H, int KV, int hd,
                                   int causal, int dtype, float sm_scale,
                                   void* cuda_stream) {
  cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, Sq, Skv, H, KV, causal, sm_scale, stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, H, KV, causal, sm_scale,
                                      stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
