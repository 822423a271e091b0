// The backward of B5 (causal GQA flash attention) for Hopper (sm_90a).
//
// No TPU kernel stands behind it: the Pallas kernel
// src/repro/kernels/flash_attention.py :: flash_attention_pallas has no
// custom_vjp, and the JAX package trains through XLA's autodiff of
// plain_attention and of the blockwise flash_attention_xla
// (src/repro/models/attention_flash.py).  These kernels compute that
// gradient for exactly B5's function (flash_attention.cu): q (B, S, H, hd)
// against k, v (B, S, KV, hd), query head h reading kv head h / (H / KV),
// causal or not, the sliding window (key j live for query i iff i - w < j
// <= i), the logit soft-cap (s -> tanh(s / c) c on s = q.k hd^-1/2) and hd
// 16, 32, 64 or 128, in f32 and bf16.  Training has Sq = Skv, and so does
// the backward: the wrapper raises otherwise.
//
// With P = exp(S - LSE) (the forward's log-sum-exp per row, in natural
// units), D_i = dO_i . O_i, dP = dO V^T and dS = P (dP - D) (times 1 -
// tanh^2(s / c) under a cap):
//   dV = P^T dO,  dK = dS^T Q hd^-1/2,  dQ = dS K hd^-1/2.
// Three kernels, all on the CUDA cores in f32 whatever the input type (bf16
// values are exact in f32; each output is rounded once to the input type):
//   (a) flash_attention_bwd_delta_kernel: D, (B, H, S) f32, one warp a row.
//   (b) flash_attention_bwd_dkdv_kernel: one CTA per (kv tile of 64 rows, kv
//       head, batch row).  It loads its K and V tiles once and walks the G
//       query heads of its group and, for each, the q tiles that hold a live
//       pair under the causal mask and the window (from the diagonal tile to
//       the last row within w of its last key), recomputing S and P and
//       accumulating dV and dK for its 64 keys in registers.  The sum over
//       the group happens inside the CTA, so dK and dV are written once,
//       with no atomics.
//   (c) flash_attention_bwd_dq_kernel: one CTA per (q tile of 64 rows, head,
//       batch row), walking the kv tiles of the forward's bounds (from the
//       window's first live tile to the diagonal), recomputing S, P and dP
//       and accumulating dQ in registers.
// Both (b) and (c) recompute S = Q K^T and dP = dO V^T, so a live (q, k)
// pair costs 7 products of hd multiply-adds where the least is 5 (the
// recomputed S, dP, dV, dK, dQ).  No atomics and a fixed order of every sum
// make two launches on the same inputs bitwise equal.
//
// Layout of (b) and (c): 256 threads in a 16 x 16 grid, as B5's f32 body;
// thread (ty, tx) holds the scores of rows ty + 16 a and columns tx + 16 b
// (a, b < 4) of a 64 x 64 tile, and the output columns 4 tx + 64 g (hd >=
// 64; tx + 16 c below) of its 4 rows.  The tiles sit in shared memory as
// f32 in rows padded by 4 floats; P (then dS) passes through one 64 x 68
// buffer.
//
// Bound on the H100.  At smollm-360m's training shape (8, 2048, 15 heads
// over 5, hd 64) the live pairs need 10 flops a pair per hd (the least five
// products): 161 GFLOP, 0.16 ms at 989 TFLOP/s on the tensor cores; the
// bytes (q, k, v, o, dO, LSE in; dQ, dK, dV out) take 0.03 ms at 3.35
// TB/s, so operations bound it.  These kernels run 7 products in f32 on the
// CUDA cores (67 TFLOP/s peak), so they sit far above that bound: the
// tensor cores (mma.sync or wgmma, P and dS kept in registers as the
// forward keeps P) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;                  // rows of a q tile and of a kv tile
constexpr int kThreads = 256;
constexpr int kLdP = kBlock + 4;            // padded row of P / dS

typedef __nv_bfloat16 bf16;

template <int HD>
constexpr int smem_bytes() {
  // four 64-row tiles, P / dS, and 64 LSE and 64 D values
  return static_cast<int>(sizeof(float)) *
         (4 * kBlock * (HD + 4) + kBlock * kLdP + 2 * kBlock);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__device__ __forceinline__ float4 load4_f32(const T* p);

template <>
__device__ __forceinline__ float4 load4_f32<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <>
__device__ __forceinline__ float4 load4_f32<bf16>(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store4_as(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4_as(bf16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void store1_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1_as(bf16* p, float x) { *p = __float2bfloat16(x); }

// Rows [r0, r0 + 64) of one head of x (row stride `stride` elements) into
// dst as f32, zeros past n_rows.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* x, int r0, int n_rows,
                                          size_t stride) {
  constexpr int kLd = HD + 4;
  constexpr int kVec = HD / 4;
  for (int idx = threadIdx.x; idx < kBlock * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows) v = load4_f32<T>(x + static_cast<size_t>(r0 + r) * stride + c);
    store4_as(dst + r * kLd + c, v);
  }
}

// 64 values [r0, r0 + 64) of a row vector into dst, zeros past n.
__device__ __forceinline__ void load_vec(float* dst, const float* x, int r0, int n) {
  if (threadIdx.x < kBlock)
    dst[threadIdx.x] = r0 + threadIdx.x < n ? x[r0 + threadIdx.x] : 0.f;
}

// s[a][b] = A[ty + 16 a] . Bm[tx + 16 b] over HD (two 64-row tiles)
template <int HD>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A, const float* Bm,
                                         int ty, int tx) {
  constexpr int kLd = HD + 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 bb[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) bb[b] = lds4(Bm + (tx + 16 * b) * kLd + d);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 aa = lds4(A + (ty + 16 * a) * kLd + d);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(aa.x, bb[b].x, s[a][b]);
        s[a][b] = fmaf(aa.y, bb[b].y, s[a][b]);
        s[a][b] = fmaf(aa.z, bb[b].z, s[a][b]);
        s[a][b] = fmaf(aa.w, bb[b].w, s[a][b]);
      }
    }
  }
}

// acc[a][c] += sum_i P[ty + 16 a][i] X[i][col c] over the 64 rows of X
template <int HD>
__device__ __forceinline__ void tile_acc(float (&acc)[4][HD / 16], const float* P,
                                         const float* X, int ty, int tx) {
  constexpr int kLd = HD + 4;
  constexpr int kCols = HD / 16;
#pragma unroll 2
  for (int jj = 0; jj < kBlock; jj += 4) {
    float4 pp[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) pp[a] = lds4(P + (ty + 16 * a) * kLdP + jj);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* xr = X + (jj + u) * kLd;
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        p[a] = u == 0 ? pp[a].x : u == 1 ? pp[a].y : u == 2 ? pp[a].z : pp[a].w;
      if constexpr (HD >= 64) {
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g) {
          const float4 xv = lds4(xr + 4 * tx + 64 * g);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc[a][4 * g + 0] = fmaf(p[a], xv.x, acc[a][4 * g + 0]);
            acc[a][4 * g + 1] = fmaf(p[a], xv.y, acc[a][4 * g + 1]);
            acc[a][4 * g + 2] = fmaf(p[a], xv.z, acc[a][4 * g + 2]);
            acc[a][4 * g + 3] = fmaf(p[a], xv.w, acc[a][4 * g + 3]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float xv = xr[tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(p[a], xv, acc[a][c]);
        }
      }
    }
  }
}

// Write row `row` of a thread's accumulator (its columns), times `scale`.
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* dst, const float (&acc)[HD / 16], float scale,
                                          int tx) {
  constexpr int kCols = HD / 16;
  if constexpr (HD >= 64) {
#pragma unroll
    for (int g = 0; g < kCols / 4; ++g)
      store4_as(dst + 4 * tx + 64 * g,
                make_float4(acc[4 * g] * scale, acc[4 * g + 1] * scale,
                            acc[4 * g + 2] * scale, acc[4 * g + 3] * scale));
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) store1_as(dst + tx + 16 * c, acc[c] * scale);
  }
}

// The scaled (and capped) score x of a live pair, P = exp(x - lse), and the
// cap's derivative 1 - tanh^2 in `cd`; P = 0 for a dead pair.
template <bool kCap>
__device__ __forceinline__ float prob(float dot, float lse, bool live, float sm_scale,
                                      float softcap, float& cd) {
  float x = dot * sm_scale;
  if constexpr (kCap) {
    const float t = tanhf(x / softcap);
    x = t * softcap;
    cd = 1.f - t * t;
  }
  return live ? expf(x - lse) : 0.f;
}

__device__ __forceinline__ bool live_pair(int i, int j, int S, int causal, int window) {
  return i < S && j < S && (!causal || j <= i) && (window <= 0 || j > i - window);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                 float* __restrict__ delta, int B, int S, int H) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;   // (b, s, h)
  const int lane = threadIdx.x % 32;
  if (row >= B * S * H) return;
  const T* orow = o + static_cast<size_t>(row) * HD;
  const T* drow = dout + static_cast<size_t>(row) * HD;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H;
    const int s = (row / H) % S;
    const int b = row / (H * S);
    delta[(static_cast<size_t>(b) * H + h) * S + s] = acc;
  }
}

template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta, T* __restrict__ dk,
                                T* __restrict__ dv, int S, int H, int KV, int causal,
                                int window, float softcap, float sm_scale) {
  constexpr int kLd = HD + 4;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                         // [kBlock][kLd]
  float* Vs = Ks + kBlock * kLd;
  float* Qs = Vs + kBlock * kLd;
  float* dOs = Qs + kBlock * kLd;
  float* Ps = dOs + kBlock * kLd;           // [kv row][q row], P then dS
  float* Ls = Ps + kBlock * kLdP;
  float* Ds = Ls + kBlock;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int j0 = blockIdx.x * kBlock;       // the lowest kv tiles, the heaviest, first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const int w = causal ? window : 0;

  load_rows<T, HD>(Ks, k + (static_cast<size_t>(b) * S * KV + kvh) * HD, j0, S, kv_stride);
  load_rows<T, HD>(Vs, v + (static_cast<size_t>(b) * S * KV + kvh) * HD, j0, S, kv_stride);
  // the q rows with a live pair: from the diagonal tile to the last row
  // within the window of this tile's last key
  const int i_begin = causal ? j0 : 0;
  const int i_end = w > 0 ? min(S, j0 + kBlock - 1 + w) : S;

  float dka[4][kCols], dva[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[a][c] = dva[a][c] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + (static_cast<size_t>(b) * S * H + h) * HD;
    const T* dob = dout + (static_cast<size_t>(b) * S * H + h) * HD;
    const float* lrow = lse + (static_cast<size_t>(b) * H + h) * S;
    const float* drow = delta + (static_cast<size_t>(b) * H + h) * S;
    for (int i0 = i_begin; i0 < i_end; i0 += kBlock) {
      __syncthreads();                      // the last tile's Q, dO and dS are consumed
      load_rows<T, HD>(Qs, qb, i0, S, q_stride);
      load_rows<T, HD>(dOs, dob, i0, S, q_stride);
      load_vec(Ls, lrow, i0, S);
      load_vec(Ds, drow, i0, S);
      __syncthreads();

      float p[4][4], cd[4][4], dp[4][4];
      tile_dot<HD>(p, Ks, Qs, ty, tx);      // k_j . q_i
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int j = j0 + ty + 16 * a;
          const int i = i0 + tx + 16 * bb;
          p[a][bb] = prob<kCap>(p[a][bb], Ls[tx + 16 * bb], live_pair(i, j, S, causal, w),
                                sm_scale, softcap, cd[a][bb]);
          Ps[(ty + 16 * a) * kLdP + tx + 16 * bb] = p[a][bb];
        }
      tile_dot<HD>(dp, Vs, dOs, ty, tx);    // v_j . dO_i
      __syncthreads();                      // P is in place
      tile_acc<HD>(dva, Ps, dOs, ty, tx);   // dV_j += sum_i P_ij dO_i
      __syncthreads();                      // every thread has read P
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          float ds = p[a][bb] * (dp[a][bb] - Ds[tx + 16 * bb]);
          if constexpr (kCap) ds *= cd[a][bb];
          Ps[(ty + 16 * a) * kLdP + tx + 16 * bb] = ds;
        }
      __syncthreads();
      tile_acc<HD>(dka, Ps, Qs, ty, tx);    // dK_j += sum_i dS_ij q_i
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= S) continue;
    const size_t at = (static_cast<size_t>(b) * S + j) * kv_stride + static_cast<size_t>(kvh) * HD;
    store_row<T, HD>(dk + at, dka[a], sm_scale, tx);
    store_row<T, HD>(dv + at, dva[a], 1.f, tx);
  }
}

template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dq, int S,
                              int H, int KV, int causal, int window, float softcap,
                              float sm_scale) {
  constexpr int kLd = HD + 4;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBlock * kLd;
  float* Ks = dOs + kBlock * kLd;
  float* Vs = Ks + kBlock * kLd;
  float* Ps = Vs + kBlock * kLd;            // [q row][kv row], dS
  float* Ls = Ps + kBlock * kLdP;
  float* Ds = Ls + kBlock;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlock;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const int w = causal ? window : 0;

  load_rows<T, HD>(Qs, q + (static_cast<size_t>(b) * S * H + h) * HD, q0, S, q_stride);
  load_rows<T, HD>(dOs, dout + (static_cast<size_t>(b) * S * H + h) * HD, q0, S, q_stride);
  load_vec(Ls, lse + (static_cast<size_t>(b) * H + h) * S, q0, S);
  load_vec(Ds, delta + (static_cast<size_t>(b) * H + h) * S, q0, S);
  // the forward's bounds: to the diagonal, from the tile holding the first
  // row's oldest live key
  const int kv_end = causal ? min(S, q0 + kBlock) : S;
  const int kv_begin = w > 0 ? max(0, q0 - w + 1) / kBlock * kBlock : 0;
  const T* kb = k + (static_cast<size_t>(b) * S * KV + kvh) * HD;
  const T* vb = v + (static_cast<size_t>(b) * S * KV + kvh) * HD;

  float dqa[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dqa[a][c] = 0.f;

  for (int j0 = kv_begin; j0 < kv_end; j0 += kBlock) {
    __syncthreads();                        // the last tile's K and dS are consumed
    load_rows<T, HD>(Ks, kb, j0, S, kv_stride);
    load_rows<T, HD>(Vs, vb, j0, S, kv_stride);
    __syncthreads();
    float p[4][4], cd[4][4], dp[4][4];
    tile_dot<HD>(p, Qs, Ks, ty, tx);        // q_i . k_j
    tile_dot<HD>(dp, dOs, Vs, ty, tx);      // dO_i . v_j
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int i = q0 + ty + 16 * a;
        const int j = j0 + tx + 16 * bb;
        const float pr = prob<kCap>(p[a][bb], Ls[ty + 16 * a], live_pair(i, j, S, causal, w),
                                    sm_scale, softcap, cd[a][bb]);
        float ds = pr * (dp[a][bb] - Ds[ty + 16 * a]);
        if constexpr (kCap) ds *= cd[a][bb];
        Ps[(ty + 16 * a) * kLdP + tx + 16 * bb] = ds;
      }
    __syncthreads();
    tile_acc<HD>(dqa, Ps, Ks, ty, tx);      // dQ_i += sum_j dS_ij k_j
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= S) continue;
    store_row<T, HD>(dq + (static_cast<size_t>(b) * S + i) * q_stride + static_cast<size_t>(h) * HD,
                     dqa[a], sm_scale, tx);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, S, H, KV, causal, window;
  float softcap, sm_scale;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch_delta(const Args& a) {
  const int rows = a.B * a.S * a.H;
  const int grid = (rows + kThreads / 32 - 1) / (kThreads / 32);
  flash_attention_bwd_delta_kernel<T, HD><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.B, a.S, a.H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkdv(const Args& a) {
  constexpr int kSmem = smem_bytes<HD>();
  auto kernel = a.softcap != 0.f ? flash_attention_bwd_dkdv_kernel<T, HD, true>
                                 : flash_attention_bwd_dkdv_kernel<T, HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBlock - 1) / kBlock, a.KV, a.B);
  kernel<<<grid, kThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.S, a.H, a.KV, a.causal, a.window, a.softcap, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const Args& a) {
  constexpr int kSmem = smem_bytes<HD>();
  auto kernel = a.softcap != 0.f ? flash_attention_bwd_dq_kernel<T, HD, true>
                                 : flash_attention_bwd_dq_kernel<T, HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kBlock - 1) / kBlock, a.H, a.B);
  kernel<<<grid, kThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dq), a.S, a.H, a.KV,
      a.causal, a.window, a.softcap, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = delta, 1 = dK/dV, 2 = dQ
template <typename T, int HD>
int launch(int which, const Args& a) {
  switch (which) {
    case 0: return launch_delta<T, HD>(a);
    case 1: return launch_dkdv<T, HD>(a);
    case 2: return launch_dq<T, HD>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_hd(int hd, int which, const Args& a) {
  switch (hd) {
    case 16: return launch<T, 16>(which, a);
    case 32: return launch<T, 32>(which, a);
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(int which, int dtype, int hd, const Args& a) {
  if (a.window < 0 || (a.window > 0 && !a.causal) || !(a.softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch_hd<float>(hd, which, a);
  if (dtype == 1) return dispatch_hd<bf16>(hd, which, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The three C entry points share one argument list.  q, o and dout (B, S,
// H, hd), k and v (B, S, KV, hd), all contiguous, 16-byte aligned, of one
// dtype (0 = f32, 1 = bf16); lse (B, H, S) f32 from flash_attention_fwd;
// delta (B, H, S) f32, written by flash_attention_bwd_delta and read by the
// other two; dq, dk and dv like q, k and v.  Arguments an entry does not
// read may be null.  hd is 16, 32, 64 or 128; H is a multiple of KV;
// window 0 or w >= 1 with causal; softcap 0 or c > 0.  Each returns the
// cudaError_t of its launch (0 = success).
#define BWD_ENTRY(name, which)                                                          \
  extern "C" int name(const void* q, const void* k, const void* v, const void* o,      \
                      const void* dout, const float* lse, float* delta, void* dq,      \
                      void* dk, void* dv, int B, int S, int H, int KV, int hd,         \
                      int causal, int window, float softcap, int dtype, float sm_scale, \
                      void* cuda_stream) {                                             \
    const Args a{q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, KV, causal,         \
                 window, softcap, sm_scale, static_cast<cudaStream_t>(cuda_stream)};    \
    return dispatch(which, dtype, hd, a);                                              \
  }

BWD_ENTRY(flash_attention_bwd_delta, 0)
BWD_ENTRY(flash_attention_bwd_dkdv, 1)
BWD_ENTRY(flash_attention_bwd_dq, 2)
