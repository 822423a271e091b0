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
// Three entry points, each with an f32 and a bf16 body chosen by dtype:
//   (a) flash_attention_bwd_delta_kernel: D, (B, H, S) f32, one warp a row.
//   (b) dK/dV: one CTA per (kv tile of 64 rows, kv head, batch row).  It
//       holds its K and V tiles and walks the G query heads of its group
//       and, for each, the q tiles that hold a live pair under the causal
//       mask and the window (from the diagonal tile to the last row within
//       w of its last key), recomputing S and P and accumulating dV and dK
//       for its 64 keys in registers.  The sum over the group happens
//       inside the CTA, so dK and dV are written once, with no atomics.
//   (c) dQ: one CTA per (q tile of 64 rows, head, batch row), walking the
//       kv tiles of the forward's bounds (from the window's first live tile
//       to the diagonal), the heaviest q tiles first, recomputing S, P and
//       dP and accumulating dQ in registers.
// Both (b) and (c) recompute S = Q K^T and dP = dO V^T, so a live (q, k)
// pair costs 7 products of hd multiply-adds where the least is 5 (the
// recomputed S, dP, dV, dK, dQ).  No atomics and a fixed order of every sum
// make two launches on the same inputs bitwise equal.  The kernels allocate
// nothing: the wrapper gives D and the outputs.
//
// bf16 (training): (b) and (c) on the tensor cores, FA2's backward without
// its atomic dQ.  Warps of 16 rows (kv rows in (b), q rows in (c)), four to
// a CTA; every product is mma.sync m16n8k16 on bf16 with f32 sums, reading
// its shared-memory operands with ldmatrix as B5's forward does.
//   (b) K and V load once; the Q and dO tiles of the group's heads, with
//       their LSE and D slices (per q row: per column of the transposed
//       scores), stream through a two-stage cp.async ring.  For each q tile
//       a warp computes dP^T = V dO^T and S^T = K Q^T (A: K or V from shared
//       memory; B: the row-major Q or dO tile through ldmatrix, as the
//       forward reads K), then P^T and dS^T element by element, then dV +=
//       P^T dO and dK += dS^T Q (A: P^T or dS^T built from the accumulator
//       registers, as the forward builds P; B: dO or Q through
//       ldmatrix.trans).  Four products.  The q tile is 64 rows, 32 at hd
//       128, where dK and dV hold 128 f32 accumulators a lane.
//   (c) Q, dO, LSE and D stay; K and V tiles of 32 rows stream through
//       the ring.  dP = dO V^T, S = Q K^T, P and dS, then
//       dQ += dS K (A: dS from registers; B: K through ldmatrix.trans).
//       Three products.
// P and dS are never written to shared memory.  A warp skips a tile wholly
// dead for its 16 rows (bitwise the same as computing it: its P is 0),
// and masks only a tile that reaches past S, the diagonal or the window;
// a masked pair takes P = 0 by a select, never through exp(-1e30 - lse),
// so the zero-filled rows past S give no NaN.  Rows past S are not stored.
// Precision: the products take q, k, v and dO exactly (bf16 values are
// exact in the products, sums in f32).  P and dS are f32 in registers, and
// each is rounded to bf16 once where it becomes an A operand (FA2's
// choice; dS is taken from the f32 P).  The CPU model of this arithmetic
// (tests/test_torch_attention_grad.py) lands within 0.0052 of each (batch
// row, head) slice's max of jax.grad of plain_attention in f32 over its ten
// cases (GQA, G = 1, hd 16-128, w = 1, w < S, w >= S, both caps), against
// a tolerance of 1e-2; the bf16 output o that D is taken from raises
// dq's worst slice to 0.0099 at smollm's heads, whatever the backward.
// B5's forward splits P into hi + lo for its P.V; here one rounding holds
// with a margin of about 2x, so no operand is split.
//
// f32 (the card-vs-CPU path): the CUDA-core kernels of the first port,
// every product in f32 (TF32 would miss the f32 tolerance).  256 threads
// in a 16 x 16 grid, as B5's f32 body; thread (ty, tx) holds the scores of
// rows ty + 16 a and columns tx + 16 b (a, b < 4) of a 64 x 64 tile, and
// the output columns 4 tx + 64 g (hd >= 64; tx + 16 c below) of its 4
// rows.  The tiles sit in shared memory as f32 in rows padded by 4 floats;
// P (then dS) passes through one 64 x 68 buffer.
//
// Bound on the H100.  At smollm-360m's training shape (8, 2048, 15 heads
// over 5, hd 64) the live pairs need 10 flops a pair per hd (the least five
// products): 161 GFLOP, 0.16 ms at 989 TFLOP/s on the tensor cores; the
// bytes (q, k, v, o, dO, LSE in; dQ, dK, dV out) take 0.03 ms at 3.35
// TB/s, so operations bound it.  The bf16 bodies issue 7 products, 1.4x
// the bound's, in mma.sync, which reaches about 640 TFLOP/s.  They take
// about 1.40 ms there on an H100 80GB HBM3 at 700 W (dK/dV 0.82, dQ 0.53,
// D 0.05; the CUDA-core bodies took 8.2 on the same bf16 inputs, SDPA's
// backward 0.60; PERF.md): about 160 and 185 TFLOP/s.  Each warp reads its whole B tile through
// ldmatrix for 16 rows of output (about 13 flop a byte of shared memory),
// and dK/dV holds 214 registers at hd 64, so two CTAs an SM.  wgmma fed by
// TMA (B tiles read once for 64 rows), then one pass of five products with
// a deterministic dQ, are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store4_as(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store1_as(float* p, float x) { *p = x; }

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

// ---- bf16 on the tensor cores ----------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;      // kv rows of a dK/dV CTA, q rows of a dQ CTA
constexpr int kStages = 2;                  // the streamed tiles' ring
// The tiling (tools/b5b_tiles.py times the alternatives at smollm-360m's
// shape): q rows a dK/dV step, kv rows a dQ step, and the CTAs an SM each
// kernel's register budget is set for at hd <= 64.  Three CTAs an SM would
// make dK/dV spill at hd 64.  At hd 128, where dK and dV hold 128 f32
// accumulators a lane and dQ 64, a dK/dV step takes 32 q rows, and each
// kernel two CTAs an SM.
constexpr int kDkdvBlockQ = 64;
constexpr int kDqBlockKV = 32;
constexpr int kDkdvCtas = 2;
constexpr int kDqCtas = 4;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct TcTile {
  static constexpr int kLd = HD + 8;        // padded row, elements (16 bytes more)
  static constexpr int kBlockQ = HD <= 64 ? kDkdvBlockQ : 32;  // q rows a dK/dV step
  static constexpr int kCtasDkdv = HD <= 64 ? kDkdvCtas : 2;
  static constexpr int kCtasDq = HD <= 64 ? kDqCtas : 2;
  static constexpr int kRes = kTcRows * kLd;          // a resident tile
  static constexpr int kQ = kBlockQ * kLd;            // a streamed Q or dO tile
  static constexpr int kKV = kDqBlockKV * kLd;        // a streamed K or V tile
  // dK/dV: K, V; per stage Q, dO and kBlockQ LSE and D values
  static constexpr int kDkdvBytes =
      static_cast<int>(sizeof(bf16)) * (2 * kRes + kStages * 2 * kQ) +
      static_cast<int>(sizeof(float)) * kStages * 2 * kBlockQ;
  // dQ: Q, dO; per stage K, V
  static constexpr int kDqBytes = static_cast<int>(sizeof(bf16)) * (2 * kRes + kStages * 2 * kKV);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !valid (src-size 0:
// nothing is read; src then points at a valid row all the same).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

// 4 bytes, or 4 zero bytes when !valid (the LSE and D rows of a head are
// 4-byte aligned only)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) rounded to a bf16 pair; x takes the low half, the lower column of
// an A fragment register
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Start copying `rows` rows [r0, r0 + rows) of one head (row stride `stride`
// elements) into dst (padded rows), zeros past n_rows.
template <int HD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int rows, int r0,
                                                int n_rows, size_t stride) {
  constexpr int kChunks = HD / 8;           // 16-byte pieces a row
  constexpr int kLd = TcTile<HD>::kLd;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks;
    const int c = (idx % kChunks) * 8;
    const bool ok = r0 + r < n_rows;
    const bf16* g = src + (ok ? static_cast<size_t>(r0 + r) * stride + c : 0);
    cp_async16(smem_addr(dst + r * kLd + c), g, ok);
  }
}

// Start copying n values [r0, r0 + n) of a row vector into dst, zeros past S.
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int n, int r0,
                                               int S) {
  for (int idx = threadIdx.x; idx < n; idx += kTcThreads) {
    const bool ok = r0 + idx < S;
    cp_async4(smem_addr(dst + idx), src + (ok ? r0 + idx : 0), ok);
  }
}

// acc[nb] += A (this warp's 16 rows of a resident tile, hd wide) times B^T
// (the rows 8 nb .. 8 nb + 7 of a row-major tile, hd wide): the scores of
// 16 rows against 8 kNB rows of the other operand
template <int HD, int kNB>
__device__ __forceinline__ void scores(float (&acc)[kNB][4], const bf16* A, const bf16* Bt,
                                       int lane) {
  constexpr int kLd = TcTile<HD>::kLd;
#pragma unroll
  for (int nb = 0; nb < kNB; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, smem_addr(A + (lane % 16) * kLd + 16 * ks + (lane / 16) * 8));
#pragma unroll
    for (int nb2 = 0; nb2 < kNB / 2; ++nb2) {
      uint32_t bf[4];
      ldmatrix_x4(bf, smem_addr(Bt + (16 * nb2 + lane % 8 + (lane / 16) * 8) * kLd + 16 * ks
                                + ((lane / 8) % 2) * 8));
      mma_bf16(acc[2 * nb2], af, bf[0], bf[1]);
      mma_bf16(acc[2 * nb2 + 1], af, bf[2], bf[3]);
    }
  }
}

// out[db] += A X: A the bf16 fragments of 16 rows x 16 kK columns (built
// from score accumulators), X the row-major tile of those 16 kK rows, hd
// wide, read with ldmatrix.trans
template <int HD, int kK>
__device__ __forceinline__ void accumulate(float (&out)[HD / 8][4], const uint32_t (&a)[kK][4],
                                           const bf16* X, int lane) {
  constexpr int kLd = TcTile<HD>::kLd;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
    for (int db2 = 0; db2 < HD / 16; ++db2) {
      uint32_t xf[4];
      ldmatrix_x4_trans(xf, smem_addr(X + (16 * kk + lane % 16) * kLd + 16 * db2
                                      + (lane / 16) * 8));
      mma_bf16(out[2 * db2], a[kk], xf[0], xf[1]);
      mma_bf16(out[2 * db2 + 1], a[kk], xf[2], xf[3]);
    }
  }
}

// The A fragment of k-step kk (columns 16 kk .. 16 kk + 15) from the f32
// accumulators of score blocks 2 kk and 2 kk + 1, rounded to bf16 once
template <int kNB>
__device__ __forceinline__ void to_fragments(uint32_t (&a)[kNB / 2][4], const float (&x)[kNB][4]) {
#pragma unroll
  for (int kk = 0; kk < kNB / 2; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// 2^x in one MUFU.EX2: results below 2^-126 flush to 0, which a P that
// small may (exp2f spends three more instructions a call keeping them)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P = exp(x - lse) of a score's dot product (x its scaled, capped value),
// and in `ds` the gradient dS = P (dp - d) (times the cap's 1 - t^2).
// lse2 is lse log2(e); exp runs in base 2 on an FMA.
template <bool kCap>
__device__ __forceinline__ float prob_ds(float dot, float lse2, float dp, float d,
                                         float sm_scale, float softcap, float& ds) {
  float p;
  if constexpr (kCap) {
    const float t = tanhf(dot * sm_scale / softcap);
    p = exp2_ftz(fmaf(t * softcap, kLog2e, -lse2));
    ds = p * (dp - d) * (1.f - t * t);
  } else {
    p = exp2_ftz(fmaf(dot, sm_scale * kLog2e, -lse2));
    ds = p * (dp - d);
  }
  return p;
}

template <int HD, bool kCap>
__global__ void __launch_bounds__(kTcThreads, TcTile<HD>::kCtasDkdv)
flash_attention_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta, bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int S, int H, int KV, int causal,
                                   int window, float softcap, float sm_scale) {
  using Tile = TcTile<HD>;
  constexpr int kLd = Tile::kLd;
  constexpr int kBQ = Tile::kBlockQ;
  constexpr int kNB = kBQ / 8;              // n8 blocks of S^T (q columns)
  constexpr int kDB = HD / 8;               // n8 blocks of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [kTcRows][kLd]
  bf16* Vs = Ks + Tile::kRes;
  bf16* Qs = Vs + Tile::kRes;               // [kStages][kBQ][kLd]
  bf16* dOs = Qs + kStages * Tile::kQ;
  float* Ls = reinterpret_cast<float*>(dOs + kStages * Tile::kQ);  // [kStages][kBQ]
  float* Ds = Ls + kStages * kBQ;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;                 // fragment row (and row + 8)
  const int tig = lane % 4;                 // fragment column pair
  const int j0 = blockIdx.x * kTcRows;      // the lowest kv tiles, the heaviest, first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const int w = causal ? window : 0;
  const int jw = j0 + 16 * warp;            // this warp's first key

  // the q rows with a live pair: from the diagonal tile to the last row
  // within the window of this tile's last key; for each head of the group
  const int i_begin = causal ? j0 : 0;
  const int i_end = w > 0 ? min(S, j0 + kTcRows - 1 + w) : S;
  const int n_i = (i_end - i_begin + kBQ - 1) / kBQ;
  const int n_run = G * n_i;                // steps (head g, q tile) in that order

  auto load_step = [&](int t) {
    const int st = t % kStages;
    const int h = kvh * G + t / n_i;
    const int i0 = i_begin + (t % n_i) * kBQ;
    const size_t at = (static_cast<size_t>(b) * S * H + h) * HD;
    load_tile_async<HD>(Qs + st * Tile::kQ, q + at, kBQ, i0, S, q_stride);
    load_tile_async<HD>(dOs + st * Tile::kQ, dout + at, kBQ, i0, S, q_stride);
    const size_t row = (static_cast<size_t>(b) * H + h) * S;
    load_vec_async(Ls + st * kBQ, lse + row, kBQ, i0, S);
    load_vec_async(Ds + st * kBQ, delta + row, kBQ, i0, S);
  };

  // one copy group per step, kStages - 1 ahead (K and V ride with the
  // first); groups past the last step are empty, so the count stays fixed
  load_tile_async<HD>(Ks, k + (static_cast<size_t>(b) * S * KV + kvh) * HD, kTcRows, j0, S,
                      kv_stride);
  load_tile_async<HD>(Vs, v + (static_cast<size_t>(b) * S * KV + kvh) * HD, kTcRows, j0, S,
                      kv_stride);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_run) load_step(t);
    cp_async_commit();
  }

  float dka[kDB][4], dva[kDB][4];
#pragma unroll
  for (int i = 0; i < kDB; ++i)
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = dva[i][0] = dva[i][1] = dva[i][2] =
        dva[i][3] = 0.f;

  for (int t = 0; t < n_run; ++t) {
    const int st = t % kStages;
    // the stage of step t + kStages - 1 was freed at the end of step t - 1
    if (t + kStages - 1 < n_run) load_step(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // step t has landed
    __syncthreads();
    const int i0 = i_begin + (t % n_i) * kBQ;
    // a warp skips a q tile with no live pair for its 16 keys: keys past S,
    // queries all before them, or all past their window
    if (!(jw >= S || (causal && i0 + kBQ - 1 < jw) || (w > 0 && i0 >= jw + 15 + w))) {
      const bf16* Qt = Qs + st * Tile::kQ;
      const bf16* dOt = dOs + st * Tile::kQ;
      const float* Lt = Ls + st * kBQ;
      const float* Dt = Ds + st * kBQ;
      // dP^T = V dO^T and S^T = K Q^T: rows are keys, columns queries
      float dp[kNB][4], s[kNB][4];
      scores<HD, kNB>(dp, Vs + 16 * warp * kLd, dOt, lane);
      scores<HD, kNB>(s, Ks + 16 * warp * kLd, Qt, lane);
      // P^T and dS^T; mask only a tile that reaches past S, the diagonal or
      // the window of a key
      const bool edge = i0 + kBQ > S || jw + 16 > S || (causal && i0 < jw + 15) ||
                        (w > 0 && i0 + kBQ - 1 >= jw + w);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const int c = 8 * nb + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(Lt + c);
        const float2 d2 = *reinterpret_cast<const float2*>(Dt + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float ds;
          float p = prob_ds<kCap>(s[nb][e], (e & 1 ? l2.y : l2.x) * kLog2e, dp[nb][e],
                                  e & 1 ? d2.y : d2.x, sm_scale, softcap, ds);
          if (edge && !live_pair(i0 + c + (e & 1), jw + gid + 8 * (e >> 1), S, causal, w))
            p = ds = 0.f;
          s[nb][e] = p;
          dp[nb][e] = ds;
        }
      }
      uint32_t pa[kNB / 2][4], dsa[kNB / 2][4];
      to_fragments<kNB>(pa, s);
      to_fragments<kNB>(dsa, dp);
      accumulate<HD, kNB / 2>(dva, pa, dOt, lane);   // dV += P^T dO
      accumulate<HD, kNB / 2>(dka, dsa, Qt, lane);   // dK += dS^T Q
    }
    __syncthreads();                        // stage st is free for step t + kStages
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = jw + gid + 8 * r;
    if (j >= S) continue;
    const size_t at = (static_cast<size_t>(b) * S + j) * kv_stride +
                      static_cast<size_t>(kvh) * HD + 2 * tig;
#pragma unroll
    for (int db = 0; db < kDB; ++db) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * db) =
          __floats2bfloat162_rn(dka[db][2 * r] * sm_scale, dka[db][2 * r + 1] * sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * db) =
          __floats2bfloat162_rn(dva[db][2 * r], dva[db][2 * r + 1]);
    }
  }
}

template <int HD, bool kCap>
__global__ void __launch_bounds__(kTcThreads, TcTile<HD>::kCtasDq)
flash_attention_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta, bf16* __restrict__ dq, int S,
                                 int H, int KV, int causal, int window, float softcap,
                                 float sm_scale) {
  using Tile = TcTile<HD>;
  constexpr int kLd = Tile::kLd;
  constexpr int kBKV = kDqBlockKV;
  constexpr int kNB = kBKV / 8;             // n8 blocks of S (kv columns)
  constexpr int kDB = HD / 8;               // n8 blocks of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [kTcRows][kLd]
  bf16* dOs = Qs + Tile::kRes;
  bf16* Ks = dOs + Tile::kRes;              // [kStages][kBKV][kLd]
  bf16* Vs = Ks + kStages * Tile::kKV;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const int w = causal ? window : 0;
  const int iw = q0 + 16 * warp;            // this warp's first query

  // the forward's bounds: to the diagonal, from the tile holding the first
  // row's oldest live key
  const int kv_end = causal ? min(S, q0 + kTcRows) : S;
  const int t_begin = w > 0 ? max(0, q0 - w + 1) / kBKV : 0;
  const int n_run = (kv_end + kBKV - 1) / kBKV - t_begin;
  const bf16* kb = k + (static_cast<size_t>(b) * S * KV + kvh) * HD;
  const bf16* vb = v + (static_cast<size_t>(b) * S * KV + kvh) * HD;

  auto load_step = [&](int t) {
    const int st = t % kStages;
    const int r0 = (t_begin + t) * kBKV;
    load_tile_async<HD>(Ks + st * Tile::kKV, kb, kBKV, r0, S, kv_stride);
    load_tile_async<HD>(Vs + st * Tile::kKV, vb, kBKV, r0, S, kv_stride);
  };

  // Q and dO ride with the first K/V tile; each lane's LSE (base 2) and D
  // for its two rows stay in registers
  const size_t at = (static_cast<size_t>(b) * S * H + h) * HD;
  load_tile_async<HD>(Qs, q + at, kTcRows, q0, S, q_stride);
  load_tile_async<HD>(dOs, dout + at, kTcRows, q0, S, q_stride);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_run) load_step(t);
    cp_async_commit();
  }
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = iw + gid + 8 * r;
    const size_t row = (static_cast<size_t>(b) * H + h) * S + i;
    lse2[r] = i < S ? lse[row] * kLog2e : 0.f;
    dd[r] = i < S ? delta[row] : 0.f;
  }

  float dqa[kDB][4];
#pragma unroll
  for (int i = 0; i < kDB; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  for (int t = 0; t < n_run; ++t) {
    const int st = t % kStages;
    if (t + kStages - 1 < n_run) load_step(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int j0 = (t_begin + t) * kBKV;
    // a warp skips a kv tile dead for its 16 queries: queries past S, keys
    // all after them, or all below the window of its first query
    if (!(iw >= S || (causal && j0 > iw + 15) || (w > 0 && j0 + kBKV - 1 <= iw - w))) {
      const bf16* Kt = Ks + st * Tile::kKV;
      const bf16* Vt = Vs + st * Tile::kKV;
      float dp[kNB][4], s[kNB][4];
      scores<HD, kNB>(dp, dOs + 16 * warp * kLd, Vt, lane);   // dP = dO V^T
      scores<HD, kNB>(s, Qs + 16 * warp * kLd, Kt, lane);     // S = Q K^T
      const bool edge = j0 + kBKV > S || iw + 16 > S ||
                        (causal && j0 + kBKV - 1 > iw) || (w > 0 && j0 <= iw + 15 - w);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float ds;
          prob_ds<kCap>(s[nb][e], lse2[e >> 1], dp[nb][e], dd[e >> 1], sm_scale, softcap, ds);
          if (edge && !live_pair(iw + gid + 8 * (e >> 1), j0 + 8 * nb + 2 * tig + (e & 1), S,
                                 causal, w))
            ds = 0.f;
          dp[nb][e] = ds;
        }
      }
      uint32_t dsa[kNB / 2][4];
      to_fragments<kNB>(dsa, dp);
      accumulate<HD, kNB / 2>(dqa, dsa, Kt, lane);   // dQ += dS K
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = iw + gid + 8 * r;
    if (i >= S) continue;
    bf16* row = dq + (static_cast<size_t>(b) * S + i) * q_stride + static_cast<size_t>(h) * HD +
                2 * tig;
#pragma unroll
    for (int db = 0; db < kDB; ++db)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * db) =
          __floats2bfloat162_rn(dqa[db][2 * r] * sm_scale, dqa[db][2 * r + 1] * sm_scale);
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

template <int HD>
int launch_dkdv_tc(const Args& a) {
  constexpr int kSmem = TcTile<HD>::kDkdvBytes;
  auto kernel = a.softcap != 0.f ? flash_attention_bwd_dkdv_tc_kernel<HD, true>
                                 : flash_attention_bwd_dkdv_tc_kernel<HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kTcRows - 1) / kTcRows, a.KV, a.B);
  kernel<<<grid, kTcThreads, kSmem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S, a.H, a.KV, a.causal, a.window,
      a.softcap, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq_tc(const Args& a) {
  constexpr int kSmem = TcTile<HD>::kDqBytes;
  auto kernel = a.softcap != 0.f ? flash_attention_bwd_dq_tc_kernel<HD, true>
                                 : flash_attention_bwd_dq_tc_kernel<HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kTcRows - 1) / kTcRows, a.H, a.B);
  kernel<<<grid, kTcThreads, kSmem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse, a.delta,
      static_cast<bf16*>(a.dq), a.S, a.H, a.KV, a.causal, a.window, a.softcap, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = delta, 1 = dK/dV, 2 = dQ; f32 on the CUDA cores, bf16 on the
// tensor cores (its D pass is the f32 body's, on bf16 loads)
template <typename T, int HD>
int launch(int which, const Args& a) {
  if (which == 0) return launch_delta<T, HD>(a);
  if constexpr (std::is_same<T, bf16>::value) {
    if (which == 1) return launch_dkdv_tc<HD>(a);
    if (which == 2) return launch_dq_tc<HD>(a);
  } else {
    if (which == 1) return launch_dkdv<T, HD>(a);
    if (which == 2) return launch_dq<T, HD>(a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
