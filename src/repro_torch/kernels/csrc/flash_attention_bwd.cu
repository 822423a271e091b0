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
//   (b) dK/dV: one CTA per (kv tile, kv head, batch row).  It holds its K
//       and V tiles and walks the G query heads of its group and, for
//       each, the q tiles that hold a live pair under the causal mask and
//       the window (from the diagonal tile to the last row within w of its
//       last key), recomputing S and P and accumulating dV and dK for its
//       keys in registers.  The sum over the group happens inside the CTA,
//       so dK and dV are written once, with no atomics.
//   (c) dQ: one CTA per (q tile, head, batch row), walking the kv tiles of
//       the forward's bounds (from the window's first live tile to the
//       diagonal), the heaviest q tiles first, recomputing S, P and dP and
//       accumulating dQ in registers.
// Both (b) and (c) recompute S = Q K^T and dP = dO V^T, so a live (q, k)
// pair costs 7 products of hd multiply-adds where the least is 5 (the
// recomputed S, dP, dV, dK, dQ).  No atomics and a fixed order of every sum
// make two launches on the same inputs bitwise equal.  The kernels allocate
// nothing: the wrapper gives D and the outputs.
//
// bf16 (training): (b) and (c) built for Hopper as B5's forward is, on
// wgmma fed by TMA (the primitives are inline PTX in hopper.cuh).  A CTA
// holds 128 rows (kv rows in (b), q rows in (c)) and runs 384 threads in
// three warpgroups, one CTA an SM; the tile index is the grid's slowest
// dimension, so every head's heaviest CTAs start first.
//   - Warpgroup 0 is the producer: setmaxnreg drops it to 40 registers.
//     Thread 0 issues TMA: the CTA's two resident tiles once (K and V in
//     (b), Q and dO in (c)), then the streamed tiles of every step into a
//     ring (in (b) the Q and dO tiles of 64 q rows, 32 at hd 128, of each
//     (head, q tile) step, three stages; in (c) the K and V tiles of 128
//     kv rows, 64 at hd 128, four stages), each stage with a full and an
//     empty mbarrier.  The tensor maps (host-encoded by
//     cuTensorMapEncodeTiled, passed as __grid_constant__ parameters) see
//     each (B, S, heads, hd) operand as 4-D (hd, heads, S, B); a box is 64
//     columns of hd (two a row at hd 128; 32 or 16 at hd 32 or 16),
//     swizzled by its row's bytes, tiles at 1,024-byte boundaries; rows
//     past S arrive as zeros.  In (b), warp 1 also copies each step's LSE
//     log2(e) and D (per q row: per column of the transposed scores) into
//     the stage with plain loads and arrives on its full barrier: a (B, H,
//     S) f32 row at a ragged S is no TMA box, and the consumers loading
//     them from device memory themselves took half of (b)'s time.  (c)'s
//     consumers load their two rows' LSE and D once.
//   - Warpgroups 1 and 2 are consumers of 64 rows each, raised to 232
//     registers (128 x 40 + 256 x 232 = 64,512 of the SM's 65,536).
//     (b): S^T = K Q^T and dP^T = V dO^T are wgmma with both operands from
//     shared-memory descriptors (K-major: K or V rows of the warpgroup, the
//     Q or dO tile), then P^T and dS^T element by element in the
//     accumulator layout, then dV += P^T dO and dK += dS^T Q with P^T and
//     dS^T as register A fragments built straight from the accumulators
//     (the RS form, as the forward builds P) and the dO or Q tile the
//     MN-major B (transpose bit set).  Four products.
//     (c): S = Q K^T and dP = dO V^T (both from shared memory), dS, then
//     dQ += dS K (dS from registers, K MN-major).  Three products.
//   - Overlap: step t's two score products are issued with step t - 1's
//     accumulating products, and step t's elementwise work runs while the
//     latter do; the two consumers take turns to issue (named barriers, a
//     ping-pong), so one's elementwise work also runs under the other's
//     products.  Both walk every step of the CTA with no branch around a
//     product or its wait (ptxas serialises wgmma on a path it sees as
//     divergent; the warpgroup index is read through a shuffle for the
//     same reason): a step wholly dead for a warpgroup's rows computes its
//     products and adds exact zeros, by a select.
// P and dS are never written to shared memory.  Only a step that reaches
// past S, the diagonal or the window of a warpgroup's rows is masked; a
// masked pair takes P = 0 by a select, never through exp(-1e30 - lse), so
// the zero-filled rows past S give no NaN.  Rows past S are not stored.
// Precision: the products take q, k, v and dO exactly (bf16 values are
// exact in the products, sums in f32).  P and dS are f32 in registers, and
// each is rounded to bf16 once where it becomes an A operand (FA2's
// choice; dS is taken from the f32 P; (b) and (c) compute it by the same
// arithmetic, prob_ds).  The CPU model of this arithmetic
// (tests/test_torch_attention_grad.py) lands within 0.0052 of each (batch
// row, head) slice's max of jax.grad of plain_attention in f32 over its ten
// cases (GQA, G = 1, hd 16-128, w = 1, w < S, w >= S, both caps), against
// a tolerance of 1e-2; the bf16 output o that D is taken from raises
// dq's worst slice to 0.0099 at smollm's heads, whatever the backward.
// B5's forward splits P into hi + lo for its P.V; here one rounding holds
// with a margin of about 2x, so no operand is split.
//
// f32 (the card-vs-CPU path): the CUDA-core kernels of the first port,
// every product in f32 (TF32 would miss the f32 tolerance), one CTA per
// 64-row tile.  256 threads in a 16 x 16 grid, as B5's f32 body; thread
// (ty, tx) holds the scores of rows ty + 16 a and columns tx + 16 b (a, b
// < 4) of a 64 x 64 tile, and the output columns 4 tx + 64 g (hd >= 64; tx
// + 16 c below) of its 4 rows.  The tiles sit in shared memory as f32 in
// rows padded by 4 floats; P (then dS) passes through one 64 x 68 buffer.
//
// Bound on the H100.  At smollm-360m's training shape (8, 2048, 15 heads
// over 5, hd 64) the live pairs need 10 flops a pair per hd (the least five
// products): 161 GFLOP, 0.16 ms at 989 TFLOP/s on the tensor cores; the
// bytes (q, k, v, o, dO, LSE in; dQ, dK, dV out) take 0.03 ms at 3.35
// TB/s, so operations bound it.  The bf16 bodies issue 7 products, 1.4x
// the bound's.  They take about 0.545 ms there on an H100 80GB HBM3 at
// 700 W (dK/dV 0.28, dQ 0.20, D 0.05 device alone; the mma.sync bodies they
// replaced took 1.39-1.40 in the same run, SDPA's backward 0.62-0.65;
// PERF.md): about 460 and 480 TFLOP/s of executed products.  Without its
// elementwise work dK/dV takes 0.22-0.23 (tools/b5b_tiles.py).  One pass
// of five products with a deterministic dQ is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// ---- bf16 on wgmma, fed by TMA ---------------------------------------------

constexpr int kWgRows = 128;                // kv rows of a dK/dV CTA, q rows of a dQ CTA
constexpr int kWgThreads = 384;             // producer + two consumer warpgroups
// The tunables (tools/b5b_tiles.py times the alternatives at smollm-360m's
// shape): q rows a dK/dV step and kv rows a dQ step at hd <= 64 (32 and
// 64 at hd 128, where dK and dV hold 128 f32 sums a thread and dQ 64), the
// stages of each ring, and the registers setmaxnreg gives the producer and
// the consumers (128 x 40 + 256 x 232 = 64,512 of the SM's 65,536).  A
// step's rows are a wgmma N (S^T's in dK/dV, S's in dQ): 32, 64 or 128.
constexpr int kDkdvBlockQ = 64;
constexpr int kDqBlockKV = 128;
constexpr int kDkdvStages = 3;
constexpr int kDqStages = 4;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct WgTile {
  static constexpr int kCols = HD < 64 ? HD : 64;  // hd columns a TMA box
  static constexpr int kSwizzle = 2 * kCols;       // bytes a box row: 128, 64 or 32
  static constexpr int kBoxes = HD / kCols;        // boxes a row: 2 at hd 128
  static constexpr int kBlockQ = HD <= 64 ? kDkdvBlockQ : 32;  // q rows a dK/dV step
  static constexpr int kBlockKV = HD <= 64 ? kDqBlockKV : 64;  // kv rows a dQ step
  static constexpr int kResBox = kWgRows * kSwizzle;  // a resident tile (K, V or Q, dO)
  static constexpr int kRes = kBoxes * kResBox;
  static constexpr int kQBox = kBlockQ * kSwizzle;    // a streamed Q or dO tile (dK/dV)
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kKVBox = kBlockKV * kSwizzle;  // a streamed K or V tile (dQ)
  static constexpr int kKV = kBoxes * kKVBox;
  // the two resident tiles, both rings (dK/dV's stages also hold the LSE
  // log2(e) and D of their q rows), and the barriers: the resident tiles',
  // then the full and the empty barrier of each stage
  static constexpr int kDkdvBytes = 1024 + 2 * kRes + 2 * kDkdvStages * kQ +
                                    2 * kDkdvStages * kBlockQ * 4 + 8 * (1 + 2 * kDkdvStages);
  static constexpr int kDqBytes =
      1024 + 2 * kRes + 2 * kDqStages * kKV + 8 * (1 + 2 * kDqStages);
};

// (x, y) rounded to a bf16 pair; x takes the low half, the lower column of
// an A fragment register
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
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

// The A fragments of a product's k-steps (16 columns each) from the f32
// accumulators x (8 kK a thread) of a wgmma of N = 16 kK columns, rounded
// to bf16 once: columns 16 kk .. 16 kk + 15 are x's n8 blocks 2 kk and
// 2 kk + 1
template <int kK>
__device__ __forceinline__ void to_fragments(uint32_t (&a)[kK][4], const float (&x)[8 * kK]) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

template <int kK>
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[kK][4]) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) hopper::fence_regs(a[kk]);
}

// Both kernels share one shape: warpgroup 0 the producer (one thread
// issues TMA), warpgroups 1 and 2 consumers of 64 rows each (cw 0 and 1);
// a CTA's two resident tiles load once, the streamed tiles through a ring
// of kStages stages with a full and an empty barrier each.  A consumer
// walks every step of the CTA, with one straight path through every wgmma
// and its wait (ptxas serialises wgmma on a path it takes for divergent):
// step t's two score products are issued with step t - 1's accumulating
// products, and step t's elementwise work runs while the latter do.

template <int HD, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                      const __grid_constant__ CUtensorMap tk,
                                      const __grid_constant__ CUtensorMap tv,
                                      const __grid_constant__ CUtensorMap tdo,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta, bf16* __restrict__ dk,
                                      bf16* __restrict__ dv, int S, int H, int KV, int causal,
                                      int window, float softcap, float sm_scale) {
  using Tile = WgTile<HD>;
  using namespace hopper;
  constexpr int kStages = kDkdvStages;
  constexpr int kBQ = Tile::kBlockQ;
  constexpr int kSw = Tile::kSwizzle;
  constexpr int kNB = kBQ / 8;              // n8 blocks of S^T (q columns)
  constexpr int kK = kBQ / 16;              // k-steps of dV += P^T dO and dK += dS^T Q
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // tiles at 1,024-byte boundaries, as the swizzle needs
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;   // [kBoxes][128 rows]
  const uint32_t sV = sK + Tile::kRes;
  const uint32_t sQ = sV + Tile::kRes;                         // [kStages][kBoxes][kBQ rows]
  const uint32_t sdO = sQ + kStages * Tile::kQ;
  const uint32_t sL = sdO + kStages * Tile::kQ;                // [kStages][kBQ] f32
  const uint32_t sD = sL + kStages * kBQ * 4;
  const uint32_t bars = sD + kStages * kBQ * 4;
  const uint32_t kv_full = bars;
  // the LSE and D stages, addressed from C++
  float* const Ls = reinterpret_cast<float*>(smem_raw + (sL - smem_u32(smem_raw)));
  float* const Ds = reinterpret_cast<float*>(smem_raw + (sD - smem_u32(smem_raw)));
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };

  // the lowest kv tiles, the heaviest, first: the tile is the grid's
  // slowest dimension, so every head's heaviest CTAs start before any
  // lighter one
  const int j0 = blockIdx.z * kWgRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.x;
  const int G = H / KV;
  const int w = causal ? window : 0;
  // the q rows with a live pair: from the diagonal tile to the last row
  // within the window of this tile's last key; for each head of the group,
  // steps (head, q tile) in that order
  const int i_begin = causal ? j0 : 0;
  const int i_end = w > 0 ? min(S, j0 + kWgRows - 1 + w) : S;
  const int n_i = (i_end - i_begin + kBQ - 1) / kBQ;
  const int n_run = G * n_i;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1 + 32);          // the TMA thread and warp 1's lanes
      mbar_init(empty(st), 8);              // a lane of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, read through a shuffle so that the compiler knows it is
  // the same across a warp
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: K and V once, then the (Q, dO) tiles of every step by TMA
    // (thread 0) and their LSE log2(e) and D by plain loads (warp 1: a
    // (B, H, S) f32 row at a ragged S is no TMA box)
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
      for (int t = 0; t < n_run; ++t) {
        const int st = t % kStages;
        const size_t row = (static_cast<size_t>(b) * H + kvh * G + t / n_i) * S;
        const int i0 = i_begin + (t % n_i) * kBQ;
        mbar_wait(empty(st), ((t / kStages) & 1) ^ 1);
#pragma unroll
        for (int c = lane; c < kBQ; c += 32) {
          const bool ok = i0 + c < S;
          Ls[st * kBQ + c] = ok ? __ldg(lse + row + i0 + c) * kLog2e : 0.f;
          Ds[st * kBQ + c] = ok ? __ldg(delta + row + i0 + c) : 0.f;
        }
        mbar_arrive(full(st));              // releases the stores above
      }
    } else if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * Tile::kRes);
#pragma unroll
      for (int x = 0; x < Tile::kBoxes; ++x) {
        tma_load_4d(sK + x * Tile::kResBox, &tk, kv_full, x * Tile::kCols, kvh, j0, b);
        tma_load_4d(sV + x * Tile::kResBox, &tv, kv_full, x * Tile::kCols, kvh, j0, b);
      }
      for (int t = 0; t < n_run; ++t) {
        const int st = t % kStages;
        const int h = kvh * G + t / n_i;
        const int i0 = i_begin + (t % n_i) * kBQ;
        mbar_wait(empty(st), ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(st), 2 * Tile::kQ);
#pragma unroll
        for (int x = 0; x < Tile::kBoxes; ++x) {
          tma_load_4d(sQ + st * Tile::kQ + x * Tile::kQBox, &tq, full(st), x * Tile::kCols, h,
                      i0, b);
          tma_load_4d(sdO + st * Tile::kQ + x * Tile::kQBox, &tdo, full(st), x * Tile::kCols, h,
                      i0, b);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns keys j0 + 64 cw .. j0 + 64 cw + 63
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;
    const int jw = j0 + 64 * cw;              // the warpgroup's first key
    const int row_a = jw + 16 * warp + gid;   // this thread's keys: row_a, row_a + 8
    // ping-pong: a warpgroup issues its products after the other's, so one
    // runs its elementwise work while the other's products run
    const int my_turn = 1 + cw;
    const int their_turn = 2 - cw;
    if (cw == 1) bar_arrive(1, 256);          // the first turn is warpgroup 0's

    float s[kBQ / 2], dp[kBQ / 2];            // S^T, then P^T; dP^T, then dS^T
    float dka[HD / 2], dva[HD / 2];
    uint32_t pa[kK][4], dsa[kK][4];           // P^T and dS^T as A fragments
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
    // query i is live for key j iff lo_abs <= i < hi_abs
    int lo_abs[2], hi_abs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = row_a + 8 * r;
      lo_abs[r] = causal ? j : 0;
      hi_abs[r] = j >= S ? -1 : w > 0 ? min(S, j + w) : S;
    }

    // descriptors: K and V rows 64 cw .. (A, K-major), the Q and dO tiles
    // (B, K-major for the scores, MN-major for the sums over q rows)
    const uint32_t k_base = sK + 64 * cw * kSw;
    const uint32_t v_base = sV + 64 * cw * kSw;
    auto step_i0 = [&](int t) { return i_begin + (t % n_i) * kBQ; };
    auto issue_scores = [&](int st) {
      const uint32_t q_t = sQ + st * Tile::kQ;
      const uint32_t do_t = sdO + st * Tile::kQ;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int box = 16 * ks / Tile::kCols;
        const int col = (16 * ks % Tile::kCols) * 2;
        Wgmma<kBQ>::ss(s, smem_desc<kSw>(k_base + box * Tile::kResBox + col, 16, 8 * kSw),
                       smem_desc<kSw>(q_t + box * Tile::kQBox + col, 16, 8 * kSw), ks);
      }
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int box = 16 * ks / Tile::kCols;
        const int col = (16 * ks % Tile::kCols) * 2;
        Wgmma<kBQ>::ss(dp, smem_desc<kSw>(v_base + box * Tile::kResBox + col, 16, 8 * kSw),
                       smem_desc<kSw>(do_t + box * Tile::kQBox + col, 16, 8 * kSw), ks);
      }
      wgmma_commit();
    };
    auto issue_sums = [&](int st) {
      const uint32_t q_t = sQ + st * Tile::kQ;
      const uint32_t do_t = sdO + st * Tile::kQ;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        Wgmma<HD>::rs(dva, pa[kk], smem_desc<kSw>(do_t + 16 * kk * kSw, Tile::kQBox, 8 * kSw));
        Wgmma<HD>::rs(dka, dsa[kk], smem_desc<kSw>(q_t + 16 * kk * kSw, Tile::kQBox, 8 * kSw));
      }
      wgmma_commit();
    };
    // P^T and dS^T in place of S^T and dP^T, with the LSE and D of the
    // thread's q columns from the stage; mask only a step that reaches past
    // S, the diagonal or the window of one of the warpgroup's keys
    auto grads = [&](int t) {
      const int i0 = step_i0(t);
      const float* lt = Ls + (t % kStages) * kBQ + 2 * tig;
      const float* dt = Ds + (t % kStages) * kBQ + 2 * tig;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * nb);
        const float2 d2 = *reinterpret_cast<const float2*>(dt + 8 * nb);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float ds;
          s[4 * nb + e] = prob_ds<kCap>(s[4 * nb + e], e & 1 ? l2.y : l2.x, dp[4 * nb + e],
                                        e & 1 ? d2.y : d2.x, sm_scale, softcap, ds);
          dp[4 * nb + e] = ds;
        }
      }
      if (i0 + kBQ > S || jw + 64 > S || (causal && i0 < jw + 63) ||
          (w > 0 && i0 + kBQ - 1 >= jw + w)) {
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lo[r] = lo_abs[r] - i0 - 2 * tig;
          hi[r] = hi_abs[r] - i0 - 2 * tig;
        }
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * nb + (e & 1);
            if (c < lo[e >> 1] || c >= hi[e >> 1]) s[4 * nb + e] = dp[4 * nb + e] = 0.f;
          }
      }
    };
    auto fence_sums = [&]() {
      fence_regs(dka);
      fence_regs(dva);
    };

    mbar_wait(kv_full, 0);
    mbar_wait(full(0), 0);
    bar_sync(my_turn, 256);
    wgmma_fence();
    issue_scores(0);
    if (!(cw == 1 && n_run == 1)) bar_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    grads(0);
    to_fragments<kK>(pa, s);
    to_fragments<kK>(dsa, dp);
    for (int t = 1; t < n_run; ++t) {
      const int st = t % kStages;
      const int pst = (t - 1) % kStages;
      mbar_wait(full(st), (t / kStages) & 1);
      bar_sync(my_turn, 256);
      fence_sums();
      wgmma_fence();
      issue_scores(st);
      issue_sums(pst);
      if (!(cw == 1 && t == n_run - 1)) bar_arrive(their_turn, 256);
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
      grads(t);
      wgmma_wait<0>();
      fence_sums();
      fence_fragments<kK>(pa);
      fence_fragments<kK>(dsa);
      if (lane == 0) mbar_arrive(empty(pst));   // step t - 1's Q and dO are read
      to_fragments<kK>(pa, s);
      to_fragments<kK>(dsa, dp);
    }
    fence_sums();
    wgmma_fence();
    issue_sums((n_run - 1) % kStages);
    wgmma_wait<0>();
    fence_sums();
    fence_fragments<kK>(pa);
    fence_fragments<kK>(dsa);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = row_a + 8 * r;
      if (j >= S) continue;
      const size_t at = (static_cast<size_t>(b) * S + j) * KV * HD +
                        static_cast<size_t>(kvh) * HD + 2 * tig;
#pragma unroll
      for (int db = 0; db < HD / 8; ++db) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * db) = __floats2bfloat162_rn(
            dka[4 * db + 2 * r] * sm_scale, dka[4 * db + 2 * r + 1] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * db) =
            __floats2bfloat162_rn(dva[4 * db + 2 * r], dva[4 * db + 2 * r + 1]);
      }
    }
  }
}

template <int HD, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                    const __grid_constant__ CUtensorMap tk,
                                    const __grid_constant__ CUtensorMap tv,
                                    const __grid_constant__ CUtensorMap tdo,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta, bf16* __restrict__ dq,
                                    int S, int H, int KV, int causal, int window, float softcap,
                                    float sm_scale) {
  using Tile = WgTile<HD>;
  using namespace hopper;
  constexpr int kStages = kDqStages;
  constexpr int kBKV = Tile::kBlockKV;
  constexpr int kSw = Tile::kSwizzle;
  constexpr int kNB = kBKV / 8;             // n8 blocks of S (kv columns)
  constexpr int kK = kBKV / 16;             // k-steps of dQ += dS K
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;   // [kBoxes][128 rows]
  const uint32_t sdO = sQ + Tile::kRes;
  const uint32_t sK = sdO + Tile::kRes;                        // [kStages][kBoxes][kBKV rows]
  const uint32_t sV = sK + kStages * Tile::kKV;
  const uint32_t bars = sV + kStages * Tile::kKV;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWgRows;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.x;
  const int kvh = h / (H / KV);
  const int w = causal ? window : 0;
  // the forward's bounds: to the diagonal of the CTA's last row, from the
  // tile holding its first row's oldest live key
  const int kv_end = causal ? min(S, q0 + kWgRows) : S;
  const int t_begin = w > 0 ? max(0, q0 - w + 1) / kBKV : 0;
  const int n_run = (kv_end + kBKV - 1) / kBKV - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: Q and dO once, then the (K, V) tiles of every step
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 2 * Tile::kRes);
#pragma unroll
      for (int x = 0; x < Tile::kBoxes; ++x) {
        tma_load_4d(sQ + x * Tile::kResBox, &tq, q_full, x * Tile::kCols, h, q0, b);
        tma_load_4d(sdO + x * Tile::kResBox, &tdo, q_full, x * Tile::kCols, h, q0, b);
      }
      for (int t = 0; t < n_run; ++t) {
        const int st = t % kStages;
        const int r0 = (t_begin + t) * kBKV;
        mbar_wait(empty(st), ((t / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full(st), 2 * Tile::kKV);
#pragma unroll
        for (int x = 0; x < Tile::kBoxes; ++x) {
          tma_load_4d(sK + st * Tile::kKV + x * Tile::kKVBox, &tk, full(st), x * Tile::kCols,
                      kvh, r0, b);
          tma_load_4d(sV + st * Tile::kKV + x * Tile::kKVBox, &tv, full(st), x * Tile::kCols,
                      kvh, r0, b);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns queries q0 + 64 cw .. q0 + 64 cw + 63
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;
    const int iw = q0 + 64 * cw;              // the warpgroup's first query
    const int row_a = iw + 16 * warp + gid;   // this thread's queries: row_a, row_a + 8
    // ping-pong: a warpgroup issues its products after the other's, so one
    // runs its elementwise work while the other's products run
    const int my_turn = 1 + cw;
    const int their_turn = 2 - cw;
    if (cw == 1) bar_arrive(1, 256);          // the first turn is warpgroup 0's

    float s[kBKV / 2], dp[kBKV / 2];          // S; dP, then dS
    float dqa[HD / 2];
    uint32_t dsa[kK][4];                      // dS as A fragments
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
    // each row's LSE (base 2) and D, and its live keys: lo_abs <= j <= hi_abs
    float lse2[2], dd[2];
    int lo_abs[2], hi_abs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row_a + 8 * r;
      const size_t row = (static_cast<size_t>(b) * H + h) * S + i;
      lse2[r] = i < S ? __ldg(lse + row) * kLog2e : 0.f;
      dd[r] = i < S ? __ldg(delta + row) : 0.f;
      lo_abs[r] = w > 0 ? i - w + 1 : 0;
      hi_abs[r] = i >= S ? -1 : causal ? min(i, S - 1) : S - 1;
    }

    // descriptors: Q and dO rows 64 cw .. (A, K-major), the K and V tiles
    // (B, K-major for the scores; K MN-major for dS K)
    const uint32_t q_base = sQ + 64 * cw * kSw;
    const uint32_t do_base = sdO + 64 * cw * kSw;
    auto issue_scores = [&](int st) {
      const uint32_t k_t = sK + st * Tile::kKV;
      const uint32_t v_t = sV + st * Tile::kKV;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int box = 16 * ks / Tile::kCols;
        const int col = (16 * ks % Tile::kCols) * 2;
        Wgmma<kBKV>::ss(s, smem_desc<kSw>(q_base + box * Tile::kResBox + col, 16, 8 * kSw),
                        smem_desc<kSw>(k_t + box * Tile::kKVBox + col, 16, 8 * kSw), ks);
      }
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int box = 16 * ks / Tile::kCols;
        const int col = (16 * ks % Tile::kCols) * 2;
        Wgmma<kBKV>::ss(dp, smem_desc<kSw>(do_base + box * Tile::kResBox + col, 16, 8 * kSw),
                        smem_desc<kSw>(v_t + box * Tile::kKVBox + col, 16, 8 * kSw), ks);
      }
      wgmma_commit();
    };
    auto issue_sums = [&](int st) {
      const uint32_t k_t = sK + st * Tile::kKV;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
        Wgmma<HD>::rs(dqa, dsa[kk], smem_desc<kSw>(k_t + 16 * kk * kSw, Tile::kKVBox, 8 * kSw));
      wgmma_commit();
    };
    // dS in place of dP; mask only a step that reaches past S, the diagonal
    // of the warpgroup's first query, or below the window of its last
    auto grads = [&](int t) {
      const int j0 = (t_begin + t) * kBKV;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float ds;
          prob_ds<kCap>(s[4 * nb + e], lse2[e >> 1], dp[4 * nb + e], dd[e >> 1], sm_scale,
                        softcap, ds);
          dp[4 * nb + e] = ds;
        }
      if (j0 + kBKV > S || iw + 64 > S || (causal && j0 + kBKV - 1 > iw) ||
          (w > 0 && j0 <= iw + 63 - w)) {
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lo[r] = lo_abs[r] - j0 - 2 * tig;
          hi[r] = hi_abs[r] - j0 - 2 * tig;
        }
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * nb + (e & 1);
            if (c < lo[e >> 1] || c > hi[e >> 1]) dp[4 * nb + e] = 0.f;
          }
      }
    };

    mbar_wait(q_full, 0);
    mbar_wait(full(0), 0);
    bar_sync(my_turn, 256);
    wgmma_fence();
    issue_scores(0);
    if (!(cw == 1 && n_run == 1)) bar_arrive(their_turn, 256);
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    grads(0);
    to_fragments<kK>(dsa, dp);
    for (int t = 1; t < n_run; ++t) {
      const int st = t % kStages;
      const int pst = (t - 1) % kStages;
      mbar_wait(full(st), (t / kStages) & 1);
      bar_sync(my_turn, 256);
      fence_regs(dqa);
      wgmma_fence();
      issue_scores(st);
      issue_sums(pst);
      if (!(cw == 1 && t == n_run - 1)) bar_arrive(their_turn, 256);
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
      grads(t);
      wgmma_wait<0>();
      fence_regs(dqa);
      fence_fragments<kK>(dsa);
      if (lane == 0) mbar_arrive(empty(pst));   // step t - 1's K and V are read
      to_fragments<kK>(dsa, dp);
    }
    fence_regs(dqa);
    wgmma_fence();
    issue_sums((n_run - 1) % kStages);
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_fragments<kK>(dsa);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row_a + 8 * r;
      if (i >= S) continue;
      bf16* out = dq + ((static_cast<size_t>(b) * S + i) * H + h) * HD + 2 * tig;
#pragma unroll
      for (int db = 0; db < HD / 8; ++db)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * db) = __floats2bfloat162_rn(
            dqa[4 * db + 2 * r] * sm_scale, dqa[4 * db + 2 * r + 1] * sm_scale);
    }
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

// The tensor maps of a bf16 launch: q and dO with boxes of q_rows rows, k
// and v with boxes of kv_rows rows (hopper::encode_bshd).  Returns a
// cudaError_t.
template <int HD>
int encode_maps(const Args& a, int q_rows, int kv_rows, CUtensorMap& tq, CUtensorMap& tk,
                CUtensorMap& tv, CUtensorMap& tdo) {
  constexpr int kCols = WgTile<HD>::kCols;
  int rc = hopper::encode_bshd(&tq, a.q, a.B, a.S, a.H, HD, kCols, q_rows);
  if (rc == 0) rc = hopper::encode_bshd(&tdo, a.dout, a.B, a.S, a.H, HD, kCols, q_rows);
  if (rc == 0) rc = hopper::encode_bshd(&tk, a.k, a.B, a.S, a.KV, HD, kCols, kv_rows);
  if (rc == 0) rc = hopper::encode_bshd(&tv, a.v, a.B, a.S, a.KV, HD, kCols, kv_rows);
  return rc;
}

template <int HD>
int launch_dkdv_wgmma(const Args& a) {
  using Tile = WgTile<HD>;
  CUtensorMap tq, tk, tv, tdo;
  const int rc = encode_maps<HD>(a, Tile::kBlockQ, kWgRows, tq, tk, tv, tdo);
  if (rc != 0) return rc;
  auto kernel = a.softcap != 0.f ? flash_attention_bwd_dkdv_wgmma_kernel<HD, true>
                                 : flash_attention_bwd_dkdv_wgmma_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile::kDkdvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B, a.KV, (a.S + kWgRows - 1) / kWgRows);
  kernel<<<grid, kWgThreads, Tile::kDkdvBytes, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv), a.S,
      a.H, a.KV, a.causal, a.window, a.softcap, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq_wgmma(const Args& a) {
  using Tile = WgTile<HD>;
  CUtensorMap tq, tk, tv, tdo;
  const int rc = encode_maps<HD>(a, kWgRows, Tile::kBlockKV, tq, tk, tv, tdo);
  if (rc != 0) return rc;
  auto kernel = a.softcap != 0.f ? flash_attention_bwd_dq_wgmma_kernel<HD, true>
                                 : flash_attention_bwd_dq_wgmma_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile::kDqBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B, a.H, (a.S + kWgRows - 1) / kWgRows);
  kernel<<<grid, kWgThreads, Tile::kDqBytes, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), a.S, a.H, a.KV, a.causal,
      a.window, a.softcap, a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = delta, 1 = dK/dV, 2 = dQ; f32 on the CUDA cores, bf16 on wgmma
// fed by TMA (its D pass is the f32 body's, on bf16 loads)
template <typename T, int HD>
int launch(int which, const Args& a) {
  if (which == 0) return launch_delta<T, HD>(a);
  if constexpr (std::is_same<T, bf16>::value) {
    if (which == 1) return launch_dkdv_wgmma<HD>(a);
    if (which == 2) return launch_dq_wgmma<HD>(a);
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
