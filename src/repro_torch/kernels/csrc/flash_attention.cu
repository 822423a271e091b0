// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention_pallas (_flash_kernel).  It computes what that kernel
// computes: q (B, Sq, H, hd) against k, v (B, Skv, KV, hd), q head h reading
// kv head h / (H / KV) with no kv replicated; q aligned to the end of kv
// (query row i sits at position i + Skv - Sq); scores above the diagonal and
// kv rows past Skv set to -1e30; an f32 online softmax; out = acc / max(l,
// 1e-30) in q's dtype.  Two kernels sit behind the one C entry point,
// chosen by dtype.
//
// A sliding window w > 0 (causal only; the Pallas kernel has none: the JAX
// package runs windowed prefill in plain_attention, whose mask this is)
// also masks keys at or below q_pos - w, so key j is live for query
// position i iff i - w < j <= i.  Both bodies start their kv loop at the
// tile that holds q0 + offset - w + 1, the oldest key live for the CTA's
// first row: the tiles before it are dead for every row of the CTA, so a
// windowed CTA does work bounded by the window.  Skipping a dead tile is
// bitwise the same as computing it: a row that meets only dead keys first
// holds m = -1e30 and the garbage sums of exp(0), which its first live key
// multiplies by exp(-1e30 - m) = 0 exactly; and every row has a live key,
// its diagonal, in a tile the loop reaches.  With w >= Skv the loop starts
// at tile 0 and the mask adds nothing, bitwise w = 0.
//
// A logit soft-cap c > 0 (Gemma 2's attn_logit_softcapping; the Pallas
// kernel has none: the JAX package applies it in plain_attention and
// flash_attention_xla, whose arithmetic this is) replaces each scaled score
// s = q.k / sqrt(hd) by tanh(s / c) c before the masks, with tanhf and a
// true division (no fast math); masked keys stay at -1e30, so the tile
// skipping above is unchanged.  c is a run-time argument; the launch picks
// an instantiation by c != 0, so c = 0 runs the uncapped body with no test
// in its loop, bitwise the kernel without a cap.
// The bf16 body runs its softmax in base 2 on scores scaled by
// hd^-1/2 log2(e): there the cap acts on s = (q.k) hd^-1/2 in natural
// units and only its result is multiplied by log2(e); a cap applied to the
// base-2 score would bind at c log2(e) instead and give a plausible but
// wrong softmax.
//
// bf16 (the serving path): a kernel built for Hopper, FA3's shape, on
// wgmma fed by TMA (the primitives are inline PTX in hopper.cuh).  On the
// TPU the kv axis is a sequential grid dimension that carries (m, l, acc)
// in VMEM; here it is a loop inside one CTA per (q tile of 128 rows, head,
// batch row), heaviest q tiles first (blockIdx.x reversed), 384 threads in
// three warpgroups, one CTA an SM:
//   - warpgroup 0 is the producer: setmaxnreg drops it to 24 registers and
//     one thread issues TMA.  Q's tile loads once; K and V tiles of 128 kv
//     rows load into two rings of two stages, each stage with a full and an
//     empty mbarrier, so K_i is refilled once Q.K_i^T is read and V_i once
//     P.V_i is.  The tensor maps (host-encoded by cuTensorMapEncodeTiled,
//     passed as __grid_constant__ parameters) see each (B, S, heads, hd)
//     operand as 4-D (hd, heads, S, B); a box is 64 columns of hd (two a row
//     at hd 128; 32 or 16 at hd 32 or 16) by 128 rows of one head, swizzled
//     by its row's bytes (128, 64 or 32), tiles at 1,024-byte boundaries.
//     Rows past Sq or Skv arrive as zeros (TMA's out-of-bounds fill), which
//     the mask below still sets to -1e30 where they are keys.
//   - warpgroups 1 and 2 are consumers of 64 query rows each, raised to 240
//     registers (128 x 24 + 256 x 240 = 64,512 of the SM's 65,536).  S =
//     Q.K^T is wgmma m64n128k16 with both operands from shared-memory
//     descriptors (K-major), f32 sums of the raw bf16 values (a bf16
//     product is exact in f32, so only the order of the sums differs from
//     the reference); the f32 scores are then scaled by hd^-1/2 log2(e) and
//     the softmax runs in base 2 (exp2(x log2 e - m log2 e) is exp(x - m);
//     MUFU.EX2 alone, outputs below 2^-126 flushed to 0).
//   - The online softmax runs in the accumulator's layout: a thread holds
//     two rows (r and r + 8 of its warp's 16) and the row max and sum reduce
//     over the 4 lanes of a quad with two shuffles; m and l stay in
//     registers.  Only a tile that reaches past Skv, past the diagonal of
//     the warpgroup's first row or below the window of its last row is
//     masked.
//   - P.V runs without rounding P to bf16 once: P_hi = bf16(P) and P_lo =
//     bf16(P - P_hi) are built straight from the score registers as
//     wgmma's register A fragments (the RS form), and two wgmma
//     m64n{hd}k16 a k-step accumulate P_hi.V + P_lo.V into O in f32 (about
//     16 mantissa bits of P; the reference computes p @ v in f32, and one
//     rounding of P would widen the prefill -> decode handoff gap).  V's
//     tile is the MN-major operand (transpose bit set).
//   - Overlap: tile i's Q.K_i^T and the last tile's P_{i-1}.V_{i-1} are
//     issued together, and tile i's softmax runs while P_{i-1}.V_{i-1} does;
//     the two consumers take turns to issue (named barriers, a ping-pong),
//     so one's softmax also runs under the other's products.  Both walk
//     every tile of the CTA's range with no branch around a product or its
//     wait (ptxas serialises wgmma on a path it sees as divergent; the
//     warpgroup index is read through a shuffle for the same reason): a
//     tile wholly above a warpgroup's rows adds exact zeros to (l, O) with
//     corr = 1, and one wholly before its window is the dead-key case
//     above, so the result is bitwise what skipping them would give.
//   - Epilogue: O / max(l, 1e-30) stored as bf16 pairs from the registers,
//     rows >= Sq not stored; with lse, (m + log2 l) ln 2 a row.  No atomics:
//     two launches give the same bits, and a launch on a contiguous slice of
//     kv groups gives bitwise the whole launch's columns.
// f32 (phase 10's card-vs-CPU path): the CUDA-core kernel of the first port,
// unchanged; both products in f32 (TF32 would miss the f32 tolerance), q
// multiplied by hd^-1/2 after its cast to f32, as the reference.  One CTA
// per (q tile of 64 rows, head, batch row); 256 threads in a 16 x 16 grid;
// thread (ty, tx) owns query rows ty + 16 i (i < 4), the scores of kv
// columns tx + 16 j (j < 4) and the output columns 4 tx + 64 g (hd >= 64;
// tx + 16 c below); Q, K, V and P sit in shared memory as f32 in padded rows.
//
// Bound on the H100.  At the full-width prefill shape (4, 2048, 16, 128) q
// against (4, 2048, 8, 128) k and v in bf16, one call is 68.7 GFLOP with the
// causal half skipped and moves 100.7 MB: 0.069 ms at 989 TFLOP/s on the
// tensor cores, 0.030 ms at 3.35 TB/s, so operations bound it.  The bf16
// kernel issues 1.5x those operations (P.V twice for the hi/lo split) and
// takes about 0.22 ms on an H100 80GB HBM3 at 700 W (PERF.md; the
// mma.sync body it replaced took 0.48 ms, scaled dot-product attention
// about 0.15 ms): about 460 TFLOP/s of executed products, of which the
// products and their pipeline alone (softmax removed) reach about 540
// (tools/b5_tiles.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kThreads = 256;
constexpr int kLdP = kBlockKV + 4;          // padded row of P in shared memory
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

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

template <typename T, int HD, bool kCap>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                       int causal, int window, float softcap, float sm_scale) {
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

  // the last kv row any query of this tile may see, and the tile holding
  // the first one its first query may see in a window
  const int kv_end = causal ? min(Skv, min(q0 + kBlockQ, Sq) + offset) : Skv;
  const bool windowed = causal && window > 0;
  const int kv_begin =
      windowed ? max(0, q0 + offset - window + 1) / kBlockKV * kBlockKV : 0;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = kv_begin; j0 < kv_end; j0 += kBlockKV) {
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

    // cap (Q was scaled at its load), mask, then the online softmax of each
    // row over its 16 lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i + offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = j0 + tx + 16 * j;
        if constexpr (kCap) s[i][j] = tanhf(s[i][j] / softcap) * softcap;
        if (k_pos >= Skv || (causal && k_pos > q_pos) ||
            (windowed && k_pos <= q_pos - window))
          s[i][j] = kNegInf;
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
    if (lse != nullptr && tx == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = m[i] + logf(l[i]);
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
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int Sq, int Skv, int H, int KV, int causal, int window, float softcap,
           float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  auto kernel = softcap != 0.f ? flash_attention_kernel<T, HD, true>
                               : flash_attention_kernel<T, HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, Sq, Skv, H, KV, causal, window, softcap, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                int B, int Sq, int Skv, int H, int KV, int causal, int window,
                float softcap, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                                 sm_scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                                 sm_scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                                 sm_scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                                 sm_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- bf16 on wgmma, fed by TMA ---------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kWgBlockQ = 128;              // q rows a CTA, 64 a consumer warpgroup
constexpr int kWgBlockKV = 128;             // kv rows a tile
constexpr int kWgThreads = 384;             // producer + two consumer warpgroups
constexpr int kProducerRegs = 24;           // 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;

template <int HD>
struct WgTile {
  static constexpr int kCols = HD < 64 ? HD : 64;  // hd columns a TMA box
  static constexpr int kSwizzle = 2 * kCols;       // bytes a box row: 128, 64 or 32
  static constexpr int kBoxes = HD / kCols;        // boxes a row: 2 at hd 128
  static constexpr int kStages = 2;                // K and V rings
  static constexpr int kQBox = kWgBlockQ * kSwizzle;
  static constexpr int kKVBox = kWgBlockKV * kSwizzle;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  // barriers: Q, then full K, full V, empty K, empty V of each stage
  static constexpr int kBarriers = 1 + 4 * kStages;
  static constexpr int kBytes = 1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers;
};

// 2^x by the hardware's approximation alone (MUFU.EX2, without exp2f's
// rescaling around it): outputs below 2^-126 flush to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y); x
// takes the low half, the lower column of an A fragment register
__device__ __forceinline__ void split_hi_lo(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int HD, bool kCap>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                             float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                             int causal, int window, float softcap, float sm_scale) {
  using Tile = WgTile<HD>;
  using namespace hopper;
  constexpr int kStages = Tile::kStages;
  constexpr int kBN = kWgBlockKV;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // tiles at 1,024-byte boundaries, as the swizzle needs
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + Tile::kQBytes;             // [kStages][kBoxes][kBN rows]
  const uint32_t sV = sK + kStages * Tile::kKVBytes;
  const uint32_t bars = sV + kStages * Tile::kKVBytes;
  const uint32_t q_full = bars;
  auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  auto full_v = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty_k = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };
  auto empty_v = [&](int st) { return bars + 8 * (1 + 3 * kStages + st); };

  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qi * kWgBlockQ;
  const int offset = Skv - Sq;
  // the last kv row any query of the CTA may see, and the tile holding the
  // first one its first query may see in a window: tiles t_begin ..
  // t_begin + n_run - 1 are loaded, in order, for both consumers
  const int kv_end = causal ? min(Skv, min(q0 + kWgBlockQ, Sq) + offset) : Skv;
  const bool windowed = causal && window > 0;
  const int t_begin = windowed ? max(0, q0 + offset - window + 1) / kBN : 0;
  const int n_run = (kv_end + kBN - 1) / kBN - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), 8);            // a lane of each consumer warp
      mbar_init(empty_v(st), 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, read through a shuffle so that the compiler knows it is
  // the same across a warp: products issued under a branch on it then stay
  // asynchronous (ptxas serialises wgmma on a path it takes for divergent)
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 0) {
    // producer: one thread keeps the K and V rings full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, Tile::kQBytes);
#pragma unroll
      for (int x = 0; x < Tile::kBoxes; ++x)
        tma_load_4d(sQ + x * Tile::kQBox, &tq, q_full, x * Tile::kCols, h, q0, b);
      for (int i = 0; i < n_run; ++i) {
        const int st = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        const int j0 = (t_begin + i) * kBN;
        mbar_wait(empty_k(st), ph ^ 1);
        mbar_arrive_expect_tx(full_k(st), Tile::kKVBytes);
#pragma unroll
        for (int x = 0; x < Tile::kBoxes; ++x)
          tma_load_4d(sK + st * Tile::kKVBytes + x * Tile::kKVBox, &tk, full_k(st),
                      x * Tile::kCols, kvh, j0, b);
        mbar_wait(empty_v(st), ph ^ 1);
        mbar_arrive_expect_tx(full_v(st), Tile::kKVBytes);
#pragma unroll
        for (int x = 0; x < Tile::kBoxes; ++x)
          tma_load_4d(sV + st * Tile::kKVBytes + x * Tile::kKVBox, &tv, full_v(st),
                      x * Tile::kCols, kvh, j0, b);
      }
    }
  } else {
    // consumers: warpgroup cw owns q rows q0 + 64 cw .. q0 + 64 cw + 63.
    // Both walk the CTA's tiles: the products sit on one straight path (a
    // branch around a wgmma or its wait makes ptxas serialise them), and a
    // tile dead for all of a warpgroup's rows computes what skipping it
    // would (the note at the top)
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;
    const int r0 = q0 + 64 * cw;
    const int row_a = r0 + 16 * warp + gid;   // this thread's rows: row_a, row_a + 8
    const int wg_first = r0 + offset;
    const int wg_last = r0 + 63 + offset;
    const float scale2 = sm_scale * kLog2e;   // scores in base 2
    // ping-pong: a warpgroup issues its products after the other's, so one
    // runs its softmax while the other's products run
    const int my_turn = 1 + cw;
    const int their_turn = 2 - cw;
    if (cw == 1) bar_arrive(1, 256);          // the first turn is warpgroup 0's

    float s[kBN / 2];                         // scores of a tile, then P
    float acc[HD / 2];                        // O, unnormalised
    uint32_t p_hi[kBN / 16][4], p_lo[kBN / 16][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};          // row max, base 2
    float l[2] = {0.f, 0.f};

    // descriptors: Q rows 64 cw .. of each box (K-major), K (K-major),
    // V (MN-major: hd is contiguous, kv rows are the sum's K)
    const uint32_t q_base = sQ + 64 * cw * Tile::kSwizzle;
    auto issue_qk = [&](int st) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const int box = 16 * ks / Tile::kCols;
        const int col = (16 * ks % Tile::kCols) * 2;
        Wgmma<kBN>::ss(s,
                       smem_desc<Tile::kSwizzle>(q_base + box * Tile::kQBox + col, 16,
                                                 8 * Tile::kSwizzle),
                       smem_desc<Tile::kSwizzle>(sK + st * Tile::kKVBytes
                                                     + box * Tile::kKVBox + col,
                                                 16, 8 * Tile::kSwizzle),
                       ks);
      }
      wgmma_commit();
    };
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t vd = smem_desc<Tile::kSwizzle>(
            sV + st * Tile::kKVBytes + 16 * kk * Tile::kSwizzle, Tile::kKVBox,
            8 * Tile::kSwizzle);
        Wgmma<HD>::rs(acc, p_hi[kk], vd);
        Wgmma<HD>::rs(acc, p_lo[kk], vd);
      }
      wgmma_commit();
    };
    auto fence_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
      }
    };
    // the online softmax of tile j0's scores in s: scale (capped in
    // natural units, then to base 2), mask only a tile that reaches past
    // Skv or the diagonal of the warpgroup's first row, or below the window
    // of its last row; m and l of rows row_a (e 0, 1) and row_a + 8 (e 2, 3)
    auto softmax = [&](int j0, float (&corr)[2]) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) {
        if constexpr (kCap)
          s[i] = tanhf(s[i] * sm_scale / softcap) * softcap * kLog2e;
        else
          s[i] *= scale2;
      }
      if (j0 + kBN > Skv || (causal && j0 + kBN - 1 > wg_first) ||
          (windowed && j0 <= wg_last - window)) {
        // key j0 + 2 tig + c of row r is live iff lo[r] < c <= hi[r]
        int lo[2], hi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q_pos = row_a + 8 * r + offset;
          hi[r] = (causal ? min(q_pos, Skv - 1) : Skv - 1) - j0 - 2 * tig;
          lo[r] = (windowed ? q_pos - window : -1) - j0 - 2 * tig;
        }
#pragma unroll
        for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * nb + (e & 1);
            if (c > hi[e >> 1] || c <= lo[e >> 1]) s[4 * nb + e] = kNegInf;
          }
        }
      }
      // row maxima in four independent chains each (max is exact in any order)
      float mx[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[r][c] = kNegInf;
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb) {
        mx[0][nb % 4] = fmaxf(mx[0][nb % 4], fmaxf(s[4 * nb], s[4 * nb + 1]));
        mx[1][nb % 4] = fmaxf(mx[1][nb % 4], fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[r], x);
        corr[r] = exp2_approx(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * nb + e] = exp2_approx(s[4 * nb + e] - m[e >> 1]);
          sum[e >> 1] += s[4 * nb + e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
    };
    // O *= corr, then P's A fragments from the score registers: kv rows
    // 16 kk .. 16 kk + 15 are score blocks 2 kk and 2 kk + 1
    auto rescale_and_split = [&](const float (&corr)[2]) {
#pragma unroll
      for (int db = 0; db < HD / 8; ++db) {
        acc[4 * db] *= corr[0];
        acc[4 * db + 1] *= corr[0];
        acc[4 * db + 2] *= corr[1];
        acc[4 * db + 3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split_hi_lo(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1], p_hi[kk][x], p_lo[kk][x]);
      }
    };

    mbar_wait(q_full, 0);
    // tile 0: S = Q K^T alone
    {
      mbar_wait(full_k(0), 0);
      bar_sync(my_turn, 256);
      wgmma_fence();
      issue_qk(0);
      if (!(cw == 1 && n_run == 1)) bar_arrive(their_turn, 256);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(empty_k(0));
      float corr[2];
      softmax(t_begin * kBN, corr);
      rescale_and_split(corr);
    }
    // tile i: S = Q K_i^T and O += P V_{i-1} together; the softmax of tile
    // i runs while P V_{i-1} does
    for (int i = 1; i < n_run; ++i) {
      const int st = i % kStages;
      const int pst = (i - 1) % kStages;
      mbar_wait(full_k(st), (i / kStages) & 1);
      mbar_wait(full_v(pst), ((i - 1) / kStages) & 1);
      bar_sync(my_turn, 256);
      fence_regs(acc);
      wgmma_fence();
      issue_qk(st);
      issue_pv(pst);
      if (!(cw == 1 && i == n_run - 1)) bar_arrive(their_turn, 256);
      wgmma_wait<1>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(empty_k(st));   // K_i is read
      float corr[2];
      softmax((t_begin + i) * kBN, corr);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_p();
      if (lane == 0) mbar_arrive(empty_v(pst));  // V_{i-1} is read
      rescale_and_split(corr);
    }
    {
      const int pst = (n_run - 1) % kStages;
      mbar_wait(full_v(pst), ((n_run - 1) / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
      issue_pv(pst);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_p();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_a + 8 * r;
      if (row >= Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      if (lse != nullptr && tig == 0)   // natural units: m and l are base 2
        lse[(static_cast<size_t>(b) * H + h) * Sq + row] = (m[r] + log2f(l[r])) * kLn2;
      bf16* orow = o + ((static_cast<size_t>(b) * Sq + row) * H + h) * HD + 2 * tig;
#pragma unroll
      for (int db = 0; db < HD / 8; ++db)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * db) =
            __floats2bfloat162_rn(acc[4 * db + 2 * r] / denom, acc[4 * db + 2 * r + 1] / denom);
    }
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                 int Sq, int Skv, int H, int KV, int causal, int window, float softcap,
                 float sm_scale, cudaStream_t stream) {
  using Tile = WgTile<HD>;
  CUtensorMap tq, tk, tv;
  int rc = hopper::encode_bshd(&tq, q, B, Sq, H, HD, Tile::kCols, kWgBlockQ);
  if (rc == 0) rc = hopper::encode_bshd(&tk, k, B, Skv, KV, HD, Tile::kCols, kWgBlockKV);
  if (rc == 0) rc = hopper::encode_bshd(&tv, v, B, Skv, KV, HD, Tile::kCols, kWgBlockKV);
  if (rc != 0) return rc;
  auto kernel = softcap != 0.f ? flash_attention_wgmma_kernel<HD, true>
                               : flash_attention_wgmma_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kWgBlockQ - 1) / kWgBlockQ, H, B);
  kernel<<<grid, kWgThreads, Tile::kBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, Sq, Skv, H, KV, causal, window, softcap,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_wgmma(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int Sq, int Skv, int H, int KV, int causal, int window,
                   float softcap, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_wgmma<16>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window,
                                     softcap, sm_scale, stream);
    case 32: return launch_wgmma<32>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window,
                                     softcap, sm_scale, stream);
    case 64: return launch_wgmma<64>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window,
                                     softcap, sm_scale, stream);
    case 128: return launch_wgmma<128>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window,
                                       softcap, sm_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B, Sq, H, hd), k and v (B, Skv, KV, hd), o (B, Sq, H, hd), all
// contiguous, 16-byte aligned, of one dtype: 0 = f32 (the CUDA-core kernel),
// 1 = bf16 (the tensor-core kernel).  lse: null, or (B, H, Sq) f32 that
// receives each row's log-sum-exp of its scaled (capped, masked) scores in
// natural units, m + ln(l), for the backward (flash_attention_bwd.cu); o
// is bitwise the same either way.  hd is 16, 32, 64 or 128; H is a
// multiple of KV; with causal, Sq <= Skv.  B, Sq and Skv are at least 1.
// window: 0, or the sliding window w >= 1 of a causal call.  softcap: 0 (no
// cap) or the logit soft-cap c > 0.  Returns the cudaError_t of the launch
// (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int Sq, int Skv, int H, int KV, int hd,
                                   int causal, int window, float softcap, int dtype,
                                   float sm_scale, void* cuda_stream) {
  cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (window < 0 || (window > 0 && !causal) || !(softcap >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                              sm_scale, stream);
  if (dtype == 1)
    return dispatch_wgmma(hd, q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                       sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
