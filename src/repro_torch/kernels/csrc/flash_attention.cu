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
// bf16 (the serving path): the tensor-core kernel.  On the TPU the kv axis
// is a sequential grid dimension that carries (m, l, acc) in VMEM; here it
// is a loop inside one CTA per (q tile of 64 rows, head, batch row), 4 warps
// of 16 query rows each, two CTAs an SM, so the state stays in registers.
//   - Q.K^T runs as mma.sync m16n8k16 on the raw bf16 q and k with f32
//     accumulation: a bf16 x bf16 product is exact in f32, so only the order
//     of the sums differs from the reference, which scales q in f32 first;
//     here the f32 scores are scaled after the product, by hd^-1/2 log2(e),
//     and the softmax runs in base 2 (exp2(x log2 e - m log2 e) is exp(x -
//     m)): a few roundings moved.  Q's A fragments are read from shared
//     memory with ldmatrix at each k-step; K tiles (kv rows x hd, row-major)
//     are already the column-major B operand, read with ldmatrix without
//     .trans.
//   - The online softmax runs in the accumulator's layout: a thread holds
//     two rows (r and r + 8) of its warp's slice, and the row max and sum
//     reduce over the 4 lanes of a quad with two shuffles; m and l stay in
//     registers.
//   - P.V runs on the tensor cores without rounding P to bf16 once: P is
//     split into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and P_hi.V +
//     P_lo.V accumulate in f32 (two MMAs, about 16 mantissa bits of P; the
//     reference computes p @ v in f32, and one rounding of P would widen the
//     prefill -> decode handoff gap).  The A fragments of P are built from
//     the Q.K^T accumulator registers (no shared-memory round trip); V tiles
//     are read with ldmatrix.trans.
//   - K and V tiles of 64 rows load with 16-byte cp.async.cg into a ring of
//     two stages, tile j + 1 in flight while tile j computes; rows past Skv
//     are zero-filled (src-size 0, the source address clamped to row 0).
//     Shared rows are padded by 16 bytes, so the 8 rows an ldmatrix reads
//     fall on distinct banks.
//   - Tiles above the diagonal are skipped, only tiles that reach past the
//     diagonal or Skv are masked, a warp skips a tile that lies wholly above
//     its rows (identical to computing it: its p would be exactly 0), the
//     heaviest q tiles run first (blockIdx.x reversed), and rows >= Sq are
//     not stored.
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
// takes about 0.46 ms on an H100 80GB HBM3 at 700 W, about 3x scaled
// dot-product attention (PERF.md): its MMAs run at about 230 of the 640
// TFLOP/s mma.sync reaches, and other tilings (tools/b5_tiles.py: 8 warps,
// kv tiles of 32 rows, rings of 3 or 4 stages) are slower.  What holds it
// back is that each warp runs its tile's two products and the softmax
// between them in sequence, with two warps a scheduler to hide the latency.
// wgmma fed by TMA, with a producer warp and two consumer warpgroups that
// overlap one's softmax with the other's products (the FA3 shape), is the
// next step.
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

// ---- bf16 on the tensor cores ----------------------------------------------

constexpr int kTcWarps = 4;                 // two CTAs an SM
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBlockQ = 16 * kTcWarps;    // 16 query rows a warp
constexpr int kTcBlockKV = 64;
constexpr int kStages = 2;                  // K/V ring

typedef __nv_bfloat16 bf16;

template <int HD>
struct TcTile {
  static constexpr int kLd = HD + 8;        // padded row, elements (16 bytes more)
  static constexpr int kQ = kTcBlockQ * kLd;
  static constexpr int kKV = kTcBlockKV * kLd;
  static constexpr int kBytes =
      static_cast<int>(sizeof(bf16)) * (kQ + 2 * kStages * kKV);
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

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y); x
// takes the low half, the lower column of an A fragment register
__device__ __forceinline__ void split_hi_lo(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Start copying `rows` rows [r0, r0 + rows) of one head (row stride `stride`
// elements) into dst (padded rows), zeros past n_rows.
template <int HD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int rows,
                                                int r0, int n_rows, size_t stride) {
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

template <int HD, bool kCap>
__global__ void __launch_bounds__(kTcThreads, 2)
flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                          int causal, int window, float softcap, float sm_scale) {
  constexpr int kLd = TcTile<HD>::kLd;
  constexpr int kKSteps = HD / 16;          // k16 steps of Q.K^T
  constexpr int kNB = kTcBlockKV / 8;       // n8 blocks of scores
  constexpr int kDB = HD / 8;               // n8 blocks of the output
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TcTile<HD>::kQ;           // [kStages][kTcBlockKV][kLd]
  bf16* Vs = Ks + kStages * TcTile<HD>::kKV;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;                 // fragment row (and row + 8)
  const int tig = lane % 4;                 // fragment column pair
  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qi * kTcBlockQ;
  const int offset = Skv - Sq;
  const size_t q_stride = static_cast<size_t>(H) * HD;
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  // scores in base 2: exp(x - m) = exp2(x log2(e) - m log2(e))
  const float scale2 = sm_scale * kLog2e;

  const bf16* qb = q + (static_cast<size_t>(b) * Sq * H + h) * HD;
  const bf16* kb = k + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;
  const bf16* vb = v + (static_cast<size_t>(b) * Skv * KV + kvh) * HD;

  // the last kv row any query of this tile may see, the first kv tile its
  // first query may see in a window; this warp's 16 rows
  const int kv_end = causal ? min(Skv, min(q0 + kTcBlockQ, Sq) + offset) : Skv;
  const int n_tiles = (kv_end + kTcBlockKV - 1) / kTcBlockKV;
  const bool windowed = causal && window > 0;
  const int t_begin = windowed ? max(0, q0 + offset - window + 1) / kTcBlockKV : 0;
  const int n_run = n_tiles - t_begin;      // tiles t_begin .. n_tiles - 1
  const int row0 = q0 + 16 * warp;
  const int warp_last = row0 + 15 + offset;
  const int warp_first = row0 + offset;

  // one copy group per K/V tile, kStages - 1 tiles ahead (Q rides with the
  // first); groups past the last tile are empty, so the count stays fixed
  load_tile_async<HD>(Qs, qb, kTcBlockQ, q0, Sq, q_stride);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_run) {
      const int r0 = (t_begin + t) * kTcBlockKV;
      load_tile_async<HD>(Ks + t * TcTile<HD>::kKV, kb, kTcBlockKV, r0, Skv, kv_stride);
      load_tile_async<HD>(Vs + t * TcTile<HD>::kKV, vb, kTcBlockKV, r0, Skv, kv_stride);
    }
    cp_async_commit();
  }

  float acc[kDB][4];
#pragma unroll
  for (int i = 0; i < kDB; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};          // row max, base 2
  float l[2] = {0.f, 0.f};

  for (int t = 0; t < n_run; ++t) {
    const int st = t % kStages;
    const int ahead = t + kStages - 1;      // its stage was freed at the end of t - 1
    if (ahead < n_run) {
      const int r0 = (t_begin + ahead) * kTcBlockKV;
      load_tile_async<HD>(Ks + (ahead % kStages) * TcTile<HD>::kKV, kb, kTcBlockKV, r0,
                          Skv, kv_stride);
      load_tile_async<HD>(Vs + (ahead % kStages) * TcTile<HD>::kKV, vb, kTcBlockKV, r0,
                          Skv, kv_stride);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();           // tile t has landed
    __syncthreads();
    const int j0 = (t_begin + t) * kTcBlockKV;
    // a warp skips a tile wholly above its rows, or wholly below its first
    // row's window (dead for all its rows)
    if (!(causal && j0 > warp_last) &&
        !(windowed && j0 + kTcBlockKV - 1 <= warp_first - window)) {
      const bf16* Kt = Ks + st * TcTile<HD>::kKV;
      const bf16* Vt = Vs + st * TcTile<HD>::kKV;
      // S = Q K^T: each ldmatrix.x4 of K brings 16 kv rows x 16 columns of
      // hd, the B fragments of two n8 blocks
      float s[kNB][4];
#pragma unroll
      for (int i = 0; i < kNB; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks) {
        uint32_t qf[4];
        ldmatrix_x4(qf, smem_addr(Qs + (16 * warp + lane % 16) * kLd + 16 * ks
                                  + (lane / 16) * 8));
#pragma unroll
        for (int nb2 = 0; nb2 < kNB / 2; ++nb2) {
          uint32_t kf[4];
          ldmatrix_x4(kf, smem_addr(Kt + (16 * nb2 + lane % 8 + (lane / 16) * 8) * kLd
                                    + 16 * ks + ((lane / 8) % 2) * 8));
          mma_bf16(s[2 * nb2], qf, kf[0], kf[1]);
          mma_bf16(s[2 * nb2 + 1], qf, kf[2], kf[3]);
        }
      }
      // scale (capped in natural units, then to base 2); mask only a tile
      // that reaches past the diagonal or Skv, or below the window of the
      // warp's last row
      const bool edge = j0 + kTcBlockKV > Skv ||
                        (causal && j0 + kTcBlockKV - 1 > warp_first) ||
                        (windowed && j0 <= warp_last - window);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kCap)
            s[nb][e] = tanhf(s[nb][e] * sm_scale / softcap) * softcap * kLog2e;
          else
            s[nb][e] *= scale2;
          if (edge) {
            const int k_pos = j0 + 8 * nb + 2 * tig + (e & 1);
            const int q_pos = row0 + gid + 8 * (e >> 1) + offset;
            if (k_pos >= Skv || (causal && k_pos > q_pos) ||
                (windowed && k_pos <= q_pos - window))
              s[nb][e] = kNegInf;
          }
        }
      }
      // online softmax of rows gid (e 0, 1) and gid + 8 (e 2, 3)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nb][e] = exp2f(s[nb][e] - m[e >> 1]);
          sum[e >> 1] += s[nb][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * corr[r] + sum[r];
      }
#pragma unroll
      for (int db = 0; db < kDB; ++db) {
        acc[db][0] *= corr[0]; acc[db][1] *= corr[0];
        acc[db][2] *= corr[1]; acc[db][3] *= corr[1];
      }
      // O += P_hi V + P_lo V; the A fragment of kv rows 16 kk .. 16 kk + 15
      // is the accumulators of score blocks 2 kk and 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < kTcBlockKV / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_hi_lo(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_hi_lo(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_hi_lo(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_hi_lo(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int db2 = 0; db2 < kDB / 2; ++db2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, smem_addr(Vt + (16 * kk + lane % 16) * kLd + 16 * db2
                                          + (lane / 16) * 8));
          mma_bf16(acc[2 * db2], ph, vf[0], vf[1]);
          mma_bf16(acc[2 * db2 + 1], ph, vf[2], vf[3]);
          mma_bf16(acc[2 * db2], pl, vf[0], vf[1]);
          mma_bf16(acc[2 * db2 + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                        // stage st is free for tile t + kStages
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + gid + 8 * r;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && tig == 0)   // natural units: m and l are base 2
      lse[(static_cast<size_t>(b) * H + h) * Sq + row] = (m[r] + log2f(l[r])) * kLn2;
    bf16* orow = o + ((static_cast<size_t>(b) * Sq + row) * H + h) * HD + 2 * tig;
#pragma unroll
    for (int db = 0; db < kDB; ++db)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * db) =
          __floats2bfloat162_rn(acc[db][2 * r] / denom, acc[db][2 * r + 1] / denom);
  }
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
              int Sq, int Skv, int H, int KV, int causal, int window, float softcap,
              float sm_scale, cudaStream_t stream) {
  constexpr int kSmem = TcTile<HD>::kBytes;
  auto kernel = softcap != 0.f ? flash_attention_tc_kernel<HD, true>
                               : flash_attention_tc_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + kTcBlockQ - 1) / kTcBlockQ, H, B);
  kernel<<<grid, kTcThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Sq, Skv, H, KV, causal,
      window, softcap, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(int hd, const void* q, const void* k, const void* v, void* o, float* lse,
                int B, int Sq, int Skv, int H, int KV, int causal, int window,
                float softcap, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_tc<16>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                                 sm_scale, stream);
    case 32: return launch_tc<32>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                                 sm_scale, stream);
    case 64: return launch_tc<64>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                                 sm_scale, stream);
    case 128: return launch_tc<128>(q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                                 sm_scale, stream);
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
    return dispatch_tc(hd, q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, softcap,
                       sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
