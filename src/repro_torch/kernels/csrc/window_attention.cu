// Swin window attention for Hopper (sm_90a): B1 on a persistent kernel built
// for Hopper (windows up to 8) and, for windows 9-12 and for B7, a per-window
// body on mma.sync; every product on the tensor cores.
//
// B1, fused_window_attention_fwd, replaces src/repro/kernels/
// window_attention.py :: fused_window_attention_pallas (bodies
// _fused_kernel_noshift / _fused_kernel_shift, math in _band_attention).
// One launch covers the cyclic shift by (-shift, -shift), the partition into
// windows, softmax(q hd^-1/2 k^T + bias, mask -> -1e9) v per window and
// head, the un-partition and the roll back, from the image-layout qkv (B,
// Hp, Wp, 3C) to the image-layout output (B, Hp, Wp, C), f32 or bf16 in and
// out: as the TPU kernel, f32 logits, softmax and P.V, one rounding at the
// store.
//
// B7, window_attention_fwd, replaces src/repro/kernels/window_attention.py ::
// window_attention_pallas (body _window_kernel) behind ops.window_attention:
// the same attention on q, k, v already partitioned into windows,
// (nB, w2, nh, hd) each, with a (nh, w2, w2) bias and an optional
// (nB, w2, w2) mask, f32 or bf16 in and out.
//
// Bound on the H100.  Bytes: each input element read once, each output
// written once, at 3.35 TB/s; the work is about 4 w2^2 hd flop a (window,
// head), 12 flop a byte at Swin-T's w2 = 49, hd = 32 in f32 (24 in bf16),
// far under the tensor cores' ridge.  A Swin-T forward's 12 B1 calls move
// 220 MB at batch 4 in f32, 0.2633 ms (stage 0: 176 MB, 0.0525 ms), half
// that in bf16 (chip_smoke.py computes the bound of each call).
//
// B1's route by window: up to 8 (w2 <= 64; every configuration of the
// repository uses 7) the persistent kernel below; 9-12 the per-window
// kernel of the first design, on attend_warp.
//
// The persistent kernel (fused_window_attention_wgmma_kernel).  Tiles are
// (head, image, window), one window's 64 query rows (w2 padded) of one
// head.  The design answers what held the per-window kernel back:
//   1. Nothing overlapped inside a CTA, one CTA a tile.  Now one CTA an SM
//      walks a contiguous run of tiles, the head slowest (a short call
//      spreads its tiles over every SM: the grid is min(tiles, SMs)).  A
//      producer warp loads tiles into stages while consumer warpgroups (2
//      in f32, 3 in bf16: as many as the registers of a scheduler allow,
//      168 and 128 a thread) each take every NC-th tile of the run.  Each
//      consumer has its own ring of kWgRing stages (2), so a stage's fills
//      are taken by one consumer in order and no wait by parity can meet a
//      fill two phases behind.  A layout past the shared memory a CTA may
//      have is refused (cudaErrorInvalidConfiguration); none of w2 <= 64,
//      hd 16 or 32 is.
//      Loads: where the rolled window does not wrap, one TMA box per q, k
//      and v over qkv seen as (hd, 3 nh, Wp, B Hp), 7 x 7 rows of one
//      head's hd values, written with the swizzle of a row's bytes (128 or
//      64 in f32, 64 or 32 in bf16); where it wraps (the last window row or
//      column of a shifted map), 16-byte cp.async pieces at the offsets TMA
//      would write, token by token from (row0 + i) % Hp, (col0 + j) % Wp.
//      No roll is ever materialised.  Each lane's cp.async arrival (noinc)
//      and lane 0's expected TMA bytes complete the stage's full barrier.
//   2. Every CTA re-read its head's bias and its window's mask with
//      scattered loads.  Now each consumer holds its head's bias in shared
//      memory in its accumulator order (a float4 a thread a key block, -inf
//      for padded keys), written once a head in its run; f32's S starts at
//      it.  The window's mask bytes arrive in the stage with the rows (the
//      16-byte pieces around them, cp.async with a byte count at the
//      tensor's end); an unmasked call loads none.  A thread reads its
//      2 x N/2 bytes at offsets fixed for the run and drops those of padded
//      rows and keys.
//   3. 3xTF32 on mma.sync, the softmax between the products in one warp.
//      Now both products run on wgmma with f32 sums.  f32: S = Q K^T as
//      m64nNk8 TF32 (N = 56 keys, 64 at window 8), A = q hd^-1/2 split into
//      hi and lo in registers (ldmatrix: a pair of bf16 is one f32), B =
//      K_hi and K_lo, which the consumer splits from the stage into tiles
//      of its own with the same swizzle; P.V as m64n{hd}k8 on V^T_hi and
//      V^T_lo, staged transposed by the consumer (TF32 takes B K-major
//      only), key 8j + 2u + e at position 8j + u + 4e so that S's
//      accumulator registers are P's A fragments.  Each k8 step takes
//      lo.hi, hi.lo, hi.hi on one accumulator, the order of the per-window
//      body (tests/test_torch_window_tc.py mirrors it).  Splits round to
//      TF32 on the bit pattern, cvt.rna's result in two integer operations.
//      bf16: S = q k^T as m64n64k16 on the stage's rows (exact products),
//      scaled by hd^-1/2 and biased in f32 afterwards (the reference scales
//      q first: f32 rounding apart, far inside the bf16 tolerance); P.V as
//      P_hi.V + P_lo.V (P split into two bf16) on m64n{hd}k16 with V
//      MN-major in the stage; keys padded to 64 with zero value rows.  The
//      logits never leave registers: bias, mask (-1e9), padded keys (-inf),
//      row max and sum over a quad, exp as 2^((x - m) log2 e) on MUFU.EX2,
//      the output scaled by 1 / sum after P.V.  The products sit on one
//      straight path (the warp index is read through a shuffle), so ptxas
//      keeps them asynchronous.
//   4. Padding: 49 query rows are 64 (one m64 product) and keys 56 in f32,
//      64 in bf16 (P.V's k16 steps); padded rows of the stage and of the
//      split tiles are zero from the start and never written again.
//   5. The wrapper's host time: the raw stream handle shared with the codec
//      wrappers (_build.current_stream), no copy of an operand that is
//      already contiguous; the tensor map is encoded a call on the host.
// Each output element is written by one tile (registers straight to the
// un-rolled pixel, a quad's pairs contiguous): no atomics, and two launches
// give the same bits.  Shared memory a CTA, hd 32, masked (w2 = 49): f32 2
// consumers x 44 KB (K_hi, K_lo 7 KB each, V^T_hi, V^T_lo 8 KB each, bias
// 14 KB) and 4 stages x 24 KB (q, k, v 7 KB each, mask 3 KB): 185 KB; bf16 3
// consumers x 16 KB (bias) and 6 stages x 15 KB (q, k, v 4 KB each, mask 3
// KB): 139 KB.  tools/b1_tiles.py builds copies of this file with other
// values of the levers (consumers, CTAs an SM, ring stages, TMA against
// cp.async), three probes and a cycle count of a tile's phases, each by
// replacing text, to measure what each is worth.
//
// The per-window kernel (B1 at windows 9-12, and B7): one CTA of 4 warps per
// (window, head[, image]).  The CTA copies its w2 key and value rows and a
// run of 64 query rows into shared memory with cp.async, in the input's
// type, and each warp runs the shared body, attend_warp, on 16 query rows:
//   - Both products run on mma.sync.m16n8k8 TF32 with f32 accumulation, as
//     3xTF32: every f32 operand x is split into hi = cvt.rna.tf32(x) and
//     lo = cvt.rna.tf32(x - hi), and a.b is taken as lo.hi + hi.lo + hi.hi
//     (three MMAs on one accumulator, the small terms first).  That keeps
//     about 22 of f32's 24 mantissa bits; one TF32 product keeps 11 and
//     misses the f32 tolerance (tests/test_torch_window_tc.py holds a CPU
//     mirror of this arithmetic and, on a card, the kernels against it;
//     tests/test_torch_kernels.py holds the mirror against the JAX package
//     and shows the single product missing).  q is multiplied by hd^-1/2 in
//     f32 before its split, as the reference scales it.  bf16 K and V are
//     exact in TF32 (lo = 0), so their hi.lo product is skipped: two MMAs a
//     product where f32 takes three.
//   - Tiles are padded in registers and shared memory only: query rows to a
//     multiple of 16, keys to 8 NT (NT = 7 key tiles for w2 <= 56, else
//     18).  Padded key and value rows are zero in shared memory, padded keys
//     are scored -INFINITY so they weigh exactly 0 on every row, padded
//     query rows are zero and never stored.
//   - The logits never leave registers.  The accumulator starts at the
//     bias, loaded while the rows are still in flight; the mask is applied
//     in the accumulator's layout; row max and sum reduce over the 4 lanes
//     of a quad; exp is expf; the output is scaled by 1 / sum after P.V.
//     Inside each k8 step key 8j + 2t plays k = t and key 8j + 2t + 1 plays
//     k = t + 4, so the accumulator registers of S are the A fragment of P.
//   - Shared rows carry 16 bytes of padding, so the fragment loads fall on
//     32 banks.  Rows move 16 bytes a thread.  B1 gathers its rows with
//     modular indices, one per token, into a table in shared memory; B7
//     reads its window's rows in place.  The shared tile is 16 NT + 64 rows
//     of HD values and their padding: 186 KB at w2 = 144, hd = 128, under
//     the 227 KB a CTA may have.  w2 is at most 144.
//
// The TPU op behind B7 pads w2 up to W2P = ceil(w2 / 64) * 64 with keys that
// every real query sees masked (-1e9) and value rows of zero.  On a row
// with at least one allowed key those keys weigh exp(-1e9 - max) = 0; on a
// row whose keys are all masked they weigh as much as the real ones, and
// the op returns sum(v) / W2P.  B7 adds (W2P - w2) * exp(-1e9 - max) to each
// row's softmax denominator, which is the op's result on both kinds of row;
// its own tile padding stays at -INFINITY and adds nothing.  B1's TPU
// kernel never sees such a row (every Swin query may attend to itself), and
// B1 adds nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRunRows = 16 * kWarps;     // query rows a CTA stages at a time
constexpr int kMaxW2 = 144;
constexpr int kSmallTiles = 7;            // n8 key tiles for w2 <= 56 (Swin's 49)
constexpr float kMaskedLogit = -1e9f;     // the reference's NEG_INF, not -inf
constexpr size_t kMaxSmem = 232448;       // dynamic shared memory a CTA may use

// Shared rows of a head's HD values of type T: 16 bytes of padding a row, so
// the fragment loads of attend_warp fall on 32 distinct banks
template <int HD, typename T>
struct Tile {
  static constexpr int kElems = 16 / sizeof(T);   // elements in 16 bytes
  static constexpr int kLd = HD + kElems;         // row stride, elements
  static constexpr int kVec = HD / kElems;        // 16-byte pieces of a row
};

template <int NT>
__host__ __device__ constexpr int mask_words() { return (4 * NT + 31) / 32; }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !valid (src-size 0:
// nothing is read; src then points into the tensor all the same)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo + (what 3xTF32 drops): hi and lo rounded to TF32, to nearest
// with ties away from zero
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// the split of a B operand; a bf16 value is its own hi, with lo = 0
template <bool kExact>
__device__ __forceinline__ void split_b(float x, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    split_tf32(x, hi, lo);
  }
}

// d += a (16 x 8, row-major) * b (8 x 8, column-major), TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b as 3xTF32: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi; b_lo is zero,
// and its product skipped, when b is exact in TF32
template <bool kExactB>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  if (!kExactB) mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The logits' start for one warp's 16 query rows from window row row0, in
// the accumulator layout (rows g and g + 8, columns 2t and 2t + 1 of each n8
// tile): the head's bias, and one bit in `dead` for each logit the window's
// mask (null = none) forbids.  Global loads only, so a warp issues them
// while its CTA's rows are still on the way to shared memory.
template <int NT>
__device__ __forceinline__ void start_logits(float (&s)[NT][4],
                                             uint32_t (&dead)[mask_words<NT>()],
                                             const float* __restrict__ bias_h,
                                             const uint8_t* __restrict__ mask_w,
                                             int row0, int w2) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < mask_words<NT>(); ++i) dead[i] = 0u;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e >> 1);
      const int c = 8 * j + 2 * t + (e & 1);
      float b = 0.f;
      if (r < w2 && c < w2) {
        const int idx = r * w2 + c;
        b = bias_h[idx];
        if (mask_w != nullptr && mask_w[idx] == 0)
          dead[(4 * j + e) / 32] |= 1u << ((4 * j + e) % 32);
      }
      s[j][e] = b;
    }
  }
}

// softmax(q k^T + bias, mask -> -1e9) v for one warp's 16 query rows, the
// body both kernels share.  s, dead: from start_logits.  q_w: the warp's
// rows of q as read (row stride Tile::kLd), zero past w2; on return they
// hold the warp's output rows in T.  k_s, v_s: 8 NT key and value rows,
// zero past w2.  q is scaled by sm_scale in f32 before its split, as the
// reference scales it.  pad_keys extra keys at -1e9 with value rows of zero
// join each row's denominator.  All NT n8 tiles of keys are computed, the
// padded ones on zero rows: no branch splits the unrolled loops.
template <int HD, int NT, typename T>
__device__ __forceinline__ void attend_warp(float (&s)[NT][4],
                                            const uint32_t (&dead)[mask_words<NT>()],
                                            T* q_w, const T* k_s, const T* v_s,
                                            float sm_scale, int w2, float pad_keys) {
  constexpr int kLd = Tile<HD, T>::kLd;
  constexpr bool kExactKV = sizeof(T) == 2;  // bf16 is exact in TF32
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  // S += Q K^T, one k8 step of the head dim at a time
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += 8) {
    uint32_t ah[4], al[4];
    const T* qa = q_w + g * kLd + k0 + t;
    split_tf32(to_f32(qa[0]) * sm_scale, ah[0], al[0]);
    split_tf32(to_f32(qa[8 * kLd]) * sm_scale, ah[1], al[1]);
    split_tf32(to_f32(qa[4]) * sm_scale, ah[2], al[2]);
    split_tf32(to_f32(qa[8 * kLd + 4]) * sm_scale, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const T* kb = k_s + (8 * j + g) * kLd + k0 + t;
      uint32_t bh[2], bl[2];
      split_b<kExactKV>(to_f32(kb[0]), bh[0], bl[0]);
      split_b<kExactKV>(to_f32(kb[4]), bh[1], bl[1]);
      mma_3xtf32<kExactKV>(s[j], ah, al, bh, bl);
    }
  }

  // mask, then the softmax of each row over the 4 lanes of its quad
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e];
      if (8 * j + 2 * t + (e & 1) >= w2) {
        x = -INFINITY;                      // a padded key weighs exactly 0
      } else if ((dead[(4 * j + e) / 32] >> ((4 * j + e) % 32)) & 1u) {
        x = kMaskedLogit;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[j][e] - mx[e >> 1]);
      s[j][e] = p;
      sum[e >> 1] += p;
    }
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    if (pad_keys > 0.f) sum[i] += pad_keys * expf(kMaskedLogit - mx[i]);
    inv[i] = 1.f / sum[i];
  }

  // O = (E V) / sum.  Within the k8 step of keys 8j..8j+7, key 8j + 2t
  // plays k = t and key 8j + 2t + 1 plays k = t + 4: S's accumulator
  // registers are then E's A fragment as they stand
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ah[4], al[4];
    split_tf32(s[j][0], ah[0], al[0]);
    split_tf32(s[j][2], ah[1], al[1]);
    split_tf32(s[j][1], ah[2], al[2]);
    split_tf32(s[j][3], ah[3], al[3]);
    const T* vb = v_s + (8 * j + 2 * t) * kLd + g;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      uint32_t bh[2], bl[2];
      split_b<kExactKV>(to_f32(vb[8 * d]), bh[0], bl[0]);
      split_b<kExactKV>(to_f32(vb[kLd + 8 * d]), bh[1], bl[1]);
      mma_3xtf32<kExactKV>(o[d], ah, al, bh, bl);
    }
  }

  __syncwarp();                             // every lane is done with q_w
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    T* dst = q_w + g * kLd + 8 * d + 2 * t;
    put2(dst, o[d][0] * inv[0], o[d][1] * inv[0]);
    put2(dst + 8 * kLd, o[d][2] * inv[1], o[d][3] * inv[1]);
  }
  __syncwarp();
}

// bytes of shared memory for 8 NT keys at head dim HD in T, and `extra` more
template <int HD, int NT, typename T>
size_t smem_bytes(size_t extra) {
  return static_cast<size_t>(16 * NT + kRunRows) * Tile<HD, T>::kLd * sizeof(T) + extra;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ---------------------------------------------------------------------------
// B1: fused shift + partition + attention + un-partition, fp32 or bf16 in and
// out
// ---------------------------------------------------------------------------

template <int HD, int NT, typename T>
__global__ void __launch_bounds__(kThreads)
fused_window_attention_kernel(const T* __restrict__ qkv,
                              const float* __restrict__ bias,
                              const uint8_t* __restrict__ mask,
                              T* __restrict__ out, int Hp, int Wp, int C,
                              int window, int shift, float sm_scale) {
  using Tl = Tile<HD, T>;
  constexpr int kLd = Tl::kLd;
  constexpr int kVec = Tl::kVec;
  constexpr int kElems = Tl::kElems;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int w2 = window * window;
  const int nww = Wp / window;
  const int win = blockIdx.x;               // window index in rolled coordinates
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = (win / nww) * window + shift;
  const int col0 = (win % nww) * window + shift;
  const size_t C3 = 3 * static_cast<size_t>(C);

  T* k_s = smem;                            // (8 NT, kLd), zero past w2
  T* v_s = k_s + 8 * NT * kLd;
  T* q_s = v_s + 8 * NT * kLd;              // (kRunRows, kLd): q, then the output
  int* pix = reinterpret_cast<int*>(q_s + kRunRows * kLd);  // (w2) token -> pixel

  for (int t = threadIdx.x; t < w2; t += kThreads) {
    const int r = (row0 + t / window) % Hp;
    const int c = (col0 + t % window) % Wp;
    pix[t] = (b * Hp + r) * Wp + c;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < 8 * NT * kVec; idx += kThreads) {
    const int t = idx / kVec;
    const int c = (idx % kVec) * kElems;
    const bool ok = t < w2;
    const T* src = qkv + (ok ? pix[t] * C3 + h * HD + c : 0);
    cp_async16(k_s + t * kLd + c, src + C, ok);
    cp_async16(v_s + t * kLd + c, src + 2 * C, ok);
  }

  const float* bias_h = bias + static_cast<size_t>(h) * w2 * w2;
  const uint8_t* mask_w =
      mask != nullptr ? mask + static_cast<size_t>(win) * w2 * w2 : nullptr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* q_w = q_s + 16 * warp * kLd;
  for (int r0 = 0; r0 < w2; r0 += kRunRows) {
    for (int idx = threadIdx.x; idx < kRunRows * kVec; idx += kThreads) {
      const int t = idx / kVec;
      const int c = (idx % kVec) * kElems;
      const bool ok = r0 + t < w2;
      cp_async16(q_s + t * kLd + c, qkv + (ok ? pix[r0 + t] * C3 + h * HD + c : 0), ok);
    }
    const int m0 = r0 + 16 * warp;
    float s[NT][4];
    uint32_t dead[mask_words<NT>()];
    if (m0 < w2) start_logits<NT>(s, dead, bias_h, mask_w, m0, w2);
    cp_async_wait_all();
    __syncthreads();                        // K and V too, on the first run
    if (m0 < w2) {
      attend_warp<HD, NT>(s, dead, q_w, k_s, v_s, sm_scale, w2, 0.f);
      for (int idx = lane; idx < 16 * kVec; idx += 32) {
        const int t = idx / kVec;
        const int c = (idx % kVec) * kElems;
        if (m0 + t < w2)
          *reinterpret_cast<uint4*>(out + pix[m0 + t] * static_cast<size_t>(C) + h * HD + c) =
              *reinterpret_cast<const uint4*>(q_w + t * kLd + c);
      }
    }
    __syncthreads();                        // q_s is refilled by the next run
  }
}

template <int HD, int NT, typename T>
cudaError_t launch_fused(const T* qkv, const float* bias, const uint8_t* mask,
                         T* out, int B, int Hp, int Wp, int C, int n_heads,
                         int window, int shift, float sm_scale, cudaStream_t stream) {
  const int w2 = window * window;
  const size_t smem = smem_bytes<HD, NT, T>(w2 * sizeof(int));
  const cudaError_t err = allow_smem(fused_window_attention_kernel<HD, NT, T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Hp / window) * (Wp / window), n_heads, B);
  fused_window_attention_kernel<HD, NT, T><<<grid, kThreads, smem, stream>>>(
      qkv, bias, mask, out, Hp, Wp, C, window, shift, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B1 at windows up to 8 (w2 <= 64): persistent and warp-specialised, both
// products on wgmma (the source note above)
// ---------------------------------------------------------------------------

constexpr int kWgConsumers = 128;          // threads of a consumer warpgroup
constexpr int kWgRing = 2;                 // stages of each consumer's own ring

// Consumer warpgroups a CTA: f32's take up to 168 registers a thread, so 2
// (9 warps with the producer's, at most 3 on each of the SM's four
// schedulers, whose register files hold 16,384 each); bf16's fit in 128,
// so 3 (13 warps, 4 on one scheduler)
template <typename T>
__host__ __device__ constexpr int wg_consumers() {
  return sizeof(T) == 4 ? 2 : 3;
}

template <typename T>
__host__ __device__ constexpr int wg_threads() { return kWgConsumers * wg_consumers<T>() + 32; }

// One head's slice of a pixel: kRB bytes (128 or 64 in f32, 64 or 32 in
// bf16), a row of the tiles in shared memory, which carry the swizzle of
// kRB bytes.  A stage holds N rows of each of q, k, v (N the keys of S,
// >= w2; bf16 wgmma reads them all, so rows past w2 stay zero)
template <int HD, typename T, int N>
struct WgGeom {
  static constexpr int kRB = HD * static_cast<int>(sizeof(T));
  static constexpr int kPieces = kRB / 16;                  // 16-byte pieces a row
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  static constexpr int kPart = N * kRB;                     // q, k or v of a stage
};

// Byte offset `off` of a tile with rows of S bytes under the swizzle of S
// bytes (TMA's and wgmma's): within each 1,024 bytes, 16-byte piece bits
// 4.. XOR-ed with the row bits 7..
template <int S>
__host__ __device__ constexpr uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (S / 16 - 1)) << 4);
}

__host__ __device__ constexpr uint32_t round1k(uint32_t n) { return (n + 1023) & ~1023u; }

// Shared memory of a CTA, in bytes from a 1,024-aligned base: `stages`
// stages of q, k, v rows and the window's mask bytes; then for each
// consumer, in f32, the split operands K_hi, K_lo (N rows) and V^T_hi,
// V^T_lo (hd rows of 64 key positions in two 128-byte blocks), and the
// head's bias in the accumulator's order (N/8 float4 a thread); then the
// full and empty barriers.
struct WgLayout {
  uint32_t stage, mask, khi, klo, vhi, vlo, bias, consumer, bars, bytes;
};

template <int HD, typename T, int N>
__host__ __device__ inline WgLayout wg_layout(int w2, bool masked, int stages) {
  using G = WgGeom<HD, T, N>;
  constexpr bool kF32 = sizeof(T) == 4;
  WgLayout L;
  L.mask = 3 * G::kPart;
  L.stage = round1k(L.mask + (masked ? w2 * w2 + 32 : 0));
  uint32_t o = stages * L.stage;            // consumer 0's tiles
  L.khi = o;
  o += kF32 ? round1k(G::kPart) : 0;
  L.klo = o;
  o += kF32 ? round1k(G::kPart) : 0;
  L.vhi = o;
  o += kF32 ? 2 * HD * 128 : 0;
  L.vlo = o;
  o += kF32 ? 2 * HD * 128 : 0;
  L.bias = o;
  o += (N / 8) * kWgConsumers * 16;
  L.consumer = o - stages * L.stage;        // the next consumer's, this far on
  L.bars = o + (wg_consumers<T>() - 1) * L.consumer;
  L.bytes = L.bars + 16 * stages + 1024;    // and the slack that aligns the base
  return L;
}

// x rounded to TF32 to nearest, ties away from zero, on the bit pattern:
// cvt.rna.tf32.f32's result for every finite x, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// split_tf32 by tf32_rna: x = hi + lo + (what 3xTF32 drops)
__device__ __forceinline__ void split_rna(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// four f32 as TF32 hi and lo, bit patterns
__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  split_rna(x.x, hi.x, lo.x);
  split_rna(x.y, hi.y, lo.y);
  split_rna(x.z, hi.z, lo.z);
  split_rna(x.w, hi.w, lo.w);
}

// 2^x by the hardware's approximation alone (MUFU.EX2), outputs below
// 2^-126 flushed to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A CTA's walk over tiles (head, image, window) with the head slowest, and
// the window's first row and column in rolled coordinates: advanced by
// carries, no division a tile
struct TileWalk {
  int h, b, wr, wc;
  __device__ void start(int tile, int B, int nwh, int nww) {
    const int per_head = B * nwh * nww;
    h = tile / per_head;
    const int rest = tile % per_head;
    b = rest / (nwh * nww);
    wr = rest % (nwh * nww) / nww;
    wc = rest % nww;
  }
  __device__ void advance(int n, int B, int nwh, int nww) {
    for (wc += n; wc >= nww; wc -= nww)
      if (++wr == nwh) {
        wr = 0;
        if (++b == B) {
          b = 0;
          ++h;
        }
      }
  }
  __device__ int win(int nww) const { return wr * nww + wc; }
};

// whether a tile's rolled window lies inside the map (TMA loads it as
// boxes) rather than wrapping round its last row or column (cp.async)
__device__ __forceinline__ bool by_tma(int row0, int col0, int window, int Hp, int Wp) {
  return row0 + window <= Hp && col0 + window <= Wp;
}

// r wrapped into [0, n) from [0, 2 n)
__device__ __forceinline__ int wrap(int r, int n) { return r >= n ? r - n : r; }

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y); x
// takes the low half, the lower column of an A fragment register
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int HD, typename T, int N>
__global__ void __launch_bounds__(wg_threads<T>(), 1)
fused_window_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tmap,
                                    const T* __restrict__ qkv, const float* __restrict__ bias,
                                    const uint8_t* __restrict__ mask, long long mask_bytes,
                                    T* __restrict__ out, int B, int Hp, int Wp, int C,
                                    int n_heads, int window, int shift, float sm_scale,
                                    int tiles) {
  using namespace hopper;
  using G = WgGeom<HD, T, N>;
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kRB = G::kRB;
  constexpr int NB = N / 8;                 // n8 blocks of keys in S
  constexpr int NC = wg_consumers<T>();
  constexpr int kStages = NC * kWgRing;
  const int w2 = window * window;
  const int nwh = Hp / window;
  const int nww = Wp / window;
  const bool masked = mask != nullptr;
  const WgLayout L = wg_layout<HD, T, N>(w2, masked, kStages);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);      // the base, as a generic pointer
  auto full = [&](int st) { return base + L.bars + 8 * st; };
  auto empty = [&](int st) { return base + L.bars + 8 * (kStages + st); };

  // zero what the products read and nothing writes: in bf16 the stages'
  // q, k, v rows past w2, in f32 the consumers' split tiles (their rows
  // and key columns past w2).  0 x a stale NaN would be NaN
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kF32) {
    for (uint32_t c = 0; c < NC; ++c)
      for (uint32_t i = 16 * threadIdx.x; i < L.bias - L.khi; i += 16 * wg_threads<T>())
        *reinterpret_cast<uint4*>(sm + L.khi + c * L.consumer + i) = zero;
  } else {
    const uint32_t pad = (N - w2) * kRB;          // bytes past w2 of q, k or v
    for (uint32_t i = 16 * threadIdx.x; i < 3 * kStages * pad; i += 16 * wg_threads<T>())
      *reinterpret_cast<uint4*>(sm + i / pad * G::kPart + i % pad + w2 * kRB +
                                (i / pad / 3) * (L.stage - 3 * G::kPart)) = zero;
  }
  fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 33);              // the producer's lane 0 and its 32 cp.async arrivals
      mbar_init(empty(st), 4);              // a lane of each consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // this CTA's run of tiles, tile = (head, image, window) with the head
  // slowest: a run keeps one head (or two) and its bias
  const int t_begin = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / gridDim.x);
  const int t_end = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x);
  // the warp, through a shuffle: the compiler then knows it uniform, and the
  // products under the branch on it stay asynchronous
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int lane = threadIdx.x % 32;
  const size_t C3 = 3 * static_cast<size_t>(C);

  // tile i of the run goes to consumer i % NC, into stage ring_stage(i) of
  // that consumer's own ring of kWgRing stages: each stage's fills are then
  // taken by one consumer in order, so a wait by parity never meets a fill
  // two phases behind
  auto ring_stage = [](int i) { return i % NC + NC * (i / NC % kWgRing); };
  auto ring_phase = [](int i) { return static_cast<uint32_t>(i / NC / kWgRing) & 1u; };

  if (warp == 4 * NC) {
    // producer: fills each tile's stage with the tile's q, k, v rows (a TMA
    // box each where the window does not wrap, else 16-byte cp.async pieces
    // at the swizzled offsets TMA would write) and its mask bytes
    // (cp.async); every lane's cp.async arrival and lane 0's expected bytes
    // complete the stage's full barrier
    // each lane's (part, token) pairs of a tile's cp.async rows, fixed
    constexpr int kPairs = (3 * N + 31) / 32;
    int pair_row[kPairs], pair_col[kPairs], pair_src[kPairs], pair_dst[kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int idx = lane + 32 * k;
      const int part = idx / w2;
      const int tok = idx % w2;
      pair_row[k] = idx < 3 * w2 ? tok / window : -1;
      pair_col[k] = tok % window;
      pair_src[k] = part * C;
      pair_dst[k] = part * G::kPart + tok * kRB;
    }
    TileWalk at;
    at.start(t_begin, B, nwh, nww);
    for (int tile = t_begin, i = 0; tile < t_end;
         ++tile, ++i, at.advance(1, B, nwh, nww)) {
      const int st = ring_stage(i);
      const int h = at.h, b = at.b, win = at.win(nww);
      const int row0 = at.wr * window + shift;
      const int col0 = at.wc * window + shift;
      const bool box = by_tma(row0, col0, window, Hp, Wp);
      const uint32_t stage = base + st * L.stage;
      mbar_wait(empty(st), ring_phase(i) ^ 1u);
      if (lane == 0) {
        mbar_arrive_expect_tx(full(st), box ? 3 * w2 * kRB : 0);
        if (box) {
#pragma unroll
          for (int part = 0; part < 3; ++part)
            tma_load_4d(stage + part * G::kPart, &tmap, full(st), 0, part * n_heads + h, col0,
                        b * Hp + row0);
        }
      }
      if (!box) {
#pragma unroll
        for (int k = 0; k < kPairs; ++k) {
          if (pair_row[k] < 0) continue;
          const int r = wrap(row0 + pair_row[k], Hp);
          const int c = wrap(col0 + pair_col[k], Wp);
          const T* src = qkv + (static_cast<size_t>(b * Hp + r) * Wp + c) * C3 + pair_src[k] + h * HD;
#pragma unroll
          for (int p = 0; p < G::kPieces; ++p)
            hopper::cp_async16(stage + swz<kRB>(pair_dst[k] + 16 * p), src + p * G::kElems, 16);
        }
      }
      if (masked) {
        // the window's w2 x w2 bytes from the 16-byte boundary at or before
        // them; none past the tensor's end is read
        const long long at0 = static_cast<long long>(win) * w2 * w2;
        const long long a0 = at0 & ~15ll;
        const int pieces = static_cast<int>((at0 + w2 * w2 - a0 + 15) / 16);
        for (int p = lane; p < pieces; p += 32) {
          const long long at = a0 + 16ll * p;
          hopper::cp_async16(stage + L.mask + 16 * p, mask + at,
                     static_cast<int>(mask_bytes - at < 16 ? mask_bytes - at : 16));
        }
      }
      cp_async_mbar_arrive(full(st));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumers: warpgroup cw takes tiles cw, cw + NC, ... of the
  // run, 64 query rows each (16 a warp).  A thread holds rows r = 16 wq + g
  // and r + 8 of S, columns 8 j + 2 t and 8 j + 2 t + 1 of each n8 block j:
  // s[4 j + e] is row r + 8 (e / 2), column 8 j + 2 t + e % 2
  const int cw = warp / 4;
  const int wq = warp % 4;
  const int tid = threadIdx.x % kWgConsumers;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bar_id = 1 + cw;                // named barrier of this warpgroup
  const uint32_t mine = cw * L.consumer;    // its tiles' offset
  float4* bias_s = reinterpret_cast<float4*>(sm + L.bias + mine) + (wq * NB) * 32 + lane;
  // fixed for every tile: this thread's two query rows (tokens) as (row,
  // col) in the window, -1 past w2, and its mask bytes' offsets
  int tok_row[2], tok_col[2], mask_off[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * wq + g + 8 * e;
    tok_row[e] = r < w2 ? r / window : -1;
    tok_col[e] = r % window;
    mask_off[e] = r * w2 + 2 * t;
  }
  // the logits of this thread that a mask may forbid: real rows and keys
  uint32_t live = 0u;
#pragma unroll
  for (int x = 0; x < N / 2; ++x) {
    const int c = 8 * (x / 4) + 2 * t + (x & 1);
    if (tok_row[(x >> 1) & 1] >= 0 && c < w2) live |= 1u << x;
  }
  int cur_h = -1;
  TileWalk at;
  at.start(t_begin + cw, B, nwh, nww);
  for (int tile = t_begin + cw, i = cw; tile < t_end; tile += NC, i += NC,
           at.advance(NC, B, nwh, nww)) {
    const int st = ring_stage(i);
    const int h = at.h, b = at.b, win = at.win(nww);
    const int row0 = at.wr * window + shift;
    const int col0 = at.wc * window + shift;
    const uint32_t stage = base + st * L.stage;
    const unsigned char* stage_p = sm + st * L.stage;
    float o[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
    float inv[2] = {1.f, 1.f};

    if (h != cur_h) {
      // the head's bias into this thread's own slots, in its accumulator
      // order; padded keys -inf (they weigh exactly 0), padded rows 0
      cur_h = h;
      const float* bh = bias + static_cast<size_t>(h) * w2 * w2;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * wq + g + 8 * (e >> 1);
          const int c = 8 * j + 2 * t + (e & 1);
          v[e] = c >= w2 ? -INFINITY : r < w2 ? bh[r * w2 + c] : 0.f;
        }
        bias_s[32 * j] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    mbar_wait(full(st), ring_phase(i));
    if (!kF32 && !by_tma(row0, col0, window, Hp, Wp))
      fence_proxy_async();                  // cp.async rows before wgmma reads them

    // the mask: one bit for each logit of this thread it forbids
    uint32_t dead = 0u;
    if (masked) {
      // bytes past the window's (padded rows and keys) are read as they
      // lie in shared memory and dropped by `live`
      const uint8_t* m = stage_p + L.mask + (static_cast<long long>(win) * w2 * w2 & 15);
      const uint8_t* m0 = m + mask_off[0];
      const uint8_t* m1 = m + mask_off[1];
#pragma unroll
      for (int x = 0; x < N / 2; ++x) {
        const uint8_t* row = (x >> 1) & 1 ? m1 : m0;
        if (row[8 * (x / 4) + (x & 1)] == 0) dead |= 1u << x;
      }
      dead &= live;
    }
    float s[N / 2];
    if constexpr (kF32) {
      // S starts at the bias
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float4 bv = bias_s[32 * j];
        s[4 * j] = bv.x;
        s[4 * j + 1] = bv.y;
        s[4 * j + 2] = bv.z;
        s[4 * j + 3] = bv.w;
      }
      // K and V split into TF32 hi and lo, in the operand tiles
      bar_sync(bar_id, kWgConsumers);     // the last tile's products are done with them
      constexpr int kSplits = (N * G::kPieces + kWgConsumers - 1) / kWgConsumers;
#pragma unroll
      for (int k = 0; k < kSplits; ++k) {
        const int idx = tid + kWgConsumers * k;
        if (idx >= w2 * G::kPieces) continue;
        const uint32_t off = swz<kRB>(16 * idx);
        uint4 hi, lo;
        split4(*reinterpret_cast<const float4*>(stage_p + G::kPart + off), hi, lo);
        *reinterpret_cast<uint4*>(sm + L.khi + mine + off) = hi;
        *reinterpret_cast<uint4*>(sm + L.klo + mine + off) = lo;
      }
      // V^T: value row `key` is column kpos of hd rows of 128-byte
      // blocks of 32 keys; in the k8 step of keys 8j..8j+7, key 8j + 2u
      // + e sits at 8j + u + 4e, as P's accumulator registers hold it
#pragma unroll
      for (int it = wq; it < 2 * G::kPieces; it += 4) {
        const int key = 32 * (it / G::kPieces) + lane;
        const int p = it % G::kPieces;
        if (key < w2) {
          uint4 hi, lo;
          split4(*reinterpret_cast<const float4*>(stage_p + 2 * G::kPart +
                                                  swz<kRB>(key * kRB + 16 * p)), hi, lo);
          const int kpos = (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2);
          const uint32_t blk = (kpos >> 5) * (HD * 128) + 4 * (kpos & 31);
          const uint32_t hs[4] = {hi.x, hi.y, hi.z, hi.w};
          const uint32_t ls[4] = {lo.x, lo.y, lo.z, lo.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t off = swz<128>(blk + (4 * p + e) * 128);
            *reinterpret_cast<uint32_t*>(sm + L.vhi + mine + off) = hs[e];
            *reinterpret_cast<uint32_t*>(sm + L.vlo + mine + off) = ls[e];
          }
        }
      }
      // q scaled by hd^-1/2 in f32 and split: the A fragments of each k8
      // step, by ldmatrix (a pair of bf16 is one f32)
      uint32_t qh[HD / 8][4], ql[HD / 8][4];
#pragma unroll
      for (int k8 = 0; k8 < HD / 8; ++k8) {
        const int row = 16 * wq + (lane & 7) + 8 * ((lane >> 3) & 1);
        uint32_t r[4];
        ldmatrix_x4(r, stage + swz<kRB>(row * kRB + 16 * (2 * k8 + (lane >> 4))));
#pragma unroll
        for (int x = 0; x < 4; ++x) split_rna(__uint_as_float(r[x]) * sm_scale, qh[k8][x], ql[k8][x]);
      }
      fence_proxy_async();                // the operand tiles before wgmma reads them
      bar_sync(bar_id, kWgConsumers);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));   // the stage is read
      // S += Q K^T as 3xTF32, lo.hi + hi.lo + hi.hi a k8 step
      wgmma_fence();
#pragma unroll
      for (int k8 = 0; k8 < HD / 8; ++k8) {
        const uint64_t kh = smem_desc<kRB>(base + L.khi + mine + 32 * k8, 16, 8 * kRB);
        const uint64_t kl = smem_desc<kRB>(base + L.klo + mine + 32 * k8, 16, 8 * kRB);
        WgmmaTf32<N>::rs(s, ql[k8], kh);
        WgmmaTf32<N>::rs(s, qh[k8], kl);
        WgmmaTf32<N>::rs(s, qh[k8], kh);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int k8 = 0; k8 < HD / 8; ++k8) {
        fence_regs(qh[k8]);
        fence_regs(ql[k8]);
      }
    } else {
      // S = q k^T of the bf16 rows as they arrived (exact products, f32
      // sums), then scaled by hd^-1/2 and biased in f32
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < HD / 16; ++k16)
        Wgmma<N>::ss(s, smem_desc<kRB>(stage + 32 * k16, 16, 8 * kRB),
                     smem_desc<kRB>(stage + G::kPart + 32 * k16, 16, 8 * kRB), k16);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float4 bv = bias_s[32 * j];
        s[4 * j] = s[4 * j] * sm_scale + bv.x;
        s[4 * j + 1] = s[4 * j + 1] * sm_scale + bv.y;
        s[4 * j + 2] = s[4 * j + 2] * sm_scale + bv.z;
        s[4 * j + 3] = s[4 * j + 3] * sm_scale + bv.w;
      }
    }

    // the mask (-1e9, the reference's NEG_INF), then the softmax of each
    // row over the 4 lanes of its quad
    if (__any_sync(0xffffffffu, dead != 0u)) {   // most windows forbid nothing
#pragma unroll
      for (int x = 0; x < N / 2; ++x)
        if ((dead >> x) & 1u) s[x] = kMaskedLogit;
    }
    // each row's max and sum in four independent chains (the max is
    // exact in any order; the sum's order is fixed)
    float mx[2][4], sum[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mx[r][q] = -INFINITY;
        sum[r][q] = 0.f;
      }
#pragma unroll
    for (int x = 0; x < N / 2; ++x)
      mx[(x >> 1) & 1][(x >> 2) & 3] = fmaxf(mx[(x >> 1) & 1][(x >> 2) & 3], s[x]);
    float m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
#pragma unroll
    for (int x = 0; x < N / 2; ++x) {
      // 2^((x - m) log2 e) by MUFU.EX2 alone: a relative error of a few
      // 1e-7, far under the f32 tolerance and the bf16 rounding
      s[x] = exp2_approx((s[x] - m[(x >> 1) & 1]) * 1.4426950408889634f);
      sum[(x >> 1) & 1][(x >> 2) & 3] += s[x];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t4 = (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);
      t4 += __shfl_xor_sync(0xffffffffu, t4, 1);
      t4 += __shfl_xor_sync(0xffffffffu, t4, 2);
      inv[r] = 1.f / t4;
    }

    if constexpr (kF32) {
      // O = E V as 3xTF32 on V^T; E's A fragments are S's registers
      // (key 8j + 2t plays k = t, 8j + 2t + 1 plays k = t + 4)
      uint32_t eh[NB][4], el[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        split_rna(s[4 * j], eh[j][0], el[j][0]);
        split_rna(s[4 * j + 2], eh[j][1], el[j][1]);
        split_rna(s[4 * j + 1], eh[j][2], el[j][2]);
        split_rna(s[4 * j + 3], eh[j][3], el[j][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const uint32_t at = (j >> 2) * (HD * 128) + 32 * (j & 3);
        const uint64_t vh = smem_desc<128>(base + L.vhi + mine + at, 16, 1024);
        const uint64_t vl = smem_desc<128>(base + L.vlo + mine + at, 16, 1024);
        WgmmaTf32<HD>::rs(o, el[j], vh);
        WgmmaTf32<HD>::rs(o, eh[j], vl);
        WgmmaTf32<HD>::rs(o, eh[j], vh);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        fence_regs(eh[j]);
        fence_regs(el[j]);
      }
    } else {
      // O = E_hi V + E_lo V on bf16 wgmma, V MN-major in the stage
      uint32_t eh[N / 16][4], el[N / 16][4];
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1], eh[kk][x], el[kk][x]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const uint64_t vd = smem_desc<kRB>(stage + 2 * G::kPart + 16 * kk * kRB, G::kPart,
                                           8 * kRB);
        Wgmma<HD>::rs(o, eh[kk], vd);
        Wgmma<HD>::rs(o, el[kk], vd);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        fence_regs(eh[kk]);
        fence_regs(el[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));   // the stage is read
    }

    // O / sum straight from the registers to the un-rolled pixels: a quad's
    // four pairs are 32 contiguous bytes of a pixel's head slice in f32, 16
    // in bf16
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (tok_row[e] < 0) continue;
      const int r = wrap(row0 + tok_row[e], Hp);
      const int c = wrap(col0 + tok_col[e], Wp);
      T* dst = out + (static_cast<size_t>(b * Hp + r) * Wp + c) * C + h * HD + 2 * t;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        put2(dst + 8 * d, o[4 * d + 2 * e] * inv[e], o[4 * d + 2 * e + 1] * inv[e]);
    }
  }
}

template <int HD, typename T, int N>
cudaError_t launch_wgmma(const T* qkv, const float* bias, const uint8_t* mask, T* out, int B,
                         int Hp, int Wp, int C, int n_heads, int window, int shift,
                         float sm_scale, cudaStream_t stream) {
  using G = WgGeom<HD, T, N>;
  const int w2 = window * window;
  const int nW = (Hp / window) * (Wp / window);
  auto kernel = fused_window_attention_wgmma_kernel<HD, T, N>;
  const WgLayout L = wg_layout<HD, T, N>(w2, mask != nullptr, wg_consumers<T>() * kWgRing);
  if (L.bytes > kMaxSmem) return cudaErrorInvalidConfiguration;
  // the device's SMs, and the kernel's shared memory limit raised, once a
  // device and host thread
  static thread_local int last_dev = -1;
  static thread_local int sms = 0;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  if (cur != last_dev) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, cur);
    if (err == cudaSuccess) err = allow_smem(kernel, kMaxSmem);
    if (err != cudaSuccess) return err;
    last_dev = cur;
  }
  // the tensor map of qkv, encoded on the host; a call on the same buffer
  // and geometry as this thread's last one reuses it
  struct MapKey {
    const void* qkv;
    int B, Hp, Wp, C, n_heads, window;
    bool operator==(const MapKey& o) const {
      return qkv == o.qkv && B == o.B && Hp == o.Hp && Wp == o.Wp && C == o.C &&
             n_heads == o.n_heads && window == o.window;
    }
  };
  static thread_local MapKey last{};
  static thread_local CUtensorMap tmap;
  const MapKey key{qkv, B, Hp, Wp, C, n_heads, window};
  if (!(key == last)) {
    const long long es = sizeof(T);
    last = MapKey{};
    const int rc = hopper::encode_4d(&tmap, qkv, static_cast<int>(es),
                                     {HD, 3 * n_heads, Wp, B * Hp},
                                     {HD * es, 3 * C * es, 3ll * C * Wp * es},
                                     {HD, 1, window, window}, G::kRB);
    if (rc != 0) return static_cast<cudaError_t>(rc);
    last = key;
  }
  const int tiles = n_heads * B * nW;
  const int grid = tiles < sms ? tiles : sms;     // one CTA an SM
  kernel<<<grid, wg_threads<T>(), L.bytes, stream>>>(
      tmap, qkv, bias, mask, static_cast<long long>(nW) * w2 * w2, out, B, Hp, Wp, C, n_heads,
      window, shift, sm_scale, tiles);
  return cudaGetLastError();
}

// B1's routes by window: up to 7 (w2 <= 56) and 8 on the wgmma body, keys
// padded to 56 or 64 in f32 and to 64 in bf16 (P.V takes keys 16 at a
// time); 9-12 on the mma.sync body above
template <int HD, typename T>
cudaError_t launch_fused_route(const T* qkv, const float* bias, const uint8_t* mask, T* out,
                               int B, int Hp, int Wp, int C, int n_heads, int window,
                               int shift, float sm_scale, cudaStream_t s) {
  const int w2 = window * window;
  if (w2 <= 56)
    return launch_wgmma<HD, T, sizeof(T) == 4 ? 56 : 64>(qkv, bias, mask, out, B, Hp, Wp, C,
                                                          n_heads, window, shift, sm_scale, s);
  if (w2 <= 64)
    return launch_wgmma<HD, T, 64>(qkv, bias, mask, out, B, Hp, Wp, C, n_heads, window, shift,
                                   sm_scale, s);
  if (w2 <= kMaxW2)
    return launch_fused<HD, kMaxW2 / 8>(qkv, bias, mask, out, B, Hp, Wp, C, n_heads, window,
                                        shift, sm_scale, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_fused(const void* qkv, const float* bias, const uint8_t* mask,
                           void* out, int B, int Hp, int Wp, int C, int n_heads,
                           int window, int shift, float sm_scale, cudaStream_t s) {
  if (!aligned16(qkv) || !aligned16(out) || (mask != nullptr && !aligned16(mask)))
    return cudaErrorMisalignedAddress;
  const auto* q = static_cast<const T*>(qkv);
  auto* o = static_cast<T*>(out);
  switch (C / n_heads) {
    case 16: return launch_fused_route<16>(q, bias, mask, o, B, Hp, Wp, C, n_heads, window, shift, sm_scale, s);
    case 32: return launch_fused_route<32>(q, bias, mask, o, B, Hp, Wp, C, n_heads, window, shift, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// B7: attention on pre-partitioned windows, fp32 or bf16 in and out
// ---------------------------------------------------------------------------

template <int HD, int NT, typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const uint8_t* __restrict__ mask, T* __restrict__ out,
                        int w2, int nh, float pad_keys, float sm_scale) {
  using Tl = Tile<HD, T>;
  constexpr int kLd = Tl::kLd;
  constexpr int kVec = Tl::kVec;
  constexpr int kElems = Tl::kElems;
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);
  const int n = blockIdx.x;                 // window
  const int h = blockIdx.y;
  T* k_s = smem;                            // (8 NT, kLd), zero past w2
  T* v_s = k_s + 8 * NT * kLd;
  T* q_s = v_s + 8 * NT * kLd;              // (kRunRows, kLd): q, then the output

  // row t of head h of window n in a (nB, w2, nh, HD) tensor
  const size_t base = (static_cast<size_t>(n) * w2 * nh + h) * HD;
  const size_t stride = static_cast<size_t>(nh) * HD;

  for (int idx = threadIdx.x; idx < 8 * NT * kVec; idx += kThreads) {
    const int t = idx / kVec;
    const int c = (idx % kVec) * kElems;
    const bool ok = t < w2;
    const size_t off = base + (ok ? t * stride + c : 0);
    cp_async16(k_s + t * kLd + c, k + off, ok);
    cp_async16(v_s + t * kLd + c, v + off, ok);
  }

  const float* bias_h = bias + static_cast<size_t>(h) * w2 * w2;
  const uint8_t* mask_w =
      mask != nullptr ? mask + static_cast<size_t>(n) * w2 * w2 : nullptr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* q_w = q_s + 16 * warp * kLd;
  for (int r0 = 0; r0 < w2; r0 += kRunRows) {
    for (int idx = threadIdx.x; idx < kRunRows * kVec; idx += kThreads) {
      const int t = idx / kVec;
      const int c = (idx % kVec) * kElems;
      const bool ok = r0 + t < w2;
      cp_async16(q_s + t * kLd + c, q + base + (ok ? (r0 + t) * stride + c : 0), ok);
    }
    const int m0 = r0 + 16 * warp;
    float s[NT][4];
    uint32_t dead[mask_words<NT>()];
    if (m0 < w2) start_logits<NT>(s, dead, bias_h, mask_w, m0, w2);
    cp_async_wait_all();
    __syncthreads();                        // K and V too, on the first run
    if (m0 < w2) {
      attend_warp<HD, NT>(s, dead, q_w, k_s, v_s, sm_scale, w2, pad_keys);
      for (int idx = lane; idx < 16 * kVec; idx += 32) {
        const int t = idx / kVec;
        const int c = (idx % kVec) * kElems;
        if (m0 + t < w2)
          *reinterpret_cast<uint4*>(out + base + (m0 + t) * stride + c) =
              *reinterpret_cast<const uint4*>(q_w + t * kLd + c);
      }
    }
    __syncthreads();                        // q_s is refilled by the next run
  }
}

template <int HD, int NT, typename T>
cudaError_t launch_windows(const T* q, const T* k, const T* v, const float* bias,
                           const uint8_t* mask, T* out, int nB, int w2, int nh,
                           int pad_keys, float sm_scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, NT, T>(0);
  const cudaError_t err = allow_smem(window_attention_kernel<HD, NT, T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nB, nh);
  window_attention_kernel<HD, NT, T><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, mask, out, w2, nh, static_cast<float>(pad_keys), sm_scale);
  return cudaGetLastError();
}

template <int HD, typename T>
cudaError_t launch_windows_nt(const T* q, const T* k, const T* v, const float* bias,
                              const uint8_t* mask, T* out, int nB, int w2, int nh,
                              int pad_keys, float sm_scale, cudaStream_t s) {
  if (w2 <= 8 * kSmallTiles)
    return launch_windows<HD, kSmallTiles>(q, k, v, bias, mask, out, nB, w2, nh, pad_keys, sm_scale, s);
  if (w2 <= kMaxW2)
    return launch_windows<HD, kMaxW2 / 8>(q, k, v, bias, mask, out, nB, w2, nh, pad_keys, sm_scale, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_windows(const void* q, const void* k, const void* v,
                             const float* bias, const uint8_t* mask, void* out,
                             int nB, int w2, int nh, int hd, int pad_keys,
                             float sm_scale, cudaStream_t s) {
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  const auto* q_ = static_cast<const T*>(q);
  const auto* k_ = static_cast<const T*>(k);
  const auto* v_ = static_cast<const T*>(v);
  auto* o_ = static_cast<T*>(out);
  switch (hd) {
    case 16: return launch_windows_nt<16>(q_, k_, v_, bias, mask, o_, nB, w2, nh, pad_keys, sm_scale, s);
    case 32: return launch_windows_nt<32>(q_, k_, v_, bias, mask, o_, nB, w2, nh, pad_keys, sm_scale, s);
    case 64: return launch_windows_nt<64>(q_, k_, v_, bias, mask, o_, nB, w2, nh, pad_keys, sm_scale, s);
    case 128: return launch_windows_nt<128>(q_, k_, v_, bias, mask, o_, nB, w2, nh, pad_keys, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (B, Hp, Wp, 3C) and out (B, Hp, Wp, C) of one dtype (0 = f32, 1 =
// bf16); bias (n_heads, w2, w2) f32; mask (nW, w2, w2) bytes (0 = masked)
// indexed by rolled window, or null.  All contiguous, qkv and out 16-byte
// aligned, C a multiple of 8 (so every row piece a thread moves is 16-byte
// aligned in bf16 too), w2 at most 144.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int fused_window_attention_fwd(const void* qkv, const void* bias,
                                          const void* mask, void* out, int B,
                                          int Hp, int Wp, int C, int n_heads,
                                          int window, int shift, int dtype,
                                          float sm_scale, void* stream) {
  const auto* bs = static_cast<const float*>(bias);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = dispatch_fused<float>(qkv, bs, m, out, B, Hp, Wp, C, n_heads, window, shift, sm_scale, s);
      break;
    case 1:
      err = dispatch_fused<__nv_bfloat16>(qkv, bs, m, out, B, Hp, Wp, C, n_heads, window, shift,
                                          sm_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// q, k, v, out (nB, w2, nh, hd) of one dtype (0 = f32, 1 = bf16); bias
// (nh, w2, w2) f32; mask (nB, w2, w2) bytes (0 = masked) or null.  All
// contiguous, q, k, v and out 16-byte aligned.  pad_keys = W2P - w2, the
// padded keys of the TPU op.  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int window_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* mask, void* out,
                                    int nB, int w2, int nh, int hd, int pad_keys,
                                    int dtype, float sm_scale, void* stream) {
  const auto* bs = static_cast<const float*>(bias);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = dispatch_windows<float>(q, k, v, bs, m, out, nB, w2, nh, hd, pad_keys, sm_scale, s);
      break;
    case 1:
      err = dispatch_windows<__nv_bfloat16>(q, k, v, bs, m, out, nB, w2, nh, hd, pad_keys, sm_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
