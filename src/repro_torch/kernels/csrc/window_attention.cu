// Swin window attention for Hopper (sm_90a): two kernels on one per-window
// body, with the products on the tensor cores.
//
// B1, fused_window_attention_fwd, replaces src/repro/kernels/
// window_attention.py :: fused_window_attention_pallas (bodies
// _fused_kernel_noshift / _fused_kernel_shift, math in _band_attention).
// One launch covers the cyclic shift, the window partition, the biased and
// masked softmax attention and the un-partition, reading the packed qkv
// projection in image coordinates and writing the output back in image
// coordinates, f32 or bf16 in and out (bf16 Swin-T): as the TPU kernel, it
// takes f32 logits, softmax and P.V from bf16 q, k, v and rounds once, at
// the store.
//
// B7, window_attention_fwd, replaces src/repro/kernels/window_attention.py ::
// window_attention_pallas (body _window_kernel) behind ops.window_attention:
// the same attention on q, k, v already partitioned into windows,
// (nB, w2, nh, hd) each, with a (nh, w2, w2) bias and an optional
// (nB, w2, w2) mask, f32 or bf16 in and out.
//
// Design.  One CTA of 4 warps per (window, head[, image]).  The CTA copies
// its w2 key and value rows and a run of 64 query rows into shared memory
// with cp.async, in the input's type, and each warp runs the shared body,
// attend_warp, on 16 query rows:
//   - Both products run on mma.sync.m16n8k8 TF32 with f32 accumulation, as
//     3xTF32: every f32 operand x is split into hi = cvt.rna.tf32(x) and
//     lo = cvt.rna.tf32(x - hi), and a.b is taken as lo.hi + hi.lo + hi.hi
//     (three MMAs on one accumulator, the small terms first).  That keeps
//     about 22 of f32's 24 mantissa bits; one TF32 product keeps 11 and
//     misses the f32 tolerance (tests/test_torch_window_tc.py holds a CPU
//     mirror of this arithmetic and, on a card, this kernel against it;
//     tests/test_torch_kernels.py holds the mirror against the JAX package
//     and shows the single product missing).  q is multiplied by hd^-1/2 in
//     f32 before its split, as the reference scales it.  bf16 K and V (B1's
//     and B7's) are exact in TF32 (lo = 0), so their hi.lo product is
//     skipped: two MMAs a product where f32 takes three.  The scaled q and
//     P are f32 and still split, so a bf16 call computes what the
//     reference computes in f32 from its bf16 inputs.
//   - Tiles are padded in registers and shared memory only: query rows to a
//     multiple of 16, keys to 8 NT (NT = 7 key tiles for w2 <= 56, Swin's
//     49, else 18).  Padded key and value rows are zero in shared memory
//     (0 x a stale NaN would be NaN), padded keys are scored -INFINITY so
//     they weigh exactly 0 on every row, padded query rows are zero and
//     never stored.  Every key tile is computed, so no branch splits the
//     unrolled loops.
//   - The logits never leave registers.  The accumulator starts at the
//     bias, loaded while the rows are still in flight; the mask (-1e9, the
//     reference's NEG_INF) is applied in the accumulator's layout, where a
//     thread holds columns 2t and 2t + 1 of rows g and g + 8 of its warp's
//     tile; row max and sum reduce over the 4 lanes of a quad; exp is expf;
//     the output is scaled by 1 / sum after P.V.  P.V needs no shuffle:
//     inside each k8 step key 8j + 2t plays k = t and key 8j + 2t + 1 plays
//     k = t + 4, so the accumulator registers of S are the A fragment of P,
//     and the B fragment reads value rows 8j + 2t and 8j + 2t + 1.
//   - Shared rows carry 16 bytes of padding, so the A and B fragment loads
//     (8 rows x 4 columns, or 4 row pairs x 8 columns) fall on 32 banks.
//   - Rows move 16 bytes a thread (4 f32 or 8 bf16 values).  B1 gathers its
//     rows from the image-layout qkv with modular indices (row + shift) %
//     Hp, (col + shift) % Wp, computed once per token into a table in
//     shared memory, so no roll is ever materialised and the store goes
//     back to the same un-rolled pixel; each head's slice of a pixel is 64
//     or 128 contiguous bytes in f32, 32 or 64 in bf16, and starts at a
//     multiple of 16 bytes (C = nh HD, HD 16 or 32).  The TPU kernel's
//     (shift, Wp, C) VMEM carry existed only because its grid runs in
//     order, and CTAs here are independent.  B7 reads its window's rows in
//     place.  Each warp writes its output rows back through its own query
//     rows in shared memory.
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
//
// Bound on the H100.  Both read each input element once and write each
// output once; the work is about 4 w2^2 hd flops per (window, head).  At the
// Swin-T shapes (w2 = 49, hd = 32) that is 12 flops per byte of q, k, v and
// out in f32 (24 in bf16), so bytes bound both (chip_smoke.py computes the
// bound of each call): stage 0 of one frame moves 45 MB in f32, 13 us at
// 3.35 TB/s, and half that in bf16.  3xTF32 on
// the padded tiles issues 3 x 64 x 56 / 49^2 = 4.5x the reference's flops,
// which the tensor cores take in a few us.  What is left above the bound
// (PERF.md) is latency: Swin-T's stage 2-3 calls are one or two waves of
// CTAs, each a chain of loads, 168 MMAs a warp and a store.  The shared tile
// is 16 NT + 64 rows of HD values and their padding (B1 adds w2 ints):
// 25.5 KB at w2 = 49, hd = 32 in f32 (14.3 KB in bf16), and 186 KB at
// w2 = 144, hd = 128, under the 227 KB a CTA may have.  w2 is at most 144.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int HD, typename T>
cudaError_t launch_fused_nt(const T* qkv, const float* bias, const uint8_t* mask,
                            T* out, int B, int Hp, int Wp, int C, int n_heads,
                            int window, int shift, float sm_scale, cudaStream_t s) {
  const int w2 = window * window;
  if (w2 <= 8 * kSmallTiles)
    return launch_fused<HD, kSmallTiles>(qkv, bias, mask, out, B, Hp, Wp, C, n_heads, window,
                                         shift, sm_scale, s);
  if (w2 <= kMaxW2)
    return launch_fused<HD, kMaxW2 / 8>(qkv, bias, mask, out, B, Hp, Wp, C, n_heads, window,
                                        shift, sm_scale, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_fused(const void* qkv, const float* bias, const uint8_t* mask,
                           void* out, int B, int Hp, int Wp, int C, int n_heads,
                           int window, int shift, float sm_scale, cudaStream_t s) {
  if (!aligned16(qkv) || !aligned16(out)) return cudaErrorMisalignedAddress;
  const auto* q = static_cast<const T*>(qkv);
  auto* o = static_cast<T*>(out);
  switch (C / n_heads) {
    case 16: return launch_fused_nt<16>(q, bias, mask, o, B, Hp, Wp, C, n_heads, window, shift, sm_scale, s);
    case 32: return launch_fused_nt<32>(q, bias, mask, o, B, Hp, Wp, C, n_heads, window, shift, sm_scale, s);
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
