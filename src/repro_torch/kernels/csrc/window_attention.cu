// Swin window attention for Hopper (sm_90a): two kernels on one per-window
// body.
//
// B1, fused_window_attention_f32, replaces src/repro/kernels/
// window_attention.py :: fused_window_attention_pallas (bodies
// _fused_kernel_noshift / _fused_kernel_shift, math in _band_attention).
// One launch covers the cyclic shift, the window partition, the biased and
// masked softmax attention and the un-partition, reading the packed qkv
// projection in image coordinates and writing the output back in image
// coordinates.
//
// B7, window_attention_fwd, replaces src/repro/kernels/window_attention.py ::
// window_attention_pallas (body _window_kernel) behind ops.window_attention:
// the same attention on q, k, v already partitioned into windows,
// (nB, w2, nh, hd) each, with a (nh, w2, w2) bias and an optional
// (nB, w2, w2) mask.
//
// Design.  One CTA per (window, head[, image]).  The CTA stages its w2 key
// and value rows of width hd and a run of query rows in shared memory in
// fp32 and computes scores, softmax and P.V there (attend_rows, shared by
// both kernels).  B1 gathers its rows from the image-layout qkv with modular
// indices (row + shift) % Hp, (col + shift) % Wp, so no roll is ever
// materialised, and writes each output row back to the same un-rolled
// coordinate; the TPU kernel's (shift, Wp, C) VMEM carry existed only
// because its grid runs in order, and CTAs here are independent.  B7 reads
// its window's rows in place, no gather.  Neither pads w2 to a tile multiple.
//
// The TPU op behind B7 pads w2 up to W2P = ceil(w2 / 64) * 64 with keys that
// every real query sees masked (-1e9) and value rows of zero.  On a row
// with at least one allowed key those keys weigh exp(-1e9 - max) = 0; on a
// row whose keys are all masked they weigh as much as the real ones, and
// the op returns sum(v) / W2P.  B7 reads only the w2 real rows and adds
// (W2P - w2) * exp(-1e9 - max) to each row's softmax denominator, which is
// the op's result on both kinds of row.  B1's TPU kernel never sees such a
// row (every Swin query may attend to itself), and B1 adds nothing.
//
// Bound on the H100.  Both read each input element once and write each
// output once; the fp32 work is about 4 w2^2 hd flops per (window, head).
// At the Swin-T shapes (w2 = 49, hd = 32) that is 12 flops per byte of q,
// k, v and out in f32, below the 20 that 67 TFLOP/s over 3.35 TB/s needs,
// so bytes bound both (chip_smoke.py computes the bound of each call).  The shared tile is
// (2 hd + 1) w2 + (hd + w2) rows floats, 28.6 KB at w2 = 49, hd = 32; at
// w2 = 144, hd = 128 the query rows are staged in runs so that it stays
// under the 227 KB a CTA may have.  This first version keeps the products
// on the CUDA cores; the tensor-core path is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kMaskedLogit = -1e9f;   // the reference's NEG_INF, not -inf
constexpr size_t kMaxSmem = 232448;     // dynamic shared memory a CTA may use
constexpr size_t kSmemTarget = 96 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// softmax(q_s k_s^T + bias, mask -> -1e9) v_s for nr query rows.  q_s
// (nr, HD) pre-scaled, k_s (w2, HD + 1), v_s (w2, HD), s_s (nr, w2) scratch;
// bias_rows and mask_rows (null = no mask) start at the first of the nr
// rows, with a row stride of w2.  pad_keys extra keys at -1e9 with value
// rows of zero join each row's denominator.  store(t, d, x) receives output
// row t < nr, column d.  Starts and ends without a barrier: the caller
// syncs after filling q_s, k_s, v_s, and before refilling any of them.
template <int HD, class Store>
__device__ __forceinline__ void attend_rows(const float* q_s, const float* k_s,
                                            const float* v_s, float* s_s,
                                            const float* bias_rows,
                                            const uint8_t* mask_rows, int w2,
                                            int nr, float pad_keys, Store store) {
  for (int idx = threadIdx.x; idx < nr * w2; idx += blockDim.x) {
    const int i = idx / w2, j = idx % w2;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc = fmaf(q_s[i * HD + d], k_s[j * (HD + 1) + d], acc);
    acc += bias_rows[idx];
    if (mask_rows != nullptr && mask_rows[idx] == 0) acc = kMaskedLogit;
    s_s[idx] = acc;
  }
  __syncthreads();

  // softmax: one warp per row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int i = warp; i < nr; i += n_warps) {
    float* row = s_s + i * w2;
    float m = -INFINITY;
    for (int j = lane; j < w2; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < w2; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (pad_keys > 0.f) sum += pad_keys * expf(kMaskedLogit - m);
    for (int j = lane; j < w2; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nr * HD; idx += blockDim.x) {
    const int t = idx / HD, d = idx % HD;
    const float* p = s_s + t * w2;
    float acc = 0.f;
    for (int j = 0; j < w2; ++j) acc = fmaf(p[j], v_s[j * HD + d], acc);
    store(t, d, acc);
  }
}

// ---------------------------------------------------------------------------
// B1: fused shift + partition + attention + un-partition, fp32
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
fused_window_attention_kernel(const float* __restrict__ qkv,
                              const float* __restrict__ bias,
                              const uint8_t* __restrict__ mask,
                              float* __restrict__ out, int Hp, int Wp, int C,
                              int window, int shift, float sm_scale) {
  extern __shared__ float smem[];
  const int w2 = window * window;
  const int nww = Wp / window;
  const int win = blockIdx.x;            // window index in rolled coordinates
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = (win / nww) * window + shift;
  const int col0 = (win % nww) * window + shift;
  const size_t C3 = 3 * static_cast<size_t>(C);

  float* q_s = smem;                     // (w2, HD), pre-scaled
  float* k_s = q_s + w2 * HD;            // (w2, HD + 1): padded rows, no bank conflicts
  float* v_s = k_s + w2 * (HD + 1);      // (w2, HD)
  float* s_s = v_s + w2 * HD;            // (w2, w2) logits, then probabilities

  for (int idx = threadIdx.x; idx < w2 * HD; idx += blockDim.x) {
    const int t = idx / HD, d = idx % HD;
    const int r = (row0 + t / window) % Hp;
    const int c = (col0 + t % window) % Wp;
    const float* src =
        qkv + ((static_cast<size_t>(b) * Hp + r) * Wp + c) * C3 + h * HD + d;
    q_s[t * HD + d] = src[0] * sm_scale;
    k_s[t * (HD + 1) + d] = src[C];
    v_s[t * HD + d] = src[2 * C];
  }
  __syncthreads();

  const float* bias_h = bias + static_cast<size_t>(h) * w2 * w2;
  const uint8_t* mask_w =
      mask != nullptr ? mask + static_cast<size_t>(win) * w2 * w2 : nullptr;
  attend_rows<HD>(q_s, k_s, v_s, s_s, bias_h, mask_w, w2, w2, 0.f,
                  [&](int t, int d, float x) {
                    const int r = (row0 + t / window) % Hp;
                    const int c = (col0 + t % window) % Wp;
                    out[((static_cast<size_t>(b) * Hp + r) * Wp + c) * C + h * HD + d] = x;
                  });
}

template <int HD>
cudaError_t launch_fused(const float* qkv, const float* bias, const uint8_t* mask,
                         float* out, int B, int Hp, int Wp, int C, int n_heads,
                         int window, int shift, float sm_scale, cudaStream_t stream) {
  const int w2 = window * window;
  const size_t smem = static_cast<size_t>(w2 * (3 * HD + 1) + w2 * w2) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_window_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Hp / window) * (Wp / window), n_heads, B);
  fused_window_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(
      qkv, bias, mask, out, Hp, Wp, C, window, shift, sm_scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B7: attention on pre-partitioned windows, fp32 or bf16 in and out
// ---------------------------------------------------------------------------

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const uint8_t* __restrict__ mask, T* __restrict__ out,
                        int w2, int nh, int q_rows, float pad_keys,
                        float sm_scale) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;              // window
  const int h = blockIdx.y;
  float* k_s = smem;                     // (w2, HD + 1): padded rows, no bank conflicts
  float* v_s = k_s + w2 * (HD + 1);      // (w2, HD)
  float* q_s = v_s + w2 * HD;            // (q_rows, HD), pre-scaled
  float* s_s = q_s + q_rows * HD;        // (q_rows, w2)

  // element (n, t, h, d) of a (nB, w2, nh, HD) tensor
  auto at = [&](int t, int d) {
    return ((static_cast<size_t>(n) * w2 + t) * nh + h) * HD + d;
  };
  for (int idx = threadIdx.x; idx < w2 * HD; idx += blockDim.x) {
    const int t = idx / HD, d = idx % HD;
    k_s[t * (HD + 1) + d] = to_f32(k[at(t, d)]);
    v_s[t * HD + d] = to_f32(v[at(t, d)]);
  }
  const float* bias_h = bias + static_cast<size_t>(h) * w2 * w2;
  const uint8_t* mask_w =
      mask != nullptr ? mask + static_cast<size_t>(n) * w2 * w2 : nullptr;
  for (int r0 = 0; r0 < w2; r0 += q_rows) {
    const int nr = min(q_rows, w2 - r0);
    // the previous run's P.V reads only s_s and v_s, so q_s may be refilled
    for (int idx = threadIdx.x; idx < nr * HD; idx += blockDim.x) {
      const int t = idx / HD, d = idx % HD;
      q_s[idx] = to_f32(q[at(r0 + t, d)]) * sm_scale;
    }
    __syncthreads();
    attend_rows<HD>(q_s, k_s, v_s, s_s, bias_h + static_cast<size_t>(r0) * w2,
                    mask_w != nullptr ? mask_w + static_cast<size_t>(r0) * w2 : nullptr,
                    w2, nr, pad_keys,
                    [&](int t, int d, float x) { from_f32(out + at(r0 + t, d), x); });
    __syncthreads();                     // s_s is rewritten by the next run
  }
}

// shared floats for q_rows query rows
template <int HD>
size_t window_smem(int w2, int q_rows) {
  return static_cast<size_t>(w2 * (2 * HD + 1) + q_rows * (HD + w2)) * sizeof(float);
}

template <int HD, typename T>
cudaError_t launch_windows(const T* q, const T* k, const T* v, const float* bias,
                           const uint8_t* mask, T* out, int nB, int w2, int nh,
                           int pad_keys, float sm_scale, cudaStream_t stream) {
  // all query rows in one run where the tile stays small enough for a few
  // CTAs per SM; otherwise halve the run until it does (or reaches 16 rows)
  int q_rows = w2;
  while (q_rows > 16 && window_smem<HD>(w2, q_rows) > kSmemTarget) q_rows = (q_rows + 1) / 2;
  const size_t smem = window_smem<HD>(w2, q_rows);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_attention_kernel<HD, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nB, nh);
  window_attention_kernel<HD, T><<<grid, kThreads, smem, stream>>>(
      q, k, v, bias, mask, out, w2, nh, q_rows, static_cast<float>(pad_keys),
      sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_windows(const void* q, const void* k, const void* v,
                             const float* bias, const uint8_t* mask, void* out,
                             int nB, int w2, int nh, int hd, int pad_keys,
                             float sm_scale, cudaStream_t s) {
  const auto* q_ = static_cast<const T*>(q);
  const auto* k_ = static_cast<const T*>(k);
  const auto* v_ = static_cast<const T*>(v);
  auto* o_ = static_cast<T*>(out);
  switch (hd) {
    case 16: return launch_windows<16>(q_, k_, v_, bias, mask, o_, nB, w2, nh, pad_keys, sm_scale, s);
    case 32: return launch_windows<32>(q_, k_, v_, bias, mask, o_, nB, w2, nh, pad_keys, sm_scale, s);
    case 64: return launch_windows<64>(q_, k_, v_, bias, mask, o_, nB, w2, nh, pad_keys, sm_scale, s);
    case 128: return launch_windows<128>(q_, k_, v_, bias, mask, o_, nB, w2, nh, pad_keys, sm_scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (B, Hp, Wp, 3C) f32; bias (n_heads, w2, w2) f32; mask (nW, w2, w2)
// bytes (0 = masked) indexed by rolled window, or null; out (B, Hp, Wp, C).
// All contiguous.  Returns the cudaError_t of the launch (0 = success).
extern "C" int fused_window_attention_f32(const void* qkv, const void* bias,
                                          const void* mask, void* out, int B,
                                          int Hp, int Wp, int C, int n_heads,
                                          int window, int shift, float sm_scale,
                                          void* stream) {
  const auto* q = static_cast<const float*>(qkv);
  const auto* bs = static_cast<const float*>(bias);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C / n_heads) {
    case 16:
      err = launch_fused<16>(q, bs, m, o, B, Hp, Wp, C, n_heads, window, shift, sm_scale, s);
      break;
    case 32:
      err = launch_fused<32>(q, bs, m, o, B, Hp, Wp, C, n_heads, window, shift, sm_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// q, k, v, out (nB, w2, nh, hd) of one dtype (0 = f32, 1 = bf16); bias
// (nh, w2, w2) f32; mask (nB, w2, w2) bytes (0 = masked) or null.  All
// contiguous.  pad_keys = W2P - w2, the padded keys of the TPU op.  Returns
// the cudaError_t of the launch (0 = success).
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
