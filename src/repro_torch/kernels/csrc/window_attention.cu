// Fused Swin window attention for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel src/repro/kernels/window_attention.py ::
// fused_window_attention_pallas (bodies _fused_kernel_noshift /
// _fused_kernel_shift, math in _band_attention).  One launch covers the
// cyclic shift, the window partition, the biased and masked softmax
// attention and the un-partition, reading the packed qkv projection in image
// coordinates and writing the output back in image coordinates.
//
// Design.  One CTA per (window, head, image).  The CTA gathers its w2 query,
// key and value rows of width hd straight from the image-layout qkv with
// modular indices (row + shift) % Hp, (col + shift) % Wp, so no roll is ever
// materialised, and it writes each output row back to the same un-rolled
// coordinate.  The TPU kernel's (shift, Wp, C) VMEM carry existed only
// because its grid runs in order; CTAs here are independent.  Scores,
// softmax and P.V stay in shared memory in fp32: (3 hd + 1) w2 + w2^2
// floats, 28.6 KB at w2 = 49, hd = 32.  w2 = 49 is used directly; the TPU's
// padding to 64 rows and its eye trick for padded queries are not needed.
//
// Bound on the H100.  Per image at the full Swin-T stage 0 the kernel reads
// 32.7 MB of qkv and writes 10.9 MB, and does 0.53 GFLOP of fp32 math, so
// bytes bound it (13 us at 3.35 TB/s against 8 us at 67 TFLOP/s).  Each qkv
// element is read exactly once (a token belongs to one window) with hd
// consecutive floats per row, so the gather is coalesced in 128-byte rows at
// hd = 32.  This first version keeps the products on the CUDA cores; the
// tensor-core path is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kMaskedLogit = -1e9f;   // the reference's NEG_INF, not -inf

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
  for (int idx = threadIdx.x; idx < w2 * w2; idx += blockDim.x) {
    const int i = idx / w2, j = idx % w2;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc = fmaf(q_s[i * HD + d], k_s[j * (HD + 1) + d], acc);
    acc += bias_h[idx];
    if (mask_w != nullptr && mask_w[idx] == 0) acc = kMaskedLogit;
    s_s[idx] = acc;
  }
  __syncthreads();

  // softmax: one warp per row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int i = warp; i < w2; i += n_warps) {
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
    for (int j = lane; j < w2; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < w2 * HD; idx += blockDim.x) {
    const int t = idx / HD, d = idx % HD;
    const float* p = s_s + t * w2;
    float acc = 0.f;
    for (int j = 0; j < w2; ++j) acc = fmaf(p[j], v_s[j * HD + d], acc);
    const int r = (row0 + t / window) % Hp;
    const int c = (col0 + t % window) % Wp;
    out[((static_cast<size_t>(b) * Hp + r) * Wp + c) * C + h * HD + d] = acc;
  }
}

template <int HD>
cudaError_t launch(const float* qkv, const float* bias, const uint8_t* mask,
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
      err = launch<16>(q, bs, m, o, B, Hp, Wp, C, n_heads, window, shift, sm_scale, s);
      break;
    case 32:
      err = launch<32>(q, bs, m, o, B, Hp, Wp, C, n_heads, window, shift, sm_scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
