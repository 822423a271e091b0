// Per-tensor block int8 quantisation for Hopper (sm_90a): quant and dequant.
//
// Replaces the TPU kernels src/repro/kernels/quant.py :: quant_pallas
// (_quant_kernel) and dequant_pallas (_dequant_kernel), which carry the
// legacy per-tensor codec (one launch per payload leaf).  Both must be
// bitwise equal to the reference: the same int8 bytes, the same scale bits
// and the same decoded floats.  Hence, as in codec.cu: IEEE division
// (__fdiv_rn; this file is never built with fast math), round half to even
// with rintf, and the scale as a multiply by the f32 literal of 1/127.
//
// Design.  quant: one CTA per quantisation block of the leaf (8192 f32 =
// 64 rows of 128 lanes by default).  The TPU wrapper pads the flattened
// leaf to whole blocks in device memory before the launch; here the kernel
// reads only the n valid elements and treats every index >= n as 0, so no
// padded copy of the leaf is made.  A strided pass reduces the absmax (warp
// shuffles, then one shared word per warp); a second pass reads the block
// again (now in L2) and writes the whole int8 row, the padding zeros
// included, four bytes per thread per step.  dequant: one thread per four
// output elements over the n valid ones, q[i] * scale[i / block], so the
// reference's [:n] slice is fused into the kernel.
//
// Bound on the H100.  Both are memory bound with a handful of operations per
// element: quant reads 4 B per valid element and writes 1 B per padded
// element plus 4 B per block; dequant the reverse.  Every access is
// coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr float kInt8Max = 127.0f;
constexpr float kInvInt8Max = 0x1.020408p-7f;   // f32(1) / f32(127), as the reference

__device__ __forceinline__ int8_t quant1(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -kInt8Max), kInt8Max)));
}

__global__ void __launch_bounds__(kThreads)
quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ scales, long long n, int block) {
  __shared__ float warp_max[kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * block;
  // valid elements in this block: the last block of the leaf is ragged
  const int valid = n - base < block ? static_cast<int>(n - base) : block;
  const float* xb = x + base;

  float m = 0.f;
  for (int i = threadIdx.x; i < valid; i += kThreads) m = fmaxf(m, fabsf(xb[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float absmax = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) absmax = fmaxf(absmax, warp_max[w]);
  const float scale = absmax > 0.f ? absmax * kInvInt8Max : 1.0f;

  // block is a multiple of 128, so every row of four bytes is 4-byte aligned
  char4* qb = reinterpret_cast<char4*>(q + base);
  for (int j = threadIdx.x; j < block / kVec; j += kThreads) {
    const int i = j * kVec;
    char4 v;
    v.x = i + 0 < valid ? quant1(xb[i + 0], scale) : 0;
    v.y = i + 1 < valid ? quant1(xb[i + 1], scale) : 0;
    v.z = i + 2 < valid ? quant1(xb[i + 2], scale) : 0;
    v.w = i + 3 < valid ? quant1(xb[i + 3], scale) : 0;
    qb[j] = v;
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
               float* __restrict__ out, long long n, int block) {
  const long long i0 = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const long long i = i0 + k;
    if (i < n) out[i] = static_cast<float>(q[i]) * scales[i / block];
  }
}

}  // namespace

// x (n,) f32 -> q (nb * block,) int8 and scales (nb,) f32, nb = ceil(n /
// block) >= 1, block a multiple of 128.  Returns the cudaError_t of the
// launch (0 = success).
extern "C" int quant_f32(const void* x, void* q, void* scales, long long n,
                         int nb, int block, void* cuda_stream) {
  quant_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), n, block);
  return static_cast<int>(cudaGetLastError());
}

// q (nb * block,) int8 and scales (nb,) f32 -> out (n,) f32, n >= 1 and
// n <= nb * block.
extern "C" int dequant_f32(const void* q, const void* scales, void* out,
                           long long n, int block, void* cuda_stream) {
  const long long per_cta = static_cast<long long>(kThreads) * kVec;
  const unsigned grid = static_cast<unsigned>((n + per_cta - 1) / per_cta);
  dequant_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n, block);
  return static_cast<int>(cudaGetLastError());
}
