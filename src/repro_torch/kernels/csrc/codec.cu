// Fused activation codec for Hopper (sm_90a): per-block int8 quantisation
// with an optional mod-256 row delta (encode), and its inverse (decode).
//
// Replaces the TPU kernels src/repro/kernels/codec.py :: codec_encode_pallas
// (_encode_kernel) and codec_decode_pallas (_decode_kernel).  Both must be
// bitwise equal to the reference: the same stream bytes and the same scale
// bits.  Hence IEEE division (nvcc's default -prec-div=true; this file is
// never built with fast math), round half to even with rintf, the scale as a
// multiply by f32(1/127), and integer arithmetic for the delta.
//
// Design.  One CTA per quantisation block (8192 f32 = 64 rows of 128 lanes
// by default).  Encode: a strided pass for the absmax (warp shuffles, then
// one shared word per warp), a second pass that quantises into shared memory
// (the block is then in L1/L2), and a third that writes the bytes, taking
// the delta against the row above from shared memory.  Decode: 128 threads,
// one per lane, each walking its column down the rows with an int32 running
// sum mod 256, so the prefix sum needs no cross-thread step.
//
// Bound on the H100.  Both are memory bound with a handful of operations per
// element: encode reads 4 B and writes 1 B per element (plus 4 B per block),
// decode the reverse.  Every access is coalesced along the 128-lane rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kEncodeThreads = 256;
constexpr float kInt8Max = 127.0f;
constexpr float kInvInt8Max = 0x1.020408p-7f;   // f32(1) / f32(127), as the reference

__global__ void __launch_bounds__(kEncodeThreads)
codec_encode_kernel(const float* __restrict__ x, uint8_t* __restrict__ stream,
                    float* __restrict__ scales, int block, int delta) {
  extern __shared__ int8_t q_s[];                 // (block,)
  __shared__ float warp_max[kEncodeThreads / 32];
  const float* xb = x + static_cast<size_t>(blockIdx.x) * block;
  uint8_t* ob = stream + static_cast<size_t>(blockIdx.x) * block;

  float m = 0.f;
  for (int i = threadIdx.x; i < block; i += blockDim.x) m = fmaxf(m, fabsf(xb[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float absmax = 0.f;
#pragma unroll
  for (int w = 0; w < kEncodeThreads / 32; ++w) absmax = fmaxf(absmax, warp_max[w]);
  const float scale = absmax > 0.f ? absmax * kInvInt8Max : 1.0f;

  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    const float r = rintf(__fdiv_rn(xb[i], scale));
    q_s[i] = static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -kInt8Max), kInt8Max)));
  }
  __syncthreads();
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    int v = q_s[i];
    if (delta) v -= i >= kLanes ? q_s[i - kLanes] : 0;   // row 0 stays absolute
    ob[i] = static_cast<uint8_t>(v & 0xFF);
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

__global__ void __launch_bounds__(kLanes)
codec_decode_kernel(const uint8_t* __restrict__ stream,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int block, int delta) {
  const size_t base = static_cast<size_t>(blockIdx.x) * block;
  const float scale = scales[blockIdx.x];
  const int rows = block / kLanes;
  int acc = 0;
  for (int r = 0; r < rows; ++r) {
    const size_t i = base + static_cast<size_t>(r) * kLanes + threadIdx.x;
    int v;
    if (delta) {
      acc = (acc + stream[i]) & 0xFF;
      v = acc > 127 ? acc - 256 : acc;
    } else {
      v = static_cast<int8_t>(stream[i]);
    }
    out[i] = static_cast<float>(v) * scale;
  }
}

}  // namespace

// x (nb * block,) f32 -> stream (nb * block,) bytes (int8, or uint8 deltas
// when delta != 0) and scales (nb,) f32.  block is a multiple of 128 and nb
// is at least 1.  Returns the cudaError_t of the launch (0 = success).
extern "C" int codec_encode_f32(const void* x, void* stream, void* scales,
                                int nb, int block, int delta, void* cuda_stream) {
  codec_encode_kernel<<<nb, kEncodeThreads, block, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(stream),
      static_cast<float*>(scales), block, delta);
  return static_cast<int>(cudaGetLastError());
}

// Inverse of codec_encode_f32: stream (nb * block,) bytes and scales (nb,)
// -> out (nb * block,) f32.
extern "C" int codec_decode_f32(const void* stream, const void* scales, void* out,
                                int nb, int block, int delta, void* cuda_stream) {
  codec_decode_kernel<<<nb, kLanes, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const uint8_t*>(stream), static_cast<const float*>(scales),
      static_cast<float*>(out), block, delta);
  return static_cast<int>(cudaGetLastError());
}
