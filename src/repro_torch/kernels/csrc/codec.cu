// Per-block int8 quantisation for Hopper (sm_90a): the fused activation
// codec (encode with an optional mod-256 row delta, and its inverse) and the
// legacy per-tensor quant pair, on one register-resident body.
//
// Replaces the TPU kernels src/repro/kernels/codec.py :: codec_encode_pallas
// (_encode_kernel) and codec_decode_pallas (_decode_kernel), B2 and B3, and
// src/repro/kernels/quant.py :: quant_pallas (_quant_kernel) and
// dequant_pallas (_dequant_kernel), B4a and B4b.  All must be bitwise equal
// to the reference: the same stream bytes and the same scale bits.  Hence
// IEEE division (__fdiv_rn; this file is never built with fast math), round
// half to even with rintf, the scale as a multiply by f32(1/127), and
// integer arithmetic for the delta.
//
// Bound on the H100.  All are bound by bytes, with a handful of operations
// per element: encode reads 4 B and writes 1 B per element (plus 4 B per
// block), decode the reverse.  The design keeps the bytes in flight:
//
// Layout.  One CTA of 8 warps per quantisation block; a block is `rows`
// rows of 128 lanes (8192 f32 = 64 rows by default).  Lane l of every warp
// owns columns 4l..4l+3, so one warp instruction moves a whole row: 512
// contiguous bytes of f32 (a float4 a thread) or 128 of int8 (a 32-bit word
// a thread).  The rows are taken in chunks of up to 64; a chunk's rows are
// cut into 8 contiguous strips of at most 8 rows, one per warp (strip_of),
// held in registers.  Longer blocks loop over their chunks.
//
// Encode.  All of a strip's 16-byte loads are issued before any arithmetic.
// absmax: fmaxf over the registers, warp shuffles, one shared word per warp,
// one barrier.  A block of one chunk keeps its values in registers from the
// absmax to the quantisation, so it is read from device memory once; a
// longer block reads each chunk again in a second pass (from L1/L2).  The
// four quantised bytes of a row are packed into one word; the delta is a
// per-byte subtraction (__vsub4, mod 256) against the row above: inside the
// strip from registers, across warps through 128 bytes of shared memory per
// warp (a second barrier), and across chunks by quantising the previous
// chunk's last row again.  Row 0 of a block stays absolute.
//
// Decode.  The same strips.  Without the delta each word of four int8 is
// converted and scaled in registers and written as one float4.  With it, a
// per-byte running sum (__vadd4, mod 256) down the strip, each warp's column
// totals through shared memory (one barrier), and each thread adds the sum
// of the totals of the warps above it and of the earlier chunks.  Mod-256
// addition is associative, so this split of the running sum gives the
// reference's bytes exactly; a byte read as int8 is the value above 127
// folded back to negative.
//
// Ragged (kRagged, the quant pair).  A leaf of n values is cut into
// ceil(n / block) blocks and only the last may end early; the reference pads
// it with zeros in device memory, here nothing is padded.  The strips cover
// the rows that hold values (Extent::rows); the one row that straddles n is
// read (quant) or written (dequant) lane by lane with scalar accesses masked
// at n, and nothing past n is read or written.  Quant writes the rows past n
// as zero words, the bytes the reference's zero padding quantises to, so q
// is whole (nb, block); a zero read in the straddling row counts in the
// absmax as the padding does.  Dequant writes the (n,) values only, so the
// reference's [:n] slice is fused into it.  Without kRagged the extent is
// the whole block and B2/B3 compile as before.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 8;                        // rows a warp holds at once
constexpr int kChunkRows = kWarps * kStrip;      // 64 rows = 8192 values
constexpr float kInt8Max = 127.0f;
constexpr float kInvInt8Max = 0x1.020408p-7f;   // f32(1) / f32(127), as the reference

struct Strip {
  int first;   // the strip's first row in the block
  int n;       // its rows, 0..kStrip
};

// The values of block blockIdx.x that lie before n, and the rows they fill.
struct Extent {
  int valid;   // values: block, or fewer in a ragged leaf's last block
  int rows;    // rows that hold any value: ceil(valid / kLanes)
  int full;    // rows that hold only values: valid / kLanes
};

template <bool kRagged>
__device__ __forceinline__ Extent extent_of(int block, long long n) {
  if constexpr (!kRagged) {
    return {block, block / kLanes, block / kLanes};
  } else {
    const long long left = n - static_cast<long long>(blockIdx.x) * block;
    const int valid = left < block ? static_cast<int>(left) : block;
    return {valid, (valid + kLanes - 1) / kLanes, valid / kLanes};
  }
}

// Rows [first, first + n) of chunk `chunk` belong to warp `warp`: the
// chunk's rows in kWarps contiguous strips of ceil(rows_in_chunk / kWarps).
__device__ __forceinline__ Strip strip_of(int chunk, int rows, int warp) {
  const int row0 = chunk * kChunkRows;
  const int rows_c = min(kChunkRows, rows - row0);
  const int per = (rows_c + kWarps - 1) / kWarps;
  const int lo = warp * per;
  return {row0 + lo, max(0, min(per, rows_c - lo))};
}

__device__ __forceinline__ uint32_t quant1(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -kInt8Max), kInt8Max);
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xFFu;
}

// four f32 -> four int8 in one word, column 4l in the low byte
__device__ __forceinline__ uint32_t quant4(float4 v, float scale) {
  return quant1(v.x, scale) | quant1(v.y, scale) << 8
       | quant1(v.z, scale) << 16 | quant1(v.w, scale) << 24;
}

// byte k of p as a signed int8, as a float
__device__ __forceinline__ float sbyte(uint32_t p, int k) {
  return static_cast<float>(static_cast<int>(p << (24 - 8 * k)) >> 24);
}

// Columns 4l..4l+3 of a row of which the first `left` (1..127) values lie
// before n: scalar loads of those, zero past them.
__device__ __forceinline__ float4 load_masked(const float* row, int left, int lane) {
  const int c = 4 * lane;
  return make_float4(c + 0 < left ? __ldg(row + c + 0) : 0.f,
                     c + 1 < left ? __ldg(row + c + 1) : 0.f,
                     c + 2 < left ? __ldg(row + c + 2) : 0.f,
                     c + 3 < left ? __ldg(row + c + 3) : 0.f);
}

// The store of load_masked's columns: nothing at or past `left`.
__device__ __forceinline__ void store_masked(float* row, int left, int lane, float4 f) {
  const int c = 4 * lane;
  if (c + 0 < left) row[c + 0] = f.x;
  if (c + 1 < left) row[c + 1] = f.y;
  if (c + 2 < left) row[c + 2] = f.z;
  if (c + 3 < left) row[c + 3] = f.w;
}

// One block: x (block,) f32 at x + blockIdx.x * block -> its bytes and scale.
template <bool kDelta, bool kRagged>
__device__ __forceinline__ void encode_block(const float* __restrict__ x,
                                             uint8_t* __restrict__ stream,
                                             float* __restrict__ scales,
                                             int block, long long n) {
  __shared__ float warp_max[kWarps];
  __shared__ uint32_t last_row[2][kWarps][32];   // by chunk parity
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Extent e = extent_of<kRagged>(block, n);
  const int rows = e.rows;
  const int chunks = (rows + kChunkRows - 1) / kChunkRows;
  const size_t base = static_cast<size_t>(blockIdx.x) * block;
  // row r of this block: xb[r * 32] and ob[r * 32] for this lane
  const float4* xb = reinterpret_cast<const float4*>(x + base) + lane;
  uint32_t* ob = reinterpret_cast<uint32_t*>(stream + base) + lane;

  float4 v[kStrip];
  auto load = [&](const Strip& s) {
#pragma unroll
    for (int i = 0; i < kStrip; ++i)
      if (i < s.n) {
        const int r = s.first + i;
        if (!kRagged || r < e.full)
          v[i] = __ldg(xb + static_cast<size_t>(r) * 32);
        else
          v[i] = load_masked(x + base + static_cast<size_t>(r) * kLanes,
                             e.valid - r * kLanes, lane);
      }
  };

  float m = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const Strip s = strip_of(c, rows, warp);
    load(s);
#pragma unroll
    for (int i = 0; i < kStrip; ++i)
      if (i < s.n)
        m = fmaxf(m, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                           fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  float absmax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) absmax = fmaxf(absmax, warp_max[w]);
  const float scale = absmax > 0.f ? absmax * kInvInt8Max : 1.0f;

  for (int c = 0; c < chunks; ++c) {
    const Strip s = strip_of(c, rows, warp);
    if (chunks > 1) load(s);              // one chunk: still in registers
    uint32_t q[kStrip];
#pragma unroll
    for (int i = 0; i < kStrip; ++i)
      if (i < s.n) q[i] = quant4(v[i], scale);
    if (kDelta) {
      uint32_t last = 0;
#pragma unroll
      for (int i = 0; i < kStrip; ++i)
        if (i == s.n - 1) last = q[i];
      if (s.n > 0) last_row[c & 1][warp][lane] = last;
      __syncthreads();
      uint32_t prev = 0;                  // row 0 stays absolute
      if (s.n > 0 && s.first > 0)
        prev = warp > 0 ? last_row[c & 1][warp - 1][lane]
                        : quant4(__ldg(xb + static_cast<size_t>(s.first - 1) * 32), scale);
#pragma unroll
      for (int i = 0; i < kStrip; ++i)
        if (i < s.n) {
          const uint32_t d = __vsub4(q[i], prev);   // per byte, mod 256
          prev = q[i];
          q[i] = d;
        }
    }
#pragma unroll
    for (int i = 0; i < kStrip; ++i)
      if (i < s.n) ob[static_cast<size_t>(s.first + i) * 32] = q[i];
  }
  if constexpr (kRagged) {                // past n: the padding's zero bytes
    for (int r = rows + warp; r < block / kLanes; r += kWarps)
      ob[static_cast<size_t>(r) * 32] = 0u;
  }
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
}

// One block: its bytes and scale -> out (block,) f32, or with kRagged the
// values before n.
template <bool kDelta, bool kRagged>
__device__ __forceinline__ void decode_block(const uint8_t* __restrict__ stream,
                                             const float* __restrict__ scales,
                                             float* __restrict__ out,
                                             int block, long long n) {
  __shared__ uint32_t col_total[2][kWarps][32];  // by chunk parity
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Extent e = extent_of<kRagged>(block, n);
  const int rows = e.rows;
  const int chunks = (rows + kChunkRows - 1) / kChunkRows;
  const size_t base = static_cast<size_t>(blockIdx.x) * block;
  const uint32_t* sb = reinterpret_cast<const uint32_t*>(stream + base) + lane;
  float4* ob = reinterpret_cast<float4*>(out + base) + lane;
  const float scale = scales[blockIdx.x];

  uint32_t carry = 0;         // column sums of the earlier chunks, per byte
  for (int c = 0; c < chunks; ++c) {
    const Strip s = strip_of(c, rows, warp);
    uint32_t q[kStrip];
#pragma unroll
    for (int i = 0; i < kStrip; ++i)
      if (i < s.n) q[i] = __ldg(sb + static_cast<size_t>(s.first + i) * 32);
    if (kDelta) {
      uint32_t run = 0;
#pragma unroll
      for (int i = 0; i < kStrip; ++i)
        if (i < s.n) {
          run = __vadd4(run, q[i]);       // per byte, mod 256
          q[i] = run;
        }
      col_total[c & 1][warp][lane] = run;   // 0 for an empty strip
      __syncthreads();
      uint32_t above = carry;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t t = col_total[c & 1][w][lane];
        if (w < warp) above = __vadd4(above, t);
        carry = __vadd4(carry, t);
      }
#pragma unroll
      for (int i = 0; i < kStrip; ++i)
        if (i < s.n) q[i] = __vadd4(q[i], above);
    }
#pragma unroll
    for (int i = 0; i < kStrip; ++i)
      if (i < s.n) {
        const int r = s.first + i;
        const float4 f = make_float4(
            sbyte(q[i], 0) * scale, sbyte(q[i], 1) * scale,
            sbyte(q[i], 2) * scale, sbyte(q[i], 3) * scale);
        if (!kRagged || r < e.full)
          ob[static_cast<size_t>(r) * 32] = f;
        else
          store_masked(out + base + static_cast<size_t>(r) * kLanes,
                       e.valid - r * kLanes, lane, f);
      }
  }
}

// At most 64 registers a thread without the delta (four CTAs an SM: the
// 479 blocks of a split-1 stream in one wave); the delta's boundary words
// take a few more, so three.
template <bool kDelta>
__global__ void __launch_bounds__(kThreads, kDelta ? 3 : 4)
codec_encode_kernel(const float* __restrict__ x, uint8_t* __restrict__ stream,
                    float* __restrict__ scales, int block) {
  encode_block<kDelta, false>(x, stream, scales, block, 0);
}

template <bool kDelta>
__global__ void __launch_bounds__(kThreads)
codec_decode_kernel(const uint8_t* __restrict__ stream,
                    const float* __restrict__ scales, float* __restrict__ out,
                    int block) {
  decode_block<kDelta, false>(stream, scales, out, block, 0);
}

__global__ void __launch_bounds__(kThreads, 4)
quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ scales, long long n, int block) {
  encode_block<false, true>(x, reinterpret_cast<uint8_t*>(q), scales, block, n);
}

__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
               float* __restrict__ out, long long n, int block) {
  decode_block<false, true>(reinterpret_cast<const uint8_t*>(q), scales, out,
                            block, n);
}

}  // namespace

// x (nb * block,) f32 -> stream (nb * block,) bytes (int8, or uint8 deltas
// when delta != 0) and scales (nb,) f32.  block is a multiple of 128, nb is
// at least 1, x is 16-byte aligned and stream 4-byte aligned.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int codec_encode_f32(const void* x, void* stream, void* scales,
                                int nb, int block, int delta, void* cuda_stream) {
  const auto s = static_cast<cudaStream_t>(cuda_stream);
  const auto* xp = static_cast<const float*>(x);
  auto* sp = static_cast<uint8_t*>(stream);
  auto* cp = static_cast<float*>(scales);
  if (delta) codec_encode_kernel<true><<<nb, kThreads, 0, s>>>(xp, sp, cp, block);
  else codec_encode_kernel<false><<<nb, kThreads, 0, s>>>(xp, sp, cp, block);
  return static_cast<int>(cudaGetLastError());
}

// Inverse of codec_encode_f32: stream (nb * block,) bytes (4-byte aligned)
// and scales (nb,) -> out (nb * block,) f32 (16-byte aligned).
extern "C" int codec_decode_f32(const void* stream, const void* scales, void* out,
                                int nb, int block, int delta, void* cuda_stream) {
  const auto s = static_cast<cudaStream_t>(cuda_stream);
  const auto* sp = static_cast<const uint8_t*>(stream);
  const auto* cp = static_cast<const float*>(scales);
  auto* op = static_cast<float*>(out);
  if (delta) codec_decode_kernel<true><<<nb, kThreads, 0, s>>>(sp, cp, op, block);
  else codec_decode_kernel<false><<<nb, kThreads, 0, s>>>(sp, cp, op, block);
  return static_cast<int>(cudaGetLastError());
}

// x (n,) f32 (16-byte aligned, not padded) -> q (nb * block,) int8 and
// scales (nb,) f32, nb = ceil(n / block) >= 1, block a multiple of 128.
extern "C" int quant_f32(const void* x, void* q, void* scales, long long n,
                         int nb, int block, void* cuda_stream) {
  quant_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scales), n, block);
  return static_cast<int>(cudaGetLastError());
}

// q (at least ceil(n / block) * block,) int8 (4-byte aligned) and its scales
// -> out (n,) f32 (16-byte aligned), n >= 1.
extern "C" int dequant_f32(const void* q, const void* scales, void* out,
                           long long n, int block, void* cuda_stream) {
  const auto nb = static_cast<unsigned>((n + block - 1) / block);
  dequant_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), n, block);
  return static_cast<int>(cudaGetLastError());
}
