// Flash decode: one new query token against a KV-major cache, for Hopper
// (sm_90a), in one launch: a thread-block cluster per (batch row, kv head)
// whose CTAs stream K and V through a ring of bulk asynchronous copies and
// combine their partials in distributed shared memory.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py ::
// decode_attention_pallas (_decode_kernel).  It computes what that kernel
// computes: for batch row b and kv head n, the G = H / KV query heads
// n G .. n G + G - 1 of q (B, 1, H, hd) attend to the first kv_len[b] rows
// of k and v; q multiplied by hd^-1/2 after its cast to f32, an f32 softmax,
// out = acc / max(l, 1e-30) in q's dtype, so kv_len = 0 gives zeros.  The
// cache is read in the layout the LM keeps, KV-major (B, KV, S, hd), so the
// decode path never transposes it; the TPU wrapper transposed a
// (B, S, KV, hd) cache into that layout before its launch.  A logit
// soft-cap c > 0 (the Pallas kernel has none) replaces each scaled score s
// by tanh(s / c) c, with tanhf and a true division, as the JAX package's
// cache_attention does; the launch picks an instantiation by c != 0, so
// c = 0 runs the uncapped body.
//
// Partial mode (decode_attention_lse_fwd), for a cache cut on its rows over
// several ranks (flash decode across ranks): the same body, whose output is
// f32, not rounded to q's dtype, beside the log-sum-exp of each row's
// scores, lse = m* + log l.  A row whose kv_len is 0 (a rank whose rows hold
// no live key yet) gets out = 0, lse = -inf.  The caller merges the ranks'
// (out, lse) with weights e^(lse_r - max lse) and rounds once.
//
// Bound on the H100: bytes.  At qwen3-1.7b's decode shape, q (4, 1, 16,
// 128) against a (4, 8, 2080, 128) bf16 cache at kv_len 2048, the kernel
// must read 33.5 MB of K and V, 0.0100 ms at 3.35 TB/s; the partial mode on
// the first half of that cache (rows 1040 / 1040 / 700 / 0 live) 11.4 MB,
// 0.0034 ms.  It does 4 flops a cached value and query head, far under the
// card's rate, so the products stay on the CUDA cores in f32.
//
// Design.  On the TPU the kv axis is a sequential grid dimension whose
// blocks past kv_len are skipped and whose state sits in VMEM.  Here:
//   - One cluster of C CTAs per (batch row, kv head), grid (C, KV, B), one
//     launch.  C (1-16) comes from the wrapper's cluster_plan, a function
//     of the shapes (B, KV, S, hd, the dtype) and the card's SMs: the
//     largest that keeps the grid within the kCtasPerSm (3) CTAs an SM of
//     the launch bounds, never more ranks than sub-tiles.  A layout whose
//     shared memory holds an SM to fewer leaves clusters, whose CTAs must
//     share one GPC, to a second wave: with 16 KB sub-tiles (78 KB a CTA,
//     two an SM) qwen3-1.7b's 32 clusters of 8 took 1.2x as long as its 32
//     of 4.  The grid never depends on the values of kv_len, which
//     every CTA reads on the device, so a decode step can be captured in a
//     CUDA graph.  There is no scratch in device memory and no second
//     kernel, which cost the split-KV design before this one a second
//     launch and a round trip of B H n_splits (hd + 2) f32 partials
//     through device memory.
//   - The cache rows [0, S) are cut into sub-tiles of kSubTileBytes of K
//     (and as many of V): 32 rows of bf16 at hd 128, 16 of f32.  Rank r of
//     the cluster takes sub-tiles r, r + C, r + 2C, ..., which spreads the
//     live rows evenly over the ranks whatever kv_len is.  A rank skips the
//     sub-tiles that start at or past kv_len; the last live one copies only
//     its live rows; a rank with no live row loads nothing and leaves
//     m = -1e30, l = 0, acc = 0 (-1e30, not -inf, so the combine never
//     computes exp(-inf + inf)).
//   - The producer warp initialises the ring's mbarriers and issues its
//     first copies without waiting for the consumers, which load their q
//     meanwhile and meet it at a named barrier (bar.arrive on its side).
//   - A producer warp streams K and V ahead of compute: each sub-tile's K
//     rows and V rows, contiguous in the cache, are one bulk asynchronous
//     copy each into a stage of a ring of kRing stages, with a full
//     mbarrier that counts the bytes and an empty one that the consumer
//     warps release.  So V never waits behind K's softmax and kRing
//     sub-tiles are in flight a CTA, where the split-KV body loaded K, ran
//     the softmax and only then loaded V, with 4 rows a lane in flight.
//   - kConsumerWarps consumer warps share a stage.  A warp holds at most
//     kWarpHeads query heads (q scaled in registers, its running max m,
//     sum l and acc): the G heads are dealt to kHS head slices of warps
//     (head g to slice g mod kHS), the fewest over which they deal evenly,
//     and the rows of a stage to the kRS = kConsumerWarps / kHS warps of a
//     slice, each a block of the stage's rows.  The instantiations take G
//     of 1, 2, 3, 4, 6, 8 and 16 (those of the configs exactly), so no
//     warp scores a head that does not exist but where G is 5, 7 or 9-15.
//     A lane takes two 16-byte pieces of a row where its warp holds at most
//     two heads, one otherwise (kP), and a row's kL lanes reduce its score
//     with shuffles: at qwen3-1.7b's G = 2, 8 lanes a bf16 row of 128, 3
//     shuffles for 4 rows.  Every lane runs every shuffle (a shuffle under
//     a branch on the runtime head count cost WARPSYNC sequences).  A warp
//     scores kBatch row steps in base-2 units, takes their max, rescales l
//     and acc where the max rose, then accumulates P.V from the same
//     stage's V.
//   - The combine in distributed shared memory: every rank merges its row
//     slices in order into its partial (m, l, acc) and stores it into rank
//     0's shared memory (st.shared::cluster), then arrives at the cluster
//     barrier with release and, unless it is rank 0, leaves.  Rank 0 waits,
//     then computes each output from the C partials in rank order: m* =
//     max m_i, l = sum l_i e^(m_i - m*), out = sum acc_i e^(m_i - m*) /
//     max(l, 1e-30), as the split-KV combine did, its C partials' loads
//     issued together.  A relaxed arrival when
//     each CTA starts, waited for before the stores, makes sure rank 0
//     runs before anything is stored into it.  One barrier phase and posted
//     stores, where pulling the partials (ld.shared::cluster) took two
//     phases and a load's round trip.  No atomics: every sum runs in an
//     order the plan fixes, so two launches on the same inputs give the
//     same bits.
//   The levers (kSubTileBytes, kRing, kCtasPerSm, kConsumerWarps, kP) are
//   constants of this source; tools/b6_tiles.py times copies of it with
//   other values.  The wrapper takes kSubTileBytes and kCtasPerSm, which
//   its plan needs, from decode_attention_geometry.
//
// Shared memory a CTA: the ring, kRing x 2 x kSubTileBytes = 32 KB, its 2
// kRing mbarriers, the row slices' partials where kRS > 1 and the C
// gathered ones, (kRS + C) G (hd + 2) f32: 45,280 B at qwen3-1.7b's G = 2,
// hd 128 and C = 8, so the three CTAs of the launch bounds fit an SM.  A layout past the 227 KB a CTA
// may have is refused with cudaErrorInvalidConfiguration, and a cluster the
// card cannot place with cudaErrorLaunchOutOfResources.  The wrapper's host
// time: it allocates the outputs only and takes the raw stream handle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumerWarps = 4;           // warps that compute; one more loads
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kSubTileBytes = 8192;         // a sub-tile's K rows (and its V rows)
constexpr int kRing = 2;                    // stages of the ring
constexpr int kCtasPerSm = 3;               // CTAs an SM: the launch bounds, and the plan's aim
constexpr int kWarpHeads = 4;               // query heads a consumer warp holds at most
constexpr int kBatch = 4;                   // row steps a warp scores between rescales
constexpr int kMaxG = 16;
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;            // 227 KB, the most a CTA may have
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 16 bytes of a row as f32, into x[0, 16 / sizeof(T))
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bf16 is the top half of its f32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// The head slices of GM query heads: the fewest warps (a divisor of
// kConsumerWarps) over which they deal evenly with at most kWarpHeads a warp.
constexpr int head_slices(int gm) {
  for (int h = 1; h < kConsumerWarps; h *= 2)
    if (gm % h == 0 && gm / h <= kWarpHeads) return h;
  return kConsumerWarps;
}

// The geometry of an instantiation: T the cache's dtype, HD the head dim,
// GM the most query heads a kv head it takes.
template <typename T, int HD, int GM>
struct Geom {
  static constexpr int kE = 16 / static_cast<int>(sizeof(T));  // elements in 16 bytes
  static constexpr int kRows = kSubTileBytes / (HD * static_cast<int>(sizeof(T)));
  static constexpr int kHS = head_slices(GM);
  static constexpr int kGW = GM / kHS;                          // heads a warp
  static constexpr int kRS = kConsumerWarps / kHS;              // row slices
  static constexpr int kSliceRows = kRows / kRS;
  // 16-byte pieces a lane takes of a row: two where a warp holds at most
  // two heads (their q and acc fit the registers), which halves a row's
  // lanes and so its shuffles
  static constexpr int kP = kGW <= 2 && HD >= 2 * kE ? 2 : 1;
  static constexpr int kL = HD / (kE * kP);                     // lanes a row
  static constexpr int kRW = 32 / kL;                           // rows a warp step
  static constexpr int kB = kBatch < kSliceRows / kRW ? kBatch : kSliceRows / kRW;
  static_assert(kConsumerWarps % kHS == 0 && GM % kHS == 0 && kGW <= kWarpHeads,
                "head slices");
  static_assert(kSliceRows >= kRW && kSliceRows % kRW == 0, "row slices");
  // shared memory: the ring, its barriers (full, then empty), the row
  // slices' partials where there are several, and the cluster's C partials
  // (rank 0's gather them)
  static constexpr int kStage = 2 * kSubTileBytes;
  static constexpr int kBars = kRing * kStage;
  static constexpr int kPart = kBars + 16 * kRing;
  static int smem_bytes(int G, int C) {
    return kPart + 4 * ((kRS > 1 ? kRS : 0) + C) * G * (HD + 2);
  }
};

// Rows [0, rows) of K and V of a (batch row, kv head) at k and v into a
// stage, K at dst and V at dst + kSubTileBytes: two bulk copies issued by
// lane 0 of the producer warp, whose bytes complete a transaction on full.
template <typename T, int HD>
__device__ __forceinline__ void fill(uint32_t dst, const T* k, const T* v, int rows,
                                     uint32_t full, int lane) {
  const uint32_t bytes = static_cast<uint32_t>(rows) * HD * sizeof(T);
  if (lane == 0) {
    mbar_arrive_expect_tx(full, 2 * bytes);
    bulk_load(dst, k, bytes, full);
    bulk_load(dst + kSubTileBytes, v, bytes, full);
  }
}

// o (B, 1, H, hd) in T, or in f32 when lse is not null (the partial mode,
// lse (B, H) f32)
template <typename T, int HD, int GM, bool kCap>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kv_len,
                        void* __restrict__ out, float* __restrict__ lse, int H, int KV,
                        int S, float softcap, float sm_scale) {
  using Gm = Geom<T, HD, GM>;
  constexpr int E = Gm::kE;
  constexpr int P = Gm::kP;
  constexpr int L = Gm::kL;
  constexpr int KB = Gm::kB;
  constexpr int RW = Gm::kRW;
  constexpr int ROWS = Gm::kRows;
  constexpr int HS = Gm::kHS;
  constexpr int GW = Gm::kGW;
  constexpr int RS = Gm::kRS;
  constexpr int SR = Gm::kSliceRows;
  constexpr int PW = HD + 2;                // a head's partial: m, l, acc[HD]
  extern __shared__ __align__(128) unsigned char smem[];

  const int G = H / KV;
  const int C = gridDim.x;                  // the cluster: grid x is one cluster wide
  const int rank = static_cast<int>(cluster_ctarank());
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(kv_len[b], 0), S);  // rows past the cache are never read
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const uint32_t ring = smem_u32(smem);
  auto full = [&](int st) { return ring + Gm::kBars + 8 * st; };
  auto empty = [&](int st) { return ring + Gm::kBars + 8 * (kRing + st); };
  float* part = reinterpret_cast<float*>(smem + Gm::kPart);   // [RS][G][PW] where RS > 1
  float* recv = RS > 1 ? part + RS * G * PW : part;            // [C][G][PW]
  // the partial of this rank's row g at c, in rank 0's shared memory
  const uint32_t to = mapa(smem_u32(recv + rank * G * PW), 0);
  auto put = [&](int g, int c, float x) { st_cluster(to + 4u * (g * PW + c), x); };

  cluster_arrive_relaxed();               // this CTA runs: its shared memory may be written
  // a consumer's q, loaded while kv_len's load is in flight (and scaled
  // after the barrier below, so that no warp waits for it there)
  const int hs = warp % HS;               // this warp's heads: hs, hs + HS, ...
  const int rs = warp / HS;               // and its block of a stage's rows
  const int sub = lane % L;               // this lane's pieces of a row: sub, sub + L, ...
  const int rw = lane / L;                // this lane's row of a warp step
  float qr[GW][P * E], acc[GW][P * E], m[GW], l[GW];
  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(n) * G) * HD + sub * E;
#pragma unroll
  for (int i = 0; i < GW; ++i) {
    const int g = hs + HS * i;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < P * E; ++e) acc[i][e] = qr[i][e] = 0.f;
    if (warp < kConsumerWarps && g < G) {
#pragma unroll
      for (int pc = 0; pc < P; ++pc) load16(qb + g * HD + pc * L * E, qr[i] + pc * E);
    }
  }

  const size_t head = (static_cast<size_t>(b) * KV + n) * S * HD;
  if (warp == kConsumerWarps) {
    // the producer sets up the ring and starts its copies at once; the
    // consumers wait at named barrier 2 for the ring's mbarriers
    if (lane == 0) {
      for (int st = 0; st < kRing; ++st) {
        mbar_init(full(st), 1);               // the producer's arrival and the copies' bytes
        mbar_init(empty(st), kConsumerWarps);  // a lane of each consumer warp
      }
      mbar_fence_init();
    }
    __syncwarp();
    bar_arrive(2, kThreads);
    // the rank's live sub-tiles in order, a stage each
    int i = 0;
    for (int t = rank; t * ROWS < len; t += C, ++i) {
      const int st = i % kRing;
      mbar_wait(empty(st), ((i / kRing) & 1) ^ 1);
      const size_t off = head + static_cast<size_t>(t) * ROWS * HD;
      fill<T, HD>(ring + st * Gm::kStage, k + off, v + off, min(ROWS, len - t * ROWS),
                  full(st), lane);
    }
    __syncwarp();
    cluster_wait();
  } else {
    bar_sync(2, kThreads);
#pragma unroll
    for (int i = 0; i < GW; ++i)
#pragma unroll
      for (int e = 0; e < P * E; ++e) qr[i][e] *= sm_scale;

    int i_st = 0;
    for (int t = rank; t * ROWS < len; t += C, ++i_st) {
      const int st = i_st % kRing;
      mbar_wait(full(st), (i_st / kRing) & 1);
      const int r_end = min(rs * SR + SR, len - t * ROWS);  // the slice's live rows end
      const T* ks = reinterpret_cast<const T*>(smem + st * Gm::kStage) + sub * E;
      const T* vs = ks + kSubTileBytes / static_cast<int>(sizeof(T));
      for (int j0 = rs * SR + rw; j0 - rw < r_end; j0 += KB * RW) {
        float s[KB][GW];
        float mc[GW];
#pragma unroll
        for (int i = 0; i < GW; ++i) mc[i] = kNegInf;
        // scores of KB row steps in base-2 units; a row's L lanes reduce
        // with shuffles.
        // Every lane runs every shuffle: a slot past G holds q = 0 and its
        // state is never written out.
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          const int j = j0 + u * RW;
          float x[P * E];
          if (j < r_end) {
#pragma unroll
            for (int pc = 0; pc < P; ++pc) load16(ks + j * HD + pc * L * E, x + pc * E);
          } else {
#pragma unroll
            for (int e = 0; e < P * E; ++e) x[e] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < GW; ++i) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < P * E; ++e) d = fmaf(qr[i][e], x[e], d);
#pragma unroll
            for (int off = L / 2; off > 0; off >>= 1)
              d += __shfl_xor_sync(0xffffffffu, d, off);
            if constexpr (kCap) d = tanhf(d / softcap) * softcap;
            s[u][i] = j < r_end ? d * kLog2e : kNegInf;
            mc[i] = fmaxf(mc[i], s[u][i]);
          }
        }
        // the warp's max over these rows, then a rescale of l and acc
        // where it rose (m is the warp's, so the branch is too; alpha would
        // be 1 exactly where it did not)
#pragma unroll
        for (int i = 0; i < GW; ++i) {
#pragma unroll
          for (int off = L; off < 32; off <<= 1)
            mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], off));
          if (mc[i] > m[i]) {
            const float alpha = exp2f(m[i] - mc[i]);
            m[i] = mc[i];
            l[i] *= alpha;
#pragma unroll
            for (int e = 0; e < P * E; ++e) acc[i][e] *= alpha;
          }
        }
        // P.V over the same rows, from the same stage's V
#pragma unroll
        for (int u = 0; u < KB; ++u) {
          const int j = j0 + u * RW;
          if (j < r_end) {
            float x[P * E];
#pragma unroll
            for (int pc = 0; pc < P; ++pc) load16(vs + j * HD + pc * L * E, x + pc * E);
#pragma unroll
            for (int i = 0; i < GW; ++i) {
              const float p = exp2f(s[u][i] - m[i]);
              l[i] += p;
#pragma unroll
              for (int e = 0; e < P * E; ++e) acc[i][e] = fmaf(p, x[e], acc[i][e]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // the warp's rows meet over the lanes that share `sub`
#pragma unroll
    for (int off = L; off < 32; off <<= 1)
#pragma unroll
      for (int i = 0; i < GW; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
        for (int e = 0; e < P * E; ++e) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
      }
    // the warp's (m, l, acc): into rank 0's gather where the warp's rows are
    // the CTA's, else into the row slices' partials to be merged in order
    if constexpr (RS == 1) {
      __syncwarp();
      cluster_wait();                     // every CTA of the cluster runs
    }
#pragma unroll
    for (int i = 0; i < GW; ++i) {
      const int g = hs + HS * i;
      if (g < G && rw == 0) {
        float* p = part + (rs * G + g) * PW;
        auto keep = [&](int c, float x) {
          if constexpr (RS == 1) put(g, c, x); else p[c] = x;
        };
        if (sub == 0) {
          keep(0, m[i]);
          keep(1, l[i]);
        }
#pragma unroll
        for (int pc = 0; pc < P; ++pc)
#pragma unroll
          for (int e = 0; e < E; ++e) keep(2 + (pc * L + sub) * E + e, acc[i][pc * E + e]);
      }
    }
    if constexpr (RS > 1) {
      bar_sync(1, 32 * kConsumerWarps);
      cluster_wait();                     // every CTA of the cluster runs
      for (int idx = threadIdx.x; idx < G * PW; idx += 32 * kConsumerWarps) {
        const int g = idx / PW;
        const int c = idx % PW;
        float mx = kNegInf;
#pragma unroll
        for (int r = 0; r < RS; ++r) mx = fmaxf(mx, part[(r * G + g) * PW]);
        float y = mx;
        if (c > 0) {
          y = 0.f;
#pragma unroll
          for (int r = 0; r < RS; ++r)
            y += part[(r * G + g) * PW + c] * exp2f(part[(r * G + g) * PW] - mx);
        }
        put(g, c, y);
      }
    }
  }

  // every rank's partial stored into rank 0, which alone waits for them;
  // the others leave (nothing reads their shared memory)
  __syncwarp();
  cluster_arrive_release();
  if (rank != 0) return;
  cluster_wait();
  for (int o = threadIdx.x; o < G * HD; o += kThreads) {
    const int g = o / HD;
    const int d = o % HD;
    const float* pg = recv + g * PW;      // rank i's at pg + i G PW
    float mi[kMaxCluster], li[kMaxCluster], ai[kMaxCluster];
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i) {
      if (i < C) {                        // the loads issued together, then used
        mi[i] = pg[i * G * PW];
        li[i] = pg[i * G * PW + 1];
        ai[i] = pg[i * G * PW + 2 + d];
      }
    }
    float m_star = kNegInf;
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i)
      if (i < C) m_star = fmaxf(m_star, mi[i]);
    float lt = 0.f, a = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxCluster; ++i) {
      if (i < C) {
        const float w = exp2f(mi[i] - m_star);
        lt += li[i] * w;
        a += ai[i] * w;
      }
    }
    const size_t row = static_cast<size_t>(b) * H + static_cast<size_t>(n) * G + g;
    const float y = a / fmaxf(lt, 1e-30f);
    if (lse != nullptr) {
      static_cast<float*>(out)[row * HD + d] = y;
      if (d == 0)                           // m* in base-2 units; -inf where l = 0
        lse[row] = lt > 0.f ? m_star * kLn2 + logf(lt) : __int_as_float(0xff800000);
    } else {
      store1(static_cast<T*>(out) + row * HD + d, y);
    }
  }
}

template <typename T, int HD, int GM, bool kCap>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* o,
           float* lse, int B, int S, int H, int KV, int C, float softcap, float sm_scale,
           cudaStream_t stream) {
  using Gm = Geom<T, HD, GM>;
  auto kernel = decode_attention_kernel<T, HD, GM, kCap>;
  const int bytes = Gm::smem_bytes(H / KV, C);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  // once a device and host thread: the shared memory limit raised to the
  // most a CTA may have and clusters past 8 allowed; `placed` holds, for
  // each cluster size, the largest layout found to place
  static thread_local int last_dev = -1;
  static thread_local int placed[5];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != last_dev) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int& p : placed) p = 0;
    last_dev = dev;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C), static_cast<unsigned>(KV), static_cast<unsigned>(B));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int c_log = C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : C == 8 ? 3 : 4;
  if (bytes > placed[c_log]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters == 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    placed[c_log] = bytes;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<const int*>(kv_len), o, lse,
                           H, KV, S, softcap, sm_scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int GM>
int dispatch_cap(const void* q, const void* k, const void* v, const void* kv_len, void* o,
                 float* lse, int B, int S, int H, int KV, int C, float softcap,
                 float sm_scale, cudaStream_t stream) {
  if (softcap != 0.f)
    return launch<T, HD, GM, true>(q, k, v, kv_len, o, lse, B, S, H, KV, C, softcap, sm_scale,
                                   stream);
  return launch<T, HD, GM, false>(q, k, v, kv_len, o, lse, B, S, H, KV, C, softcap, sm_scale,
                                  stream);
}

template <typename T, int HD>
int dispatch_g(const void* q, const void* k, const void* v, const void* kv_len, void* o,
               float* lse, int B, int S, int H, int KV, int C, float softcap, float sm_scale,
               cudaStream_t stream) {
  // the group sizes of the configs (1 musicgen, 2 qwen3-1.7b, 3 granite and
  // smollm, 4 qwen3-4b, 6 InternVL) exactly; 5 (hymba) on 6, 12 on 16
  const int G = H / KV;
#define B6_G(GM)                                                                            \
  if (G <= GM)                                                                              \
    return dispatch_cap<T, HD, GM>(q, k, v, kv_len, o, lse, B, S, H, KV, C, softcap, sm_scale, \
                                   stream);
  B6_G(1) B6_G(2) B6_G(3) B6_G(4) B6_G(6) B6_G(8)
#undef B6_G
  return dispatch_cap<T, HD, 16>(q, k, v, kv_len, o, lse, B, S, H, KV, C, softcap, sm_scale,
                                 stream);
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, const void* kv_len,
                void* o, float* lse, int B, int S, int H, int KV, int C, float softcap,
                float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(q, k, v, kv_len, o, lse, B, S, H, KV, C, softcap,
                                      sm_scale, stream);
    case 32: return dispatch_g<T, 32>(q, k, v, kv_len, o, lse, B, S, H, KV, C, softcap,
                                      sm_scale, stream);
    case 64: return dispatch_g<T, 64>(q, k, v, kv_len, o, lse, B, S, H, KV, C, softcap,
                                      sm_scale, stream);
    case 128: return dispatch_g<T, 128>(q, k, v, kv_len, o, lse, B, S, H, KV, C, softcap,
                                        sm_scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int entry(const void* q, const void* k, const void* v, const void* kv_len, void* o, float* lse,
          int B, int S, int H, int KV, int hd, int C, int dtype, float sm_scale, float softcap,
          void* cuda_stream) {
  cudaStream_t stream = static_cast<cudaStream_t>(cuda_stream);
  if (B < 1 || S < 0 || KV < 1 || H % KV != 0 || H / KV > kMaxG || !(softcap >= 0.f) ||
      (C != 1 && C != 2 && C != 4 && C != 8 && C != kMaxCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, kv_len, o, lse, B, S, H, KV, C, softcap, sm_scale,
                              stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, kv_len, o, lse, B, S, H, KV, C, softcap,
                                      sm_scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, 1, H, hd), k and v (B, KV, S, hd) KV-major, kv_len (B,) int32 on the
// device (clamped to [0, S]; 0 gives zeros), o (B, 1, H, hd); contiguous,
// 16-byte aligned, q, k, v and o of one dtype: 0 = f32, 1 = bf16.  hd is
// 16, 32, 64 or 128; H is a multiple of KV with H / KV <= 16; B and KV are
// at least 1; cluster, the CTAs of a (batch row, kv head), is 1, 2, 4, 8
// or 16; softcap 0 (no cap) or the logit soft-cap c > 0.  One launch;
// returns the first cudaError_t (0 = success).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, int B, int S, int H,
                                    int KV, int hd, int cluster, int dtype, float sm_scale,
                                    float softcap, void* cuda_stream) {
  return entry(q, k, v, kv_len, o, nullptr, B, S, H, KV, hd, cluster, dtype, sm_scale,
               softcap, cuda_stream);
}

// The constants the wrapper's cluster plan takes from this source: the bytes
// of K a sub-tile and the CTAs an SM of the launch bounds.
extern "C" void decode_attention_geometry(int* subtile_bytes, int* ctas_per_sm) {
  *subtile_bytes = kSubTileBytes;
  *ctas_per_sm = kCtasPerSm;
}

// The partial mode: as decode_attention_fwd, but o (B, 1, H, hd) is f32
// whatever q's dtype, and lse (B, H) f32 gets each row's log-sum-exp (-inf
// where kv_len is 0, with o = 0).
extern "C" int decode_attention_lse_fwd(const void* q, const void* k, const void* v,
                                        const void* kv_len, void* o, void* lse, int B, int S,
                                        int H, int KV, int hd, int cluster, int dtype,
                                        float sm_scale, float softcap, void* cuda_stream) {
  return entry(q, k, v, kv_len, o, static_cast<float*>(lse), B, S, H, KV, hd, cluster, dtype,
               sm_scale, softcap, cuda_stream);
}
