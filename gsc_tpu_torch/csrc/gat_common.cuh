// Device helpers shared by the GATv2 attention kernels (forward,
// gat_attention.cu, and backward, gat_attention_backward.cu): staging a
// graph's blocks into shared memory with TMA bulk copies, warp reductions,
// and the attention weights of a graph, which both kernels compute with the
// same code, so the backward's weights are the forward's bit for bit.
//
// Both kernels come in an f32 and a bf16 form (template parameter kBf16).
// The bf16 form stages the bf16 features, widens them to f32 in shared
// memory (exact), and rounds where the JAX package's bf16 branch of
// attention_dense rounds: the pairwise features e = bf16(xl_j + xr_i) and
// their LeakyReLU, bf16(kSlopeBf16 * e), are bf16 (act()), att enters as
// bf16(att), every product of two bf16 values is exact in f32, and the
// logits, the softmax and all sums are f32.
//
// A build with -DGAT_STAGE_CLOCKS records thread 0's clock64() of block 0
// at the kernels' stage barriers (read by the host functions
// gat_attention_stage_clocks and gat_attention_backward_stage_clocks), to
// see where a launch's time goes: slot 0 at the start, 1 when the graph is
// staged, 7 after the pair logits, 2 after the softmax, and the kernels'
// later stages in 3 to 6.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace gat {

constexpr int kMaxWarps = 32;
constexpr float kNegInf = -1e30f;
constexpr float kSlope = 0.2f;
// 0.2 rounded to bf16: the slope of the bf16 LeakyReLU, as the JAX
// package's weak-typed 0.2 becomes against bf16 features
constexpr float kSlopeBf16 = 0.2001953125f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// n rounded up to a multiple of 4: the row length of the [n][np] matrices,
// so that rows start 16-byte aligned and are read as float4.
__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Warps per block for graphs of n nodes: one per target row, at most 32.
__host__ __device__ inline int warps_for(int n) {
  return n < kMaxWarps ? n : kMaxWarps;
}

// Target rows per CTA.  A graph of up to kTileRows nodes is one CTA, as
// it always was; a larger one is cut into tiles of kTileRows rows (the
// last one shorter), one CTA each, since softmax rows are independent and
// one CTA's shared memory cannot hold a large graph's [N, N] weights.
constexpr int kTileRows = 32;
__host__ __device__ inline int tile_rows(int n) {
  return n < kTileRows ? n : kTileRows;
}
__host__ __device__ inline int row_tiles(int n) {
  return (n + tile_rows(n) - 1) / tile_rows(n);
}

#ifdef GAT_STAGE_CLOCKS
constexpr int kStageClocks = 8;
__device__ long long g_stage_clocks[kStageClocks];
#define GAT_CLOCK(s)                                              \
  do {                                                            \
    __syncthreads();                                              \
    if (blockIdx.x == 0 && threadIdx.x == 0)                      \
      g_stage_clocks[s] = clock64();                              \
  } while (0)
#else
#define GAT_CLOCK(s) \
  do {               \
  } while (0)
#endif

// LeakyReLU with slope 0.2: max(e, 0.2 e) is e for e >= 0 (-0 included)
// and 0.2 e below, as where(e >= 0, e, 0.2 e).
__device__ __forceinline__ float leaky(float e) {
  return fmaxf(e, kSlope * e);
}

// x rounded to the nearest bf16 (ties to even), back in f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The activation of a pairwise sum s = xl_jf + xr_if: LeakyReLU(s) in f32;
// in bf16 e = bf16(s) (s is the exact sum of two bf16 values rounded once
// to f32, and rounding it again to bf16 gives the correctly rounded bf16
// sum), then e or bf16(kSlopeBf16 * e), whose product is exact in f32.
template <bool kBf16>
__device__ __forceinline__ float act(float s) {
  if constexpr (kBf16) {
    const float e = round_bf16(s);
    return e >= 0.f ? e : round_bf16(kSlopeBf16 * e);
  } else {
    return leaky(s);
  }
}

// LeakyReLU'(s) times v: v where s >= 0 (the bf16 sum has the f32 sum's
// sign), the slope times v below.
template <bool kBf16>
__device__ __forceinline__ float slope_times(float s, float v) {
  return s >= 0.f ? v : (kBf16 ? kSlopeBf16 : kSlope) * v;
}

// count bf16 values at src (shared) widened to f32 at dst (shared), all
// threads of the block; the caller synchronises.
__device__ inline void widen_bf16(float* dst, const __nv_bfloat16* src,
                                  int count) {
#pragma unroll 1
  for (int t = threadIdx.x; t < count; t += blockDim.x)
    dst[t] = __bfloat162float(src[t]);
}

// The largest of the warp's values in one integer reduction: a float's
// bits, with the magnitude bits of a negative one flipped, order as
// signed integers do.
__device__ __forceinline__ float warp_max(float v) {
  int b = __float_as_int(v);
  b ^= (b >> 31) & 0x7fffffff;
  b = __reduce_max_sync(kFull, b);
  b ^= (b >> 31) & 0x7fffffff;
  return __int_as_float(b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// t = q d + r for 0 <= t < 2^20 and 0 < d <= 1024: (t + 0.5) / d lies at
// least 0.5 / d inside (q, q + 1), far beyond the product's rounding, so
// its floor is q.  inv_d = 1 / d, rounded, from the host.
__device__ __forceinline__ int div_floor(int t, float inv_d) {
  return __float2int_rz((static_cast<float>(t) + 0.5f) * inv_d);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A block can go by TMA bulk copy when its global address is 16-byte
// aligned and its size a multiple of 16 (the shared side is aligned by the
// kernels' layouts).
__device__ __forceinline__ bool bulk_ok(const void* src, size_t bytes) {
  return ((reinterpret_cast<uintptr_t>(src) | bytes) & 15) == 0;
}

// Thread 0: set up the block's barrier for `tx_bytes` of bulk copies.
__device__ __forceinline__ void barrier_init(uint64_t* bar,
                                             uint32_t tx_bytes) {
  const uint32_t a = smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(a) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  if (tx_bytes)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(a), "r"(tx_bytes) : "memory");
}

// Thread 0: one TMA 1-D bulk copy, global -> shared, completed on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Every thread: wait for the barrier's first phase (all bulk copies in).
__device__ __forceinline__ void barrier_wait(uint64_t* bar) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(0u)
        : "memory");
  } while (!done);
}

// One block to stage: `bytes` from global `src` to shared `dst`.
struct Block {
  void* dst;
  const void* src;
  uint32_t bytes;
};

// Stage `count` blocks: those that qualify go by TMA bulk copy (issued by
// thread 0, all on one barrier), the others by plain 4-byte or 1-byte
// loads of the whole block; returns the bulk bytes, which the caller waits
// for with barrier_wait after its __syncthreads.
template <int count>
__device__ inline uint32_t stage(const Block (&blocks)[count], uint64_t* bar) {
  uint32_t tx = 0;
#pragma unroll
  for (int k = 0; k < count; ++k)
    if (bulk_ok(blocks[k].src, blocks[k].bytes)) tx += blocks[k].bytes;
  if (threadIdx.x == 0) {
    barrier_init(bar, tx);
#pragma unroll
    for (int k = 0; k < count; ++k)
      if (bulk_ok(blocks[k].src, blocks[k].bytes))
        bulk_copy(blocks[k].dst, blocks[k].src, blocks[k].bytes, bar);
  }
#pragma unroll
  for (int k = 0; k < count; ++k) {
    const Block& b = blocks[k];
    if (bulk_ok(b.src, b.bytes)) continue;
    if (((reinterpret_cast<uintptr_t>(b.src) | b.bytes) & 3) == 0) {
      const uint32_t* s = static_cast<const uint32_t*>(b.src);
      uint32_t* d = static_cast<uint32_t*>(b.dst);
      for (uint32_t w = threadIdx.x; w < b.bytes / 4; w += blockDim.x)
        d[w] = s[w];
    } else {
      const unsigned char* s = static_cast<const unsigned char*>(b.src);
      unsigned char* d = static_cast<unsigned char*>(b.dst);
      for (uint32_t w = threadIdx.x; w < b.bytes; w += blockDim.x)
        d[w] = s[w];
    }
  }
  return tx;
}

// The logit of pair (i, j): sum_f att_f act(xl_jf + xr_if) over rows
// xl_j, xr_i and att of f floats, in four independent partial sums added
// as (c0 + c1) + (c2 + c3).  For even f the rows are 8-byte aligned and
// read as float2 (threads over consecutive j read xl in two conflict-free
// wavefronts when f / 2 is odd, as at f = 22).  In bf16, att holds
// bf16(att), so each product is exact.
template <bool kBf16>
__device__ __forceinline__ float logit(const float* xl_j, const float* xr_i,
                                       const float* att, int f) {
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  if ((f & 1) == 0) {
    const float2* x2 = reinterpret_cast<const float2*>(xl_j);
    const float2* r2 = reinterpret_cast<const float2*>(xr_i);
    const float2* a2 = reinterpret_cast<const float2*>(att);
    const int h = f >> 1;
    int q = 0;
#pragma unroll 1
    for (; q + 1 < h; q += 2) {
      const float2 x0 = x2[q], x1 = x2[q + 1];
      const float2 r0 = r2[q], r1 = r2[q + 1];
      const float2 a0 = a2[q], a1 = a2[q + 1];
      c0 = fmaf(act<kBf16>(x0.x + r0.x), a0.x, c0);
      c1 = fmaf(act<kBf16>(x0.y + r0.y), a0.y, c1);
      c2 = fmaf(act<kBf16>(x1.x + r1.x), a1.x, c2);
      c3 = fmaf(act<kBf16>(x1.y + r1.y), a1.y, c3);
    }
    if (q < h) {
      const float2 x0 = x2[q], r0 = r2[q], a0 = a2[q];
      c0 = fmaf(act<kBf16>(x0.x + r0.x), a0.x, c0);
      c1 = fmaf(act<kBf16>(x0.y + r0.y), a0.y, c1);
    }
  } else {
    int k = 0;
#pragma unroll 1
    for (; k + 3 < f; k += 4) {
      c0 = fmaf(act<kBf16>(xl_j[k] + xr_i[k]), att[k], c0);
      c1 = fmaf(act<kBf16>(xl_j[k + 1] + xr_i[k + 1]), att[k + 1], c1);
      c2 = fmaf(act<kBf16>(xl_j[k + 2] + xr_i[k + 2]), att[k + 2], c2);
      c3 = fmaf(act<kBf16>(xl_j[k + 3] + xr_i[k + 3]), att[k + 3], c3);
    }
#pragma unroll 1
    for (; k < f; ++k) c0 = fmaf(act<kBf16>(xl_j[k] + xr_i[k]), att[k], c0);
  }
  return (c0 + c1) + (c2 + c3);
}

// The softmax of target row i by one warp, in place: row[0..n) holds the
// row's logits and gets alpha_ij = exp(l_ij - max_j l) / max(sum_j
// exp(...), 1e-30) on the adjacency, exactly 0 off it and on a row without
// a neighbour.  Lanes take source nodes j; the row max is one integer
// reduction, then one expf per edge outside any branch, then a shuffle
// sum.  Returns deg_i (warp-uniform): the popcount of the ballots of the
// row's adjacency bytes.
__device__ inline int row_softmax(float* row, const unsigned char* arow,
                                  int n, int lane) {
  if (n <= 32) {  // one source node per lane, all in registers
    const bool in = lane < n;
    const bool nb = in && arow[lane];
    const int deg = __popc(__ballot_sync(kFull, nb));
    if (deg == 0) {
      if (in) row[lane] = 0.f;
      __syncwarp();
      return 0;
    }
    const float l = in ? row[lane] : kNegInf;
    // off the adjacency the logit is -1e30 below a finite max: exp gives
    // 0 there, and the select keeps that exact
    const float e = expf(l - warp_max(l));
    const float ex = nb ? e : 0.f;
    const float denom = fmaxf(warp_sum(ex), 1e-30f);
    if (in) row[lane] = ex / denom;
    __syncwarp();
    return deg;
  }
  int deg = 0;
  float m = kNegInf;
#pragma unroll 1
  for (int j0 = 0; j0 < n; j0 += 32) {
    const int j = j0 + lane;
    deg += __popc(__ballot_sync(kFull, j < n && arow[j]));
    if (j < n) m = fmaxf(m, row[j]);
  }
  if (deg == 0) {
#pragma unroll 1
    for (int j = lane; j < n; j += 32) row[j] = 0.f;
    __syncwarp();
    return 0;
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll 1
  for (int j = lane; j < n; j += 32) {
    const float e = expf(row[j] - m);
    const float ex = arow[j] ? e : 0.f;
    row[j] = ex;
    s += ex;
  }
  const float denom = fmaxf(warp_sum(s), 1e-30f);
#pragma unroll 1
  for (int j = lane; j < n; j += 32) row[j] = row[j] / denom;
  __syncwarp();
  return deg;
}

// The attention weights of r target rows of a graph of n nodes into alpha
// [r][np] (0 in the pad columns n..np-1) and each row's degree into deg
// [r]: xl [n][f] holds every source node, xr [r][f] and adj [r][n] the
// rows' own (r = n: the whole graph).  First the logits of every pair, all
// threads over the flattened pairs t = i n + j (so no lane idles at n = 24
// < 32), then the softmax, one warp per target row.  att [f];
// synchronises the block before returning.  A row's weights do not depend
// on which rows share its CTA.
template <bool kBf16>
__device__ inline void rows_alpha(const float* s_xl, const float* s_xr,
                                  const float* s_att,
                                  const unsigned char* s_adj, int n, int r,
                                  int np, int f, float inv_n, float* alpha,
                                  int* deg) {
#pragma unroll 1
  for (int t = threadIdx.x; t < r * n; t += blockDim.x) {
    const int i = div_floor(t, inv_n), j = t - i * n;
    const float l = logit<kBf16>(s_xl + j * f, s_xr + i * f, s_att, f);
    alpha[i * np + j] = s_adj[t] ? l : kNegInf;
  }
  __syncthreads();
  GAT_CLOCK(7);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
  for (int i = warp; i < r; i += blockDim.x >> 5) {
    float* row = alpha + i * np;
    const int d = row_softmax(row, s_adj + i * n, n, lane);
    if (lane < np - n) row[n + lane] = 0.f;
    if (lane == 0) deg[i] = d;
  }
  __syncthreads();
}

}  // namespace gat
