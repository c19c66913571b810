// Fused GATv2 attention stage, f32 and bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel gsc_tpu/ops/pallas_gat.py::_gat_kernel (launched
// by _gatv2_pallas_impl), which is dtype-polymorphic: gat_attention_f32
// takes f32 features, gat_attention_bf16 bf16 ones (the bf16 form below).
// Given projected features xl, xr [B, N, F], the attention vector att
// [F], bias [F] and the adjacency adj [B, N, N]
// (adj[b, i, j] = j is an in-neighbour of i, self-loops included), it
// computes for every graph b and target row i
//
//   logit_ij = sum_f att[f] * LeakyReLU_0.2(xl[j, f] + xr[i, f])   (adj only)
//   alpha_ij = exp(logit_ij - max_j logit) / max(sum_j exp(...), 1e-30)
//   out[i,f] = sum_j alpha_ij * xl[j, f]   (/ max(deg_i, 1) if mean_aggr)
//              + bias[f],   and exactly 0 for a row with no neighbour,
//
// with the TPU kernel's semantics: the max starts from NEG_INF = -1e30, the
// 1e-30 floor on the denominator, and the mean taken after the softmax.
//
// What bounds it on this card.  One graph of the flagship (N = 24, F = 22)
// is 2 x 2,112 bytes of features and 576 of adjacency, and ~77 thousand
// f32 operations: at any batch the main path uses (B = 1..100) the whole
// call is a few hundred KB at most, so neither memory (0.0002 ms at B=100)
// nor arithmetic bounds it.  It is bound by latency: one CTA per graph
// runs a chain of a device-memory round trip, the logits, a softmax and
// the aggregation, and every CTA of a call fits on the card at once, so
// the call takes one CTA's chain, flat in B.  Stage clocks (a
// -DGAT_STAGE_CLOCKS build) split that chain at N = 24 into the staging
// round trip (~30%), the logits (~28%), the softmax (~22%) and the
// aggregation (~21%).  The design shortens each link:
//
// - each graph's xl[b], xr[b] and adj[b] (contiguous) are staged with TMA
//   1-D bulk copies (cp.async.bulk into shared memory, completed on one
//   mbarrier) issued by one thread, while the other threads load att and
//   bias; a block whose global address is not 16-byte aligned or whose
//   size is not a multiple of 16 is loaded by the whole CTA with plain
//   loads instead (gat_common.cuh, stage());
// - the logits of all N^2 pairs, every thread of the CTA over the
//   flattened pairs (576 at N = 24: 18 full warps, where a warp per row
//   leaves 8 of 32 lanes idle), each as four independent partial sums over
//   f read as float2 (gat_common.cuh, rows_alpha());
// - the softmax one warp per target row (N warps, at most 32; rows loop
//   only beyond that): degree and has-neighbour from __popc of the row's
//   adjacency ballot, the row max in one integer reduction
//   (__reduce_max_sync on order-preserving bits), then one expf per edge
//   outside any branch and a shuffle sum;
// - the aggregation, every thread over the flattened outputs (i, f), with
//   alpha_i read as float4 into four independent partial sums, so no
//   output waits on an N-long chain.
//
// Graphs of more than 32 nodes (interroute's 128, rung 5's 256) are cut
// into tiles of 32 target rows, one CTA each (gat_common.cuh,
// tile_rows()): each CTA stages the graph's whole xl, its rows' xr and
// adjacency rows, and computes its rows' weights and outputs, so its
// shared memory holds [32, N] weights instead of [N, N] (81 KB in f32 at N
// = 256).  Softmax rows are independent and every row is computed by the
// same code whichever tile it is in, so the cut changes no bit.  A graph
// of up to 32 nodes stays one CTA, as before.
//
// The adjacency, the features and the weights are read from shared memory
// only.  Reading xl rows directly (float2, conflict-free at F = 22) beat a
// transposed copy, whose extra pass cost more than it saved.
//
// The bf16 form (template parameter kBf16) computes what the bf16 branch
// of gsc_tpu/ops/gat.py::attention_dense computes, with every rounding in
// the same place: e = bf16(xl_j + xr_i), its LeakyReLU in bf16 with the
// slope 0.2 rounded to bf16, logits sum_f e * bf16(att) in f32 (each
// product exact), the f32 softmax, alpha rounded to bf16, out = sum_j
// alpha_ij xl_j in f32, / max(deg, 1), + the f32 bias, rounded once to
// bf16 at the store.  xl[b] and xr[b] (half the f32 bytes) are staged as
// bf16 and widened to f32 in shared memory, so the rest of the chain is
// the f32 form's code.  The same latency bound holds.
//
// No tensor cores: the f32 form is f32, an f32 mma does not exist, and
// TF32 stays off (the port keeps the JAX reference's "highest" f32 matmul
// precision).  The bf16 form keeps the f32 form's scalar chain; an
// mma.sync m16n8k16 aggregation is later work.
//
// The host function returns the CUDA error of the launch (0 = success);
// the Python wrapper raises on anything else.

#include <type_traits>

#include "gat_common.cuh"

namespace {

using namespace gat;

// Byte offsets of the dynamic shared memory, each 16-byte aligned;
// computed on the host and passed by value.
struct Layout {
  unsigned xl, xr, adj, att, bias, alpha, deg, hxl, hxr, bar, total;
};

// One CTA's rows r = tile_rows(n): the whole graph's xl, the rows' xr,
// adjacency, weights and degrees.  bf16: the staging areas hxl, hxr of
// the bf16 features (none in f32, whose layout is the same as without
// them).
Layout layout(int n, int f, bool bf16) {
  const size_t fl = sizeof(float);
  const int r = tile_rows(n);
  const int np = round4(n);
  Layout l;
  size_t o = 0;
  l.xl = o;                                              // [np][f]
  o += align16(static_cast<size_t>(np) * f * fl);
  l.xr = o;                                              // [r][f]
  o += align16(static_cast<size_t>(r) * f * fl);
  l.adj = o;                                             // [r][n] bytes
  o += align16(static_cast<size_t>(r) * n);
  l.att = o;                                             // [f]
  o += align16(f * fl);
  l.bias = o;                                            // [f]
  o += align16(f * fl);
  l.alpha = o;                                           // [r][np]
  o += static_cast<size_t>(r) * np * fl;
  l.deg = o;                                             // [r] ints
  o += align16(r * sizeof(int));
  l.hxl = o;                                             // [n][f] bf16
  o += bf16 ? align16(static_cast<size_t>(n) * f * 2) : 0;
  l.hxr = o;                                             // [r][f] bf16
  o += bf16 ? align16(static_cast<size_t>(r) * f * 2) : 0;
  l.bar = o;
  l.total = o + 16;
  return l;
}

template <bool kBf16>
using Feat = typename std::conditional<kBf16, __nv_bfloat16, float>::type;

// kTiled: the graph is cut into tiles of kTileRows target rows, one CTA
// each; else one CTA holds the whole graph (N <= kTileRows), whose code is
// the untiled kernel's, with the tile's offsets 0 at compile time.
template <bool kBf16, bool kTiled>
__global__ void __launch_bounds__(kMaxWarps * 32)
gat_attention_kernel(const Feat<kBf16>* __restrict__ xl,
                     const Feat<kBf16>* __restrict__ xr,
                     const float* __restrict__ att,
                     const float* __restrict__ bias,
                     const unsigned char* __restrict__ adj,
                     Feat<kBf16>* __restrict__ out, const Layout L, int n,
                     int f, int mean_aggr, float inv_n, float inv_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = round4(n);
  float* s_xl = reinterpret_cast<float*>(smem + L.xl);
  float* s_xr = reinterpret_cast<float*>(smem + L.xr);
  unsigned char* s_adj = smem + L.adj;
  float* s_att = reinterpret_cast<float*>(smem + L.att);
  float* s_bias = reinterpret_cast<float*>(smem + L.bias);
  float* s_alpha = reinterpret_cast<float*>(smem + L.alpha);
  int* s_deg = reinterpret_cast<int*>(smem + L.deg);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  GAT_CLOCK(0);

  __nv_bfloat16* s_hxl = reinterpret_cast<__nv_bfloat16*>(smem + L.hxl);
  __nv_bfloat16* s_hxr = reinterpret_cast<__nv_bfloat16*>(smem + L.hxr);

  // graph b, target rows i0 .. i0 + r - 1 (the tile count is computed
  // here, not passed: one more kernel parameter made the one-CTA path
  // measurably slower on an H100)
  const int tiles = kTiled ? (n + kTileRows - 1) / kTileRows : 1;
  const int b = kTiled ? static_cast<int>(blockIdx.x) / tiles
                       : static_cast<int>(blockIdx.x);
  const int i0 =
      kTiled ? (static_cast<int>(blockIdx.x) - b * tiles) * kTileRows : 0;
  const int r = kTiled ? min(kTileRows, n - i0) : n;
  const int nf = n * f, rf = r * f;
  const size_t fs = sizeof(Feat<kBf16>);
  // bf16 features land in the staging areas, f32 ones where they are used
  void* d_xl = kBf16 ? static_cast<void*>(s_hxl) : static_cast<void*>(s_xl);
  void* d_xr = kBf16 ? static_cast<void*>(s_hxr) : static_cast<void*>(s_xr);
  const Block blocks[3] = {
      {d_xl, xl + static_cast<size_t>(b) * nf,
       static_cast<uint32_t>(nf * fs)},
      {d_xr, xr + static_cast<size_t>(b) * nf + static_cast<size_t>(i0) * f,
       static_cast<uint32_t>(rf * fs)},
      {s_adj, adj + static_cast<size_t>(b) * n * n +
                  static_cast<size_t>(i0) * n,
       static_cast<uint32_t>(r * n)}};
  const uint32_t tx = stage(blocks, bar);
  // while the copies fly: att (bf16(att) in the bf16 form), bias, and xl's
  // rows n..np-1 as zeros, which the aggregation's float4 reads of alpha's
  // pad columns meet
#pragma unroll 1
  for (int k = threadIdx.x; k < f; k += blockDim.x) {
    s_att[k] = kBf16 ? round_bf16(att[k]) : att[k];
    s_bias[k] = bias[k];
  }
#pragma unroll 1
  for (int t = threadIdx.x; t < (np - n) * f; t += blockDim.x)
    s_xl[nf + t] = 0.f;
  __syncthreads();
  if (tx) barrier_wait(bar);
  if constexpr (kBf16) {
    widen_bf16(s_xl, s_hxl, nf);
    widen_bf16(s_xr, s_hxr, rf);
    __syncthreads();
  }
  GAT_CLOCK(1);

  rows_alpha<kBf16>(s_xl, s_xr, s_att, s_adj, n, r, np, f, inv_n, s_alpha,
                    s_deg);
  GAT_CLOCK(2);

  // the aggregation, all threads over the flattened outputs t = i f + k:
  // sum_j alpha_ij xl_jk with alpha_i read as float4 (four independent
  // partial sums; in bf16 each alpha rounded to bf16 first), / max(deg_i,
  // 1) if mean, + bias; 0 without a neighbour; rounded to bf16 at the
  // store in the bf16 form
  Feat<kBf16>* out_b =
      out + static_cast<size_t>(b) * nf + static_cast<size_t>(i0) * f;
  const auto w = [](float a) { return kBf16 ? round_bf16(a) : a; };
#pragma unroll 1
  for (int t = threadIdx.x; t < rf; t += blockDim.x) {
    const int i = div_floor(t, inv_f), k = t - i * f;
    const int deg = s_deg[i];
    float o = 0.f;
    if (deg > 0) {
      const float4* a4 = reinterpret_cast<const float4*>(s_alpha + i * np);
      const float* x = s_xl + k;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 1
      for (int q = 0; q < np / 4; ++q, x += 4 * f) {
        const float4 a = a4[q];
        a0 = fmaf(w(a.x), x[0], a0);
        a1 = fmaf(w(a.y), x[f], a1);
        a2 = fmaf(w(a.z), x[2 * f], a2);
        a3 = fmaf(w(a.w), x[3 * f], a3);
      }
      const float acc = (a0 + a1) + (a2 + a3);
      o = (mean_aggr ? acc / static_cast<float>(deg) : acc) + s_bias[k];
    }
    if constexpr (kBf16)
      out_b[t] = __float2bfloat16_rn(o);
    else
      out_b[t] = o;
  }
  GAT_CLOCK(3);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes (bf16: the bf16 form).
long long gat_attention_smem_bytes(int n, int f, int bf16) {
  return static_cast<long long>(layout(n, f, bf16 != 0).total);
}

}  // extern "C"

namespace {

template <bool kBf16>
int launch(const Feat<kBf16>* xl, const Feat<kBf16>* xr, const float* att,
           const float* bias, const void* adj, Feat<kBf16>* out, int batch,
           int n, int f, int mean_aggr, void* stream) {
  const Layout L = layout(n, f, kBf16);
  const int tiles = row_tiles(n);
  auto* const kernel = tiles == 1 ? &gat_attention_kernel<kBf16, false>
                                  : &gat_attention_kernel<kBf16, true>;
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (batch == 0) return 0;
  kernel<<<batch * tiles, warps_for(n) * 32, L.total,
           static_cast<cudaStream_t>(stream)>>>(
      xl, xr, att, bias, static_cast<const unsigned char*>(adj), out, L, n, f,
      mean_aggr, 1.f / static_cast<float>(n), 1.f / static_cast<float>(f));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; adj is one byte per entry (torch.bool); att and bias
// f32.  Returns the cudaError_t of the launch, 0 on success.
int gat_attention_f32(const float* xl, const float* xr, const float* att,
                      const float* bias, const void* adj, float* out,
                      int batch, int n, int f, int mean_aggr, void* stream) {
  return launch<false>(xl, xr, att, bias, adj, out, batch, n, f, mean_aggr,
                       stream);
}

// The bf16 form: xl, xr and out bf16 (torch.bfloat16), att and bias f32.
int gat_attention_bf16(const void* xl, const void* xr, const float* att,
                       const float* bias, const void* adj, void* out,
                       int batch, int n, int f, int mean_aggr, void* stream) {
  return launch<true>(static_cast<const __nv_bfloat16*>(xl),
                      static_cast<const __nv_bfloat16*>(xr), att, bias, adj,
                      static_cast<__nv_bfloat16*>(out), batch, n, f,
                      mean_aggr, stream);
}

const char* gat_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef GAT_STAGE_CLOCKS
// The last launch's stage clocks of block 0 (kStageClocks values).
int gat_attention_stage_clocks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_stage_clocks, sizeof(long long) * kStageClocks));
}
#endif

}  // extern "C"
