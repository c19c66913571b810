// Gradient of the fused GATv2 attention stage, f32 and bf16, for Hopper
// (sm_90a).
//
// The gradient of gat_attention.cu's function, which the JAX package
// computes as the dense VJP of gsc_tpu/ops/pallas_gat.py::_gatv2_pallas_bwd
// (jax.vjp of attention_dense, with [B, N, N, F] intermediates).  Given
// grad_out g [B, N, F] and the forward's inputs, per graph and target row
// i, with alpha the forward's attention weights, d_i = max(deg_i, 1) under
// mean aggregation (1 under sum) and e_ijf = xl_jf + xr_if:
//
//   g_i := 0 on a row without a neighbour;  d_bias = sum_{b,i} g_i
//   dalpha_ij = (g_i . xl_j) / d_i
//   dl_ij = alpha_ij (dalpha_ij - sum_k alpha_ik dalpha_ik)   (0 off adj)
//   d_att_f = sum_{b,i,j} dl_ij LeakyReLU(e_ijf)
//   d_xr_if = att_f sum_j dl_ij LeakyReLU'(e_ijf)
//   d_xl_jf = sum_i alpha_ij g_if / d_i + att_f sum_i dl_ij LeakyReLU'(e_ijf)
//
// with LeakyReLU'(0) = 1, as where(e >= 0, ...) takes it in both
// frameworks.
//
// What bounds it on this card: as the forward, latency.  A flagship graph
// (N = 24, F = 22) is ~9.5 KB in and out and ~0.2 M f32 operations; the
// dense VJP it replaces issues ~80 small launches per call and moves
// [B, N, N, F] tensors (5 MB each at B = 100) through device memory.  The
// design does the whole gradient in ONE launch with nothing of size
// [N, N, F] outside shared memory and registers:
//
// - one CTA per graph of up to 32 nodes (gat_attention_backward_kernel,
//   kept as it was: one template for both paths measured slower at the
//   flagship's N = 24); a larger graph is cut into tiles of 32 target
//   rows, one CTA each (gat_common.cuh, tile_rows()), which together form
//   one thread block cluster of up to 8 CTAs, so N <= 256
//   (gat_attention_backward_cluster_kernel); xl[b] and xr[b] whole, and
//   the tile's rows of g[b] and adj[b],
//   staged with TMA 1-D bulk copies on one mbarrier (plain loads for a
//   block that is not 16-byte aligned or sized), as in the forward;
// - the tile's alpha recomputed by the forward's own code (gat_common.cuh,
//   rows_alpha()), so it equals the forward's bit for bit; alpha, dalpha
//   and dl of the tile's rows live in shared memory as [32, N] (at N = 24
//   the whole graph's [N, N], as before);
// - dalpha over the flattened pairs, dl one warp per row, taken relative
//   to the row's largest weight (dl_ij = alpha_ij (delta_ij - sum_k
//   alpha_ik delta_ik), delta_ij = dalpha_ij - dalpha_ip at p = argmax_j
//   alpha_ij: trained weights give logits of several hundred, a softmax
//   saturated to f32 precision, and the textbook form's dalpha_ip -
//   sum_k alpha_ik dalpha_ik then cancels to its rounding, off by more
//   than the gradient itself), then d_xr (threads over (i, f) of the
//   tile's rows, sums over j) and d_xl (threads over (j, f) of the tile's
//   columns, sums over every row i) in one pass, e_ijf recomputed from
//   shared memory.  d_xl's sums read the rows of the cluster's other
//   tiles (alpha, dl, g_i / d_i) from those CTAs' shared memory, between
//   two cluster barriers, in row order as one CTA would;
// - d_att and d_bias are sums across graphs: each CTA adds its rows'
//   terms in double in a fixed order (16 threads per feature over strided
//   rows, then their 16 sums in order), writes them to a scratch buffer,
//   and the last CTA to finish (an integer atomic counter, reset by that
//   CTA for the next launch) adds them in CTA order (graph by graph, tile
//   by tile) the same way.  d_xl
//   and d_xr wait in shared memory and are stored after the CTA has
//   counted itself in, so the memory fence waits for the partials alone.
//   No float atomics: two launches on the same inputs give the same bits.
//
// The bf16 form (gat_attention_backward_bf16, template parameter kBf16)
// is the gradient of gat_attention.cu's bf16 form at that form's own
// rounding points, each rounding's derivative taken as 1: grad_out, xl
// and xr arrive in bf16 and are widened to f32 in shared memory; alpha is
// recomputed in f32 by the forward's own code (the logits of the bf16
// activations and bf16(att)); dl uses the unrounded alpha and is taken
// relative to the row's largest weight as in the f32 form; d_att sums dl
// times the bf16 activations; de = dl bf16(att) LeakyReLU', the slope
// being 0.2 rounded to bf16; d_xl's aggregation term sums bf16(alpha)
// g_i / d_i, the weights the forward summed with.  Everything is f32
// inside, d_xl and d_xr are rounded once to bf16 at the store, d_att and
// d_bias leave in f32 from their double sums.  Its plain version is
// gsc_tpu_torch/ops/gat_attention.py::attention_backward_wide (f32).
//
// No tensor cores, as the forward: f32 arithmetic, TF32 off.
//
// The host function returns the CUDA error of the launch (0 = success);
// the Python wrapper raises on anything else.

#include <cooperative_groups.h>

#include <type_traits>

#include "gat_common.cuh"

namespace {

using namespace gat;
namespace cg = cooperative_groups;

// The largest cluster the launch asks for (the portable cluster size):
// graphs of up to kMaxCluster * kTileRows = 256 nodes.
constexpr int kMaxCluster = 8;

// Threads that add the per-graph d_att and d_bias partials in the last
// CTA: each of the 2 F sums goes to kSumParts threads, each over a strided
// set of graphs, then one thread adds those kSumParts sums in order.
constexpr int kSumParts = 16;

// Byte offsets of the dynamic shared memory, each 16-byte aligned;
// computed on the host and passed by value.
struct Layout {
  unsigned xl, xr, g, adj, att, dout, apart, dxr, alpha, dl, deg, sums, hxl,
      hxr, hg, bar, total;
};

// One CTA's rows r = tile_rows(n): the whole graph's xl and xr (its
// rows' logits read every xl_j, and d_xl of its columns every xr_i), and
// its rows' g, adjacency, weights, dl and per-row terms.  bf16: the
// staging areas hxl, hxr, hg of the bf16 inputs (none in f32, whose
// layout is the same as without them).
Layout layout(int n, int f, bool bf16) {
  const size_t fl = sizeof(float);
  const int r = tile_rows(n);
  const int np = round4(n);
  const size_t feat = align16(static_cast<size_t>(n) * f * fl);
  const size_t rows = align16(static_cast<size_t>(r) * f * fl);
  const size_t pair = static_cast<size_t>(r) * np * fl;
  Layout l;
  size_t o = 0;
  l.xl = o;      // [n][f]
  o += feat;
  l.xr = o;      // [n][f]
  o += feat;
  l.g = o;       // [r][f]; d_xl of the CTA's columns once g is used
  o += rows;
  l.adj = o;     // [r][n] bytes
  o += align16(static_cast<size_t>(r) * n);
  l.att = o;     // [f]
  o += align16(f * fl);
  l.dout = o;    // [r][f]: g_i / d_i
  o += rows;
  l.apart = o;   // [r][f]: d_att's terms summed over j
  o += rows;
  l.dxr = o;     // [r][f]: d_xr, until it is stored
  o += rows;
  l.alpha = o;   // [r][np]
  o += pair;
  l.dl = o;      // [r][np]
  o += pair;
  l.deg = o;     // [r] ints
  o += align16(r * sizeof(int));
  l.sums = o;    // [2 f][kSumParts] doubles: partial sums in a fixed order
  o += align16(2 * f * kSumParts * sizeof(double));
  l.hxl = o;     // [n][f] bf16
  o += bf16 ? align16(static_cast<size_t>(n) * f * 2) : 0;
  l.hxr = o;     // [n][f] bf16
  o += bf16 ? align16(static_cast<size_t>(n) * f * 2) : 0;
  l.hg = o;      // [r][f] bf16
  o += bf16 ? align16(static_cast<size_t>(r) * f * 2) : 0;
  l.bar = o;
  l.total = o + 16;
  return l;
}

// sum_f u_f w_f over rows of f floats, in four independent partial sums
// added as (c0 + c1) + (c2 + c3); float2 reads for even f.
__device__ __forceinline__ float dot(const float* u, const float* w, int f) {
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  if ((f & 1) == 0) {
    const float2* u2 = reinterpret_cast<const float2*>(u);
    const float2* w2 = reinterpret_cast<const float2*>(w);
    const int h = f >> 1;
    int q = 0;
#pragma unroll 1
    for (; q + 1 < h; q += 2) {
      const float2 a = u2[q], b = u2[q + 1], x = w2[q], y = w2[q + 1];
      c0 = fmaf(a.x, x.x, c0);
      c1 = fmaf(a.y, x.y, c1);
      c2 = fmaf(b.x, y.x, c2);
      c3 = fmaf(b.y, y.y, c3);
    }
    if (q < h) {
      const float2 a = u2[q], x = w2[q];
      c0 = fmaf(a.x, x.x, c0);
      c1 = fmaf(a.y, x.y, c1);
    }
  } else {
    int k = 0;
#pragma unroll 1
    for (; k + 3 < f; k += 4) {
      c0 = fmaf(u[k], w[k], c0);
      c1 = fmaf(u[k + 1], w[k + 1], c1);
      c2 = fmaf(u[k + 2], w[k + 2], c2);
      c3 = fmaf(u[k + 3], w[k + 3], c3);
    }
#pragma unroll 1
    for (; k < f; ++k) c0 = fmaf(u[k], w[k], c0);
  }
  return (c0 + c1) + (c2 + c3);
}

template <bool kBf16>
using Feat = typename std::conditional<kBf16, __nv_bfloat16, float>::type;

// d_xl's sums over rc target rows for column j and feature k, added to
// s = {aggregation pair, de pair}: alpha [rc][np] and dl [rc][np] of
// those rows, do_k and xr_k their g_i / d_i and xr at feature k (stride
// f), in row order, two rows at a time.  In bf16 the aggregation term
// sums bf16(alpha).
template <bool kBf16>
__device__ __forceinline__ void column_sums(
    const float* al, const float* dl, const float* do_k, const float* xr_k,
    int rc, int np, int f, int j, float xl_jk, float (&s)[4]) {
  const auto w = [](float a) { return kBf16 ? round_bf16(a) : a; };
  int i = 0;
#pragma unroll 1
  for (; i + 1 < rc; i += 2) {
    const float e0 = xl_jk + xr_k[i * f], e1 = xl_jk + xr_k[(i + 1) * f];
    const float l0 = dl[i * np + j], l1 = dl[(i + 1) * np + j];
    s[0] = fmaf(w(al[i * np + j]), do_k[i * f], s[0]);
    s[1] = fmaf(w(al[(i + 1) * np + j]), do_k[(i + 1) * f], s[1]);
    s[2] += slope_times<kBf16>(e0, l0);
    s[3] += slope_times<kBf16>(e1, l1);
  }
  if (i < rc) {
    const float e0 = xl_jk + xr_k[i * f];
    const float l0 = dl[i * np + j];
    s[0] = fmaf(w(al[i * np + j]), do_k[i * f], s[0]);
    s[2] += slope_times<kBf16>(e0, l0);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kMaxWarps * 32)
gat_attention_backward_kernel(const Feat<kBf16>* __restrict__ grad,
                              const Feat<kBf16>* __restrict__ xl,
                              const Feat<kBf16>* __restrict__ xr,
                              const float* __restrict__ att,
                              const unsigned char* __restrict__ adj,
                              Feat<kBf16>* __restrict__ d_xl,
                              Feat<kBf16>* __restrict__ d_xr,
                              float* __restrict__ d_att,
                              float* __restrict__ d_bias,
                              double* __restrict__ partials,
                              unsigned int* __restrict__ counter,
                              const Layout L, int n, int f, int mean_aggr,
                              float inv_n, float inv_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = round4(n);
  float* s_xl = reinterpret_cast<float*>(smem + L.xl);
  float* s_xr = reinterpret_cast<float*>(smem + L.xr);
  float* s_g = reinterpret_cast<float*>(smem + L.g);
  unsigned char* s_adj = smem + L.adj;
  float* s_att = reinterpret_cast<float*>(smem + L.att);
  float* s_do = reinterpret_cast<float*>(smem + L.dout);
  float* s_apart = reinterpret_cast<float*>(smem + L.apart);
  float* s_alpha = reinterpret_cast<float*>(smem + L.alpha);
  float* s_dl = reinterpret_cast<float*>(smem + L.dl);
  int* s_deg = reinterpret_cast<int*>(smem + L.deg);
  double* s_sums = reinterpret_cast<double*>(smem + L.sums);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  __shared__ bool s_last;
  GAT_CLOCK(0);

  __nv_bfloat16* s_hxl = reinterpret_cast<__nv_bfloat16*>(smem + L.hxl);
  __nv_bfloat16* s_hxr = reinterpret_cast<__nv_bfloat16*>(smem + L.hxr);
  __nv_bfloat16* s_hg = reinterpret_cast<__nv_bfloat16*>(smem + L.hg);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nf = n * f;
  const uint32_t feat_bytes =
      static_cast<uint32_t>(nf * sizeof(Feat<kBf16>));
  // bf16 inputs land in the staging areas, f32 ones where they are used
  const auto dst = [](void* h, float* w) {
    return kBf16 ? h : static_cast<void*>(w);
  };
  const Block blocks[4] = {
      {dst(s_hxl, s_xl), xl + static_cast<size_t>(b) * nf, feat_bytes},
      {dst(s_hxr, s_xr), xr + static_cast<size_t>(b) * nf, feat_bytes},
      {dst(s_hg, s_g), grad + static_cast<size_t>(b) * nf, feat_bytes},
      {s_adj, adj + static_cast<size_t>(b) * n * n,
       static_cast<uint32_t>(n * n)}};
  const uint32_t tx = stage(blocks, bar);
#pragma unroll 1
  for (int k = tid; k < f; k += blockDim.x)
    s_att[k] = kBf16 ? round_bf16(att[k]) : att[k];
  __syncthreads();
  if (tx) barrier_wait(bar);
  if constexpr (kBf16) {
    widen_bf16(s_xl, s_hxl, nf);
    widen_bf16(s_xr, s_hxr, nf);
    widen_bf16(s_g, s_hg, nf);
    __syncthreads();
  }
  GAT_CLOCK(1);

  // 1. alpha and the degrees, as the forward computes them
  rows_alpha<kBf16>(s_xl, s_xr, s_att, s_adj, n, n, np, f, inv_n, s_alpha,
                    s_deg);
  GAT_CLOCK(2);

  // 2. the output gradient g_i / d_i (0 on a row without a neighbour), and
  //    this graph's d_bias partial: kSumParts threads per feature, each
  //    over rows p, p + kSumParts, ..., then their sums in order, in double
  double* part = partials + static_cast<size_t>(b) * 2 * f;
#pragma unroll 1
  for (int t = tid; t < nf; t += blockDim.x) {
    const int deg = s_deg[div_floor(t, inv_f)];
    const float gt = deg > 0 ? s_g[t] : 0.f;
    s_do[t] = mean_aggr ? gt / static_cast<float>(max(deg, 1)) : gt;
  }
#pragma unroll 1
  for (int t = tid; t < f * kSumParts; t += blockDim.x) {
    const int k = t / kSumParts, p = t - k * kSumParts;
    double acc = 0.0;
#pragma unroll 1
    for (int i = p; i < n; i += kSumParts)
      if (s_deg[i] > 0) acc += s_g[i * f + k];
    s_sums[t] = acc;
  }
  __syncthreads();
  GAT_CLOCK(3);

  // 3. dalpha_ij = (g_i / d_i) . xl_j, all threads over the pairs; the
  //    d_bias partial in order
#pragma unroll 1
  for (int t = tid; t < n * n; t += blockDim.x) {
    const int i = div_floor(t, inv_n), j = t - i * n;
    s_dl[i * np + j] = dot(s_do + i * f, s_xl + j * f, f);
  }
#pragma unroll 1
  for (int k = tid; k < f; k += blockDim.x) {
    double acc = 0.0;
#pragma unroll 1
    for (int p = 0; p < kSumParts; ++p) acc += s_sums[k * kSumParts + p];
    part[f + k] = acc;
  }
  __syncthreads();

  // 4. dl_ij = alpha_ij (delta_ij - sum_k alpha_ik delta_ik) with delta_ij
  //    = dalpha_ij - dalpha_ip at the row's largest weight p (the first
  //    lane holding it): the same value as alpha_ij (dalpha_ij - sum_k
  //    alpha_ik dalpha_ik), but where the softmax saturates (alpha_ip = 1
  //    to f32 precision) that difference of two nearly equal numbers would
  //    swamp dl with rounding, and here the pivot's own term is exactly 0.
  //    One warp per row.
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll 1
  for (int i = warp; i < n; i += blockDim.x >> 5) {
    const float* alpha_i = s_alpha + i * np;
    float* dl_i = s_dl + i * np;
    // the largest weight of the row and where it is: each lane's first,
    // then the first lane holding the row's
    float a_max = -1.f;
    int j_max = 0;
#pragma unroll 1
    for (int j = lane; j < n; j += 32)
      if (alpha_i[j] > a_max) {
        a_max = alpha_i[j];
        j_max = j;
      }
    const float row_max = warp_max(a_max);
    const int src = __ffs(__ballot_sync(kFull, a_max == row_max)) - 1;
    const float pivot = dl_i[__shfl_sync(kFull, j_max, src)];
    float t = 0.f;
#pragma unroll 1
    for (int j = lane; j < n; j += 32)
      t = fmaf(alpha_i[j], dl_i[j] - pivot, t);
    t = warp_sum(t);
    __syncwarp();
#pragma unroll 1
    for (int j = lane; j < n; j += 32)
      dl_i[j] = alpha_i[j] * ((dl_i[j] - pivot) - t);
  }
  __syncthreads();
  GAT_CLOCK(4);

  // 5. d_xr and the d_att terms by (i, f), summed over j; d_xl by (j, f),
  //    summed over i; two independent partial sums each.  d_xr and d_xl
  //    wait in shared memory (d_xl where g was) until the partials are out.
  //    In bf16, act() and slope_times() are the bf16 activation and slope,
  //    and d_xl's aggregation term sums bf16(alpha)
  float* s_dxl = s_g;
  float* s_dxr = reinterpret_cast<float*>(smem + L.dxr);
  const auto w = [](float a) { return kBf16 ? round_bf16(a) : a; };
#pragma unroll 1
  for (int t = tid; t < 2 * nf; t += blockDim.x) {
    if (t < nf) {
      const int i = div_floor(t, inv_f), k = t - i * f;
      const float xr_ik = s_xr[t];
      const float* dl_i = s_dl + i * np;
      const float* x = s_xl + k;
      float r0 = 0.f, r1 = 0.f, a0 = 0.f, a1 = 0.f;
      int j = 0;
#pragma unroll 1
      for (; j + 1 < n; j += 2) {
        const float e0 = x[j * f] + xr_ik, e1 = x[(j + 1) * f] + xr_ik;
        r0 += slope_times<kBf16>(e0, dl_i[j]);
        r1 += slope_times<kBf16>(e1, dl_i[j + 1]);
        a0 = fmaf(dl_i[j], act<kBf16>(e0), a0);
        a1 = fmaf(dl_i[j + 1], act<kBf16>(e1), a1);
      }
      if (j < n) {
        const float e0 = x[j * f] + xr_ik;
        r0 += slope_times<kBf16>(e0, dl_i[j]);
        a0 = fmaf(dl_i[j], act<kBf16>(e0), a0);
      }
      s_dxr[t] = s_att[k] * (r0 + r1);
      s_apart[t] = a0 + a1;
    } else {
      const int v = t - nf;
      const int j = div_floor(v, inv_f), k = v - j * f;
      const float xl_jk = s_xl[v];
      const float* xr_k = s_xr + k;
      const float* do_k = s_do + k;
      float s0 = 0.f, s1 = 0.f, r0 = 0.f, r1 = 0.f;
      int i = 0;
#pragma unroll 1
      for (; i + 1 < n; i += 2) {
        const float e0 = xl_jk + xr_k[i * f], e1 = xl_jk + xr_k[(i + 1) * f];
        const float l0 = s_dl[i * np + j], l1 = s_dl[(i + 1) * np + j];
        s0 = fmaf(w(s_alpha[i * np + j]), do_k[i * f], s0);
        s1 = fmaf(w(s_alpha[(i + 1) * np + j]), do_k[(i + 1) * f], s1);
        r0 += slope_times<kBf16>(e0, l0);
        r1 += slope_times<kBf16>(e1, l1);
      }
      if (i < n) {
        const float e0 = xl_jk + xr_k[i * f];
        const float l0 = s_dl[i * np + j];
        s0 = fmaf(w(s_alpha[i * np + j]), do_k[i * f], s0);
        r0 += slope_times<kBf16>(e0, l0);
      }
      s_dxl[v] = (s0 + s1) + s_att[k] * (r0 + r1);
    }
  }
  __syncthreads();
  GAT_CLOCK(5);

  // 6. this graph's d_att partial, as d_bias's; out to the scratch, then
  //    counted in
#pragma unroll 1
  for (int t = tid; t < f * kSumParts; t += blockDim.x) {
    const int k = t / kSumParts, p = t - k * kSumParts;
    double acc = 0.0;
#pragma unroll 1
    for (int i = p; i < n; i += kSumParts) acc += s_apart[i * f + k];
    s_sums[t] = acc;
  }
  __syncthreads();
#pragma unroll 1
  for (int k = tid; k < f; k += blockDim.x) {
    double acc = 0.0;
#pragma unroll 1
    for (int p = 0; p < kSumParts; ++p) acc += s_sums[k * kSumParts + p];
    part[k] = acc;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counter, 1u) == gridDim.x - 1;

  // 7. d_xl and d_xr out (coalesced; rounded once to bf16 in the bf16
  //    form); no other CTA reads them
  Feat<kBf16>* d_xl_b = d_xl + static_cast<size_t>(b) * nf;
  Feat<kBf16>* d_xr_b = d_xr + static_cast<size_t>(b) * nf;
#pragma unroll 1
  for (int t = tid; t < nf; t += blockDim.x) {
    if constexpr (kBf16) {
      d_xl_b[t] = __float2bfloat16_rn(s_dxl[t]);
      d_xr_b[t] = __float2bfloat16_rn(s_dxr[t]);
    } else {
      d_xl_b[t] = s_dxl[t];
      d_xr_b[t] = s_dxr[t];
    }
  }
  __syncthreads();
  GAT_CLOCK(6);

  // 8. the last CTA to finish adds the partials in graph order: kSumParts
  //    threads per sum, each over graphs c = p, p + kSumParts, ..., then
  //    the kSumParts sums in order of p
  if (!s_last) return;
  __threadfence();
#pragma unroll 1
  for (int t = tid; t < 2 * f * kSumParts; t += blockDim.x) {
    const int k = t / kSumParts, p = t - k * kSumParts;
    double acc = 0.0;
#pragma unroll 1
    for (unsigned int c = p; c < gridDim.x; c += kSumParts)
      acc += __ldcg(partials + static_cast<size_t>(c) * 2 * f + k);
    s_sums[t] = acc;
  }
  __syncthreads();
#pragma unroll 1
  for (int k = tid; k < 2 * f; k += blockDim.x) {
    double acc = 0.0;
#pragma unroll 1
    for (int p = 0; p < kSumParts; ++p) acc += s_sums[k * kSumParts + p];
    if (k < f)
      d_att[k] = static_cast<float>(acc);
    else
      d_bias[k - f] = static_cast<float>(acc);
  }
  if (tid == 0) *counter = 0u;
}

// A graph of more than kTileRows nodes: its tiles of kTileRows target
// rows run as one thread block cluster (rank = tile), and d_xl's sums
// over every target row read the other tiles' weights, dl and g_i / d_i
// from their shared memory.  The steps of the one-CTA kernel above, on
// the tile's rows.
template <bool kBf16>
__global__ void __launch_bounds__(kMaxWarps * 32)
gat_attention_backward_cluster_kernel(const Feat<kBf16>* __restrict__ grad,
                              const Feat<kBf16>* __restrict__ xl,
                              const Feat<kBf16>* __restrict__ xr,
                              const float* __restrict__ att,
                              const unsigned char* __restrict__ adj,
                              Feat<kBf16>* __restrict__ d_xl,
                              Feat<kBf16>* __restrict__ d_xr,
                              float* __restrict__ d_att,
                              float* __restrict__ d_bias,
                              double* __restrict__ partials,
                              unsigned int* __restrict__ counter,
                              const Layout L, int n, int f, int mean_aggr,
                              float inv_n, float inv_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = round4(n);
  float* s_xl = reinterpret_cast<float*>(smem + L.xl);
  float* s_xr = reinterpret_cast<float*>(smem + L.xr);
  float* s_g = reinterpret_cast<float*>(smem + L.g);
  unsigned char* s_adj = smem + L.adj;
  float* s_att = reinterpret_cast<float*>(smem + L.att);
  float* s_do = reinterpret_cast<float*>(smem + L.dout);
  float* s_apart = reinterpret_cast<float*>(smem + L.apart);
  float* s_alpha = reinterpret_cast<float*>(smem + L.alpha);
  float* s_dl = reinterpret_cast<float*>(smem + L.dl);
  int* s_deg = reinterpret_cast<int*>(smem + L.deg);
  double* s_sums = reinterpret_cast<double*>(smem + L.sums);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  __shared__ bool s_last;
  GAT_CLOCK(0);

  __nv_bfloat16* s_hxl = reinterpret_cast<__nv_bfloat16*>(smem + L.hxl);
  __nv_bfloat16* s_hxr = reinterpret_cast<__nv_bfloat16*>(smem + L.hxr);
  __nv_bfloat16* s_hg = reinterpret_cast<__nv_bfloat16*>(smem + L.hg);

  // graph b, target rows (and d_xl's columns) i0 .. i0 + r - 1
  const int tid = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int b = static_cast<int>(blockIdx.x) / tiles;
  const int i0 = (static_cast<int>(blockIdx.x) - b * tiles) * kTileRows;
  const int r = min(kTileRows, n - i0);
  const int nf = n * f, rf = r * f;
  const size_t fs = sizeof(Feat<kBf16>);
  // this CTA's rows of a [B, N, F] tensor
  const size_t go = static_cast<size_t>(b) * nf + static_cast<size_t>(i0) * f;
  // bf16 inputs land in the staging areas, f32 ones where they are used
  const auto dst = [](void* h, float* w) {
    return kBf16 ? h : static_cast<void*>(w);
  };
  const Block blocks[4] = {
      {dst(s_hxl, s_xl), xl + static_cast<size_t>(b) * nf,
       static_cast<uint32_t>(nf * fs)},
      {dst(s_hxr, s_xr), xr + static_cast<size_t>(b) * nf,
       static_cast<uint32_t>(nf * fs)},
      {dst(s_hg, s_g), grad + go, static_cast<uint32_t>(rf * fs)},
      {s_adj, adj + static_cast<size_t>(b) * n * n +
                  static_cast<size_t>(i0) * n,
       static_cast<uint32_t>(r * n)}};
  const uint32_t tx = stage(blocks, bar);
#pragma unroll 1
  for (int k = tid; k < f; k += blockDim.x)
    s_att[k] = kBf16 ? round_bf16(att[k]) : att[k];
  __syncthreads();
  if (tx) barrier_wait(bar);
  if constexpr (kBf16) {
    widen_bf16(s_xl, s_hxl, nf);
    widen_bf16(s_xr, s_hxr, nf);
    widen_bf16(s_g, s_hg, rf);
    __syncthreads();
  }
  GAT_CLOCK(1);
  const float* s_xr_rows = s_xr + i0 * f;

  // 1. the rows' alpha and degrees, as the forward computes them
  rows_alpha<kBf16>(s_xl, s_xr_rows, s_att, s_adj, n, r, np, f, inv_n,
                    s_alpha, s_deg);
  GAT_CLOCK(2);

  // 2. the output gradient g_i / d_i (0 on a row without a neighbour), and
  //    this CTA's d_bias partial: kSumParts threads per feature, each over
  //    rows p, p + kSumParts, ..., then their sums in order, in double
  double* part = partials + static_cast<size_t>(blockIdx.x) * 2 * f;
#pragma unroll 1
  for (int t = tid; t < rf; t += blockDim.x) {
    const int deg = s_deg[div_floor(t, inv_f)];
    const float gt = deg > 0 ? s_g[t] : 0.f;
    s_do[t] = mean_aggr ? gt / static_cast<float>(max(deg, 1)) : gt;
  }
#pragma unroll 1
  for (int t = tid; t < f * kSumParts; t += blockDim.x) {
    const int k = t / kSumParts, p = t - k * kSumParts;
    double acc = 0.0;
#pragma unroll 1
    for (int i = p; i < r; i += kSumParts)
      if (s_deg[i] > 0) acc += s_g[i * f + k];
    s_sums[t] = acc;
  }
  __syncthreads();
  GAT_CLOCK(3);

  // 3. dalpha_ij = (g_i / d_i) . xl_j, all threads over the pairs; the
  //    d_bias partial in order
#pragma unroll 1
  for (int t = tid; t < r * n; t += blockDim.x) {
    const int i = div_floor(t, inv_n), j = t - i * n;
    s_dl[i * np + j] = dot(s_do + i * f, s_xl + j * f, f);
  }
#pragma unroll 1
  for (int k = tid; k < f; k += blockDim.x) {
    double acc = 0.0;
#pragma unroll 1
    for (int p = 0; p < kSumParts; ++p) acc += s_sums[k * kSumParts + p];
    part[f + k] = acc;
  }
  __syncthreads();

  // 4. dl_ij = alpha_ij (delta_ij - sum_k alpha_ik delta_ik) with delta_ij
  //    = dalpha_ij - dalpha_ip at the row's largest weight p (the first
  //    lane holding it): the same value as alpha_ij (dalpha_ij - sum_k
  //    alpha_ik dalpha_ik), but where the softmax saturates (alpha_ip = 1
  //    to f32 precision) that difference of two nearly equal numbers would
  //    swamp dl with rounding, and here the pivot's own term is exactly 0.
  //    One warp per row.
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll 1
  for (int i = warp; i < r; i += blockDim.x >> 5) {
    const float* alpha_i = s_alpha + i * np;
    float* dl_i = s_dl + i * np;
    // the largest weight of the row and where it is: each lane's first,
    // then the first lane holding the row's
    float a_max = -1.f;
    int j_max = 0;
#pragma unroll 1
    for (int j = lane; j < n; j += 32)
      if (alpha_i[j] > a_max) {
        a_max = alpha_i[j];
        j_max = j;
      }
    const float row_max = warp_max(a_max);
    const int src = __ffs(__ballot_sync(kFull, a_max == row_max)) - 1;
    const float pivot = dl_i[__shfl_sync(kFull, j_max, src)];
    float t = 0.f;
#pragma unroll 1
    for (int j = lane; j < n; j += 32)
      t = fmaf(alpha_i[j], dl_i[j] - pivot, t);
    t = warp_sum(t);
    __syncwarp();
#pragma unroll 1
    for (int j = lane; j < n; j += 32)
      dl_i[j] = alpha_i[j] * ((dl_i[j] - pivot) - t);
  }
  __syncthreads();
  // every tile's alpha, dl and g_i / d_i are ready for the column sums
  cluster.sync();
  GAT_CLOCK(4);

  // 5. d_xr and the d_att terms by (i, f) of the CTA's rows, summed over
  //    j; d_xl by (j, f) of its columns, summed over every row i in order,
  //    tile by tile (another tile's rows from that CTA's shared memory);
  //    two independent partial sums each.  d_xr and d_xl wait in shared
  //    memory (d_xl where g was) until the partials are out.  In bf16,
  //    act() and slope_times() are the bf16 activation and slope, and
  //    d_xl's aggregation term sums bf16(alpha)
  float* s_dxl = s_g;
  float* s_dxr = reinterpret_cast<float*>(smem + L.dxr);
#pragma unroll 1
  for (int t = tid; t < 2 * rf; t += blockDim.x) {
    if (t < rf) {
      const int i = div_floor(t, inv_f), k = t - i * f;
      const float xr_ik = s_xr_rows[t];
      const float* dl_i = s_dl + i * np;
      const float* x = s_xl + k;
      float r0 = 0.f, r1 = 0.f, a0 = 0.f, a1 = 0.f;
      int j = 0;
#pragma unroll 1
      for (; j + 1 < n; j += 2) {
        const float e0 = x[j * f] + xr_ik, e1 = x[(j + 1) * f] + xr_ik;
        r0 += slope_times<kBf16>(e0, dl_i[j]);
        r1 += slope_times<kBf16>(e1, dl_i[j + 1]);
        a0 = fmaf(dl_i[j], act<kBf16>(e0), a0);
        a1 = fmaf(dl_i[j + 1], act<kBf16>(e1), a1);
      }
      if (j < n) {
        const float e0 = x[j * f] + xr_ik;
        r0 += slope_times<kBf16>(e0, dl_i[j]);
        a0 = fmaf(dl_i[j], act<kBf16>(e0), a0);
      }
      s_dxr[t] = s_att[k] * (r0 + r1);
      s_apart[t] = a0 + a1;
    } else {
      const int v = t - rf;
      const int jl = div_floor(v, inv_f), k = v - jl * f;
      const int j = i0 + jl;
      const float xl_jk = s_xl[j * f + k];
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
      for (int c = 0; c < tiles; ++c) {
        const int ib = c * kTileRows;
        column_sums<kBf16>(cluster.map_shared_rank(s_alpha, c),
                           cluster.map_shared_rank(s_dl, c),
                           cluster.map_shared_rank(s_do, c) + k,
                           s_xr + ib * f + k, min(kTileRows, n - ib), np, f,
                           j, xl_jk, s);
      }
      s_dxl[v] = (s[0] + s[1]) + s_att[k] * (s[2] + s[3]);
    }
  }
  __syncthreads();
  // no CTA of the cluster leaves while another still reads its memory
  cluster.sync();
  GAT_CLOCK(5);

  // 6. this CTA's d_att partial, as d_bias's; out to the scratch, then
  //    counted in
#pragma unroll 1
  for (int t = tid; t < f * kSumParts; t += blockDim.x) {
    const int k = t / kSumParts, p = t - k * kSumParts;
    double acc = 0.0;
#pragma unroll 1
    for (int i = p; i < r; i += kSumParts) acc += s_apart[i * f + k];
    s_sums[t] = acc;
  }
  __syncthreads();
#pragma unroll 1
  for (int k = tid; k < f; k += blockDim.x) {
    double acc = 0.0;
#pragma unroll 1
    for (int p = 0; p < kSumParts; ++p) acc += s_sums[k * kSumParts + p];
    part[k] = acc;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(counter, 1u) == gridDim.x - 1;

  // 7. d_xl and d_xr out (coalesced; rounded once to bf16 in the bf16
  //    form); no other CTA reads them
  Feat<kBf16>* d_xl_b = d_xl + go;
  Feat<kBf16>* d_xr_b = d_xr + go;
#pragma unroll 1
  for (int t = tid; t < rf; t += blockDim.x) {
    if constexpr (kBf16) {
      d_xl_b[t] = __float2bfloat16_rn(s_dxl[t]);
      d_xr_b[t] = __float2bfloat16_rn(s_dxr[t]);
    } else {
      d_xl_b[t] = s_dxl[t];
      d_xr_b[t] = s_dxr[t];
    }
  }
  __syncthreads();
  GAT_CLOCK(6);

  // 8. the last CTA to finish adds the partials in CTA order (graph by
  //    graph, tile by tile): kSumParts threads per sum, each over CTAs c =
  //    p, p + kSumParts, ..., then the kSumParts sums in order of p
  if (!s_last) return;
  __threadfence();
#pragma unroll 1
  for (int t = tid; t < 2 * f * kSumParts; t += blockDim.x) {
    const int k = t / kSumParts, p = t - k * kSumParts;
    double acc = 0.0;
#pragma unroll 1
    for (unsigned int c = p; c < gridDim.x; c += kSumParts)
      acc += __ldcg(partials + static_cast<size_t>(c) * 2 * f + k);
    s_sums[t] = acc;
  }
  __syncthreads();
#pragma unroll 1
  for (int k = tid; k < 2 * f; k += blockDim.x) {
    double acc = 0.0;
#pragma unroll 1
    for (int p = 0; p < kSumParts; ++p) acc += s_sums[k * kSumParts + p];
    if (k < f)
      d_att[k] = static_cast<float>(acc);
    else
      d_bias[k - f] = static_cast<float>(acc);
  }
  if (tid == 0) *counter = 0u;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes (bf16: the bf16 form).
long long gat_attention_backward_smem_bytes(int n, int f, int bf16) {
  return static_cast<long long>(layout(n, f, bf16 != 0).total);
}

// CTAs per graph (its tiles of target rows), or 0 when the graph needs
// more than a cluster holds.
int gat_attention_backward_tiles(int n) {
  return row_tiles(n) <= kMaxCluster ? row_tiles(n) : 0;
}

}  // extern "C"

namespace {

template <bool kBf16>
int launch(const Feat<kBf16>* grad, const Feat<kBf16>* xl,
           const Feat<kBf16>* xr, const float* att, const void* adj,
           Feat<kBf16>* d_xl, Feat<kBf16>* d_xr, float* d_att, float* d_bias,
           void* partials, void* counter, int batch, int n, int f,
           int mean_aggr, void* stream) {
  const Layout L = layout(n, f, kBf16);
  const int tiles = row_tiles(n);
  if (tiles > kMaxCluster) return static_cast<int>(cudaErrorInvalidValue);
  // a graph of one tile is one CTA; larger ones one cluster each
  auto* const kernel = tiles == 1
                           ? &gat_attention_backward_kernel<kBf16>
                           : &gat_attention_backward_cluster_kernel<kBf16>;
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L.total));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (batch == 0) return 0;
  const unsigned char* adj_b = static_cast<const unsigned char*>(adj);
  double* part = static_cast<double*>(partials);
  unsigned int* count = static_cast<unsigned int*>(counter);
  const float inv_n = 1.f / static_cast<float>(n);
  const float inv_f = 1.f / static_cast<float>(f);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiles == 1) {
    kernel<<<batch, warps_for(n) * 32, L.total, st>>>(
        grad, xl, xr, att, adj_b, d_xl, d_xr, d_att, d_bias, part, count, L,
        n, f, mean_aggr, inv_n, inv_f);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * tiles));
  cfg.blockDim = dim3(static_cast<unsigned>(warps_for(n) * 32));
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(tiles);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, grad, xl, xr, att, adj_b, d_xl, d_xr, d_att, d_bias,
      part, count, L, n, f, mean_aggr, inv_n, inv_f);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`.  d_att and d_bias [f] f32; partials [batch *
// gat_attention_backward_tiles(n), 2 f] doubles (8-byte aligned); counter
// one unsigned int that is 0 between launches.  Returns the cudaError_t
// of the launch, 0 on success.
int gat_attention_backward_f32(const float* grad, const float* xl,
                               const float* xr, const float* att,
                               const void* adj, float* d_xl, float* d_xr,
                               float* d_att, float* d_bias, void* partials,
                               void* counter, int batch, int n, int f,
                               int mean_aggr, void* stream) {
  return launch<false>(grad, xl, xr, att, adj, d_xl, d_xr, d_att, d_bias,
                       partials, counter, batch, n, f, mean_aggr, stream);
}

// The bf16 form: grad, xl, xr, d_xl and d_xr bf16 (torch.bfloat16); att,
// d_att and d_bias f32.
int gat_attention_backward_bf16(const void* grad, const void* xl,
                                const void* xr, const float* att,
                                const void* adj, void* d_xl, void* d_xr,
                                float* d_att, float* d_bias, void* partials,
                                void* counter, int batch, int n, int f,
                                int mean_aggr, void* stream) {
  using bf = __nv_bfloat16;
  return launch<true>(static_cast<const bf*>(grad),
                      static_cast<const bf*>(xl), static_cast<const bf*>(xr),
                      att, adj, static_cast<bf*>(d_xl), static_cast<bf*>(d_xr),
                      d_att, d_bias, partials, counter, batch, n, f,
                      mean_aggr, stream);
}

const char* gat_attention_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#ifdef GAT_STAGE_CLOCKS
// The last launch's stage clocks of block 0 (kStageClocks values).
int gat_attention_backward_stage_clocks(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(
      host, g_stage_clocks, sizeof(long long) * kStageClocks));
}
#endif

}  // extern "C"
