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
// frameworks.  dl is taken relative to the row's largest weight: dl_ij =
// alpha_ij (delta_ij - sum_k alpha_ik delta_ik), delta_ij = dalpha_ij -
// dalpha_ip at p = argmax_j alpha_ij.  Trained weights give logits of
// several hundred, a softmax saturated to f32 precision, and the textbook
// form's dalpha_ip - sum_k alpha_ik dalpha_ik then cancels to its
// rounding, off by more than the gradient itself; here the pivot's own
// term is exactly 0.
//
// What bounds it on this card.  Neither bytes nor operations: a flagship
// graph (N = 24, F = 22) is ~9.5 KB in and out, and the bound of the
// learn burst's call (B = 100) is 0.0003 ms.  At N <= 32 one CTA per graph
// runs a chain of dependent stages, and every CTA of a call fits on the
// card at once, so the call takes one CTA's chain.  The first design's
// chain (~17,600 cycles by its stage clocks at N = 24) had eight
// barrier-separated stages; its longest links were the triple stage
// (~4,800 cycles: 2 N F outputs for 768 threads, two rounds in which a
// thread walked all N rows or columns alone, reading two to four shared
// words per term), the dalpha and dl stages (~3,700) and the cross-CTA
// sum (~3,400 plus the last CTA's dependent loads).  Above 32 nodes a graph
// is one cluster of CTAs of 32 target rows, and the call is bound by the
// triple stage's shared-memory traffic and, in the first design, by d_xl's
// column sums, which walked every row of every tile through distributed
// shared memory one remote row pair at a time (54,000 of 84,000 cycles at
// N = 128).
//
// The design, in one launch:
//
// 1. pairs: every (i, j) pair's logit by the forward's operations in the
//    forward's order (gat_common.cuh, logit(): four partial sums over the
//    features, feature k into sum k mod 4), and in the same loop over the
//    features the dot g_i . xl_j, which shares the xl_j reads.  At N <=
//    32 one warp per target row, lane j the pair (i, j); above 32 a thread
//    per (row, four columns) over a transposed xl read as float4, so xr_i,
//    g_i and att are read once for four pairs (a quad off the adjacency
//    is skipped: its weights and dl are 0);
// 2. rows, one warp per target row, the row in registers: the forward's
//    softmax by row_softmax()'s operations in its order (so alpha equals
//    the forward's bit for bit), then dalpha = dot / d_i, the pivot, dl
//    and g_i / d_i; at N <= 32 in the same warp as step 1, with no barrier
//    between.  The row's weights are stored as the aggregation sums them
//    (bf16(alpha) in the bf16 form), dl beside them;
// 3. triples in register tiles, e_ijf recomputed: each thread reads the
//    dl and weights of 4 source columns as float4 and xl, xr, g / d once
//    each, and adds each triple's three terms (the d_xr row sum, the d_xl
//    column sum, the d_att sum).  At N <= 32 a thread takes one feature
//    and 4 target rows x 4 columns; the tiles' row and column partials go
//    to shared memory and are added in tile order beside the stores.
//    Above 32 a warp takes a feature and 64 columns over all 32 rows of
//    its CTA (rows and columns padded with zeros, so no guard in the
//    loop): its 16 column lanes' row sums by a reduce-scatter shuffle in a
//    fixed order, its column sums complete in registers;
// 4. above 32 nodes each CTA holds its rows' d_xl column sums for every
//    column; after one cluster barrier each CTA adds its own columns'
//    sums from every CTA of the cluster in rank order (distributed shared
//    memory, the loads four at a time before their adds), instead of
//    walking every row of every CTA.
//
// d_att and d_bias are sums across graphs: each graph's (or CTA's) terms
// are added in double, 8 lanes per sum over strided terms combined by a
// fixed shuffle butterfly (at N <= 32 in the top warps, beside the other
// warps' stores); a cluster's CTAs' sums are added by its rank 0 in rank
// order.  Each graph's sums go to a scratch buffer [B, 2 F], one thread
// counts the graph in with a release atomic (an integer counter, reset by
// the last graph's CTA for the next launch), and the last graph adds the
// sums in graph order, 16 lanes per sum, 8 loads in flight per lane.  No
// float atomics: two launches on the same inputs give the same bits.
// Graphs of up to 32 nodes run 1,024 threads per CTA; clusters run 512
// threads per CTA, two to an SM, where their shared memory allows it and
// the grid exceeds one CTA per SM, else 1,024.  A feature count whose
// partials do not fit shared memory is done in chunks of features.
//
// The bf16 form's LeakyReLU is computed two values at a time by packed
// bf16x2 instructions (act2()), which give act()'s bits.
//
// The bf16 form (gat_attention_backward_bf16, template parameter kBf16)
// is the gradient of gat_attention.cu's bf16 form at that form's own
// rounding points, each rounding's derivative taken as 1: grad_out, xl
// and xr arrive in bf16 and are widened to f32 in shared memory; alpha is
// recomputed in f32 by the forward's own operations (the logits of the
// bf16 activations and bf16(att)); dl uses the unrounded alpha and is taken
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

// Threads per CTA of a graph of up to 32 nodes.
constexpr int kThreads = 1024;

// Lanes per sum of one graph's (or CTA's) d_att and d_bias terms, and per
// sum of the graphs' partials in the last CTA.
constexpr int kSumLanes = 8;
constexpr int kLastLanes = 16;

// Columns of one warp item of the cluster kernel's triples: 16 lanes of 4
// columns; the warp's two halves take alternate groups of 4 rows.
constexpr int kChunkCols = 64;

// Dynamic shared memory a CTA may ask for: a block's ceiling on Hopper
// less room for the kernels' static shared memory.
constexpr size_t kSmemBudget = 232448 - 1024;

// Byte offsets of the dynamic shared memory, each 16-byte aligned, and the
// features per chunk (fc); computed on the host and passed by value.
struct Layout {
  unsigned xl, xr, g, dout, adj, att, alpha, dl, deg, pa, part, hxl, hxr, hg,
      bar, pr, pl, total, fc, ldx;
};

template <bool kBf16>
using Feat = typename std::conditional<kBf16, __nv_bfloat16, float>::type;

// The row stride of the [rows][N] weights and dl: n rounded up to 4 (n <=
// 32), or to a whole number of the triples' column chunks (n > 32), the
// pad columns 0.
__host__ __device__ inline int row_stride(int n) {
  return n <= kTileRows ? round4(n)
                        : (n + kChunkCols - 1) / kChunkCols * kChunkCols;
}

// The shared memory of one CTA.  n <= 32 (one CTA per graph, rows r = n):
// xl, xr, g and g / d [n][f], the adjacency [n][n], weights and dl
// [n][np], the tiles' d_att terms pa [tiles][f], then the tiles' row sums
// pr [np / 4][n][fc] and column sums pl [np / 4][np][fc].  n > 32 (rows r = 32 per CTA): xl transposed [f][ldx], xr, g and g
// / d of the rows [r][f], their adjacency [r][n], weights and dl [r][np],
// the warp items' d_att terms pa [chunks][f], the CTA's d_att and d_bias
// terms part [2 f] (double), then the items' row sums pr [chunks][r][fc]
// and the column sums of the CTA's rows lt (at pl) [fc][np].  bf16:
// staging areas for the bf16 inputs (hxl only at n <= 32: above, xl is
// read transposed from device memory).  fc: the features whose terms fit
// at once.
Layout layout(int n, int f, bool bf16) {
  const size_t fl = sizeof(float);
  const bool small = n <= kTileRows;
  const int r = tile_rows(n);
  const int np = row_stride(n);
  const int nt = np / 4;
  const int chunks = np / kChunkCols;
  const size_t rows = align16(static_cast<size_t>(r) * f * fl);
  Layout l;
  l.ldx = small ? 0 : np + 4;
  size_t o = 0;
  l.xl = o;
  o += small ? rows : align16(static_cast<size_t>(f) * l.ldx * fl);
  l.xr = o;
  o += rows;
  l.g = o;
  o += rows;
  l.dout = o;
  o += rows;
  l.adj = o;
  o += align16(static_cast<size_t>(r) * n);
  l.att = o;
  o += align16(f * fl);
  l.alpha = o;
  o += static_cast<size_t>(r) * np * fl;
  l.dl = o;
  o += static_cast<size_t>(r) * np * fl;
  l.deg = o;
  o += align16(r * sizeof(int));
  l.pa = o;
  o += align16(static_cast<size_t>(small ? nt * nt : chunks) * f * fl);
  l.part = o;
  o += small ? 0 : align16(2 * f * sizeof(double));
  const size_t hrows = bf16 ? align16(static_cast<size_t>(r) * f * 2) : 0;
  l.hxl = o;
  o += small ? hrows : 0;
  l.hxr = o;
  o += hrows;
  l.hg = o;
  o += hrows;
  l.bar = o;
  o += 16;
  // the terms of fc features at a time: as many as fit, at least 1
  const size_t per = small
      ? static_cast<size_t>(nt) * (r + np) * fl
      : static_cast<size_t>(chunks) * r * fl + static_cast<size_t>(np) * fl;
  size_t fc = kSmemBudget > o + 32 ? (kSmemBudget - o - 32) / per : 1;
  fc = fc < 1 ? 1 : (fc > static_cast<size_t>(f) ? f : fc);
  l.fc = static_cast<unsigned>(fc);
  l.pr = o;
  o += align16(static_cast<size_t>(small ? nt : chunks) * r * fc * fl);
  l.pl = o;
  o += align16(static_cast<size_t>(small ? nt * np : np) * fc * fl);
  l.total = o;
  return l;
}

// act() of two pairwise sums.  bf16: e = bf16(s) by one packed
// conversion, then bf16(kSlopeBf16 e) by one packed bf16 multiply (the
// product of two bf16 values is exact in f32, so its one rounding is
// act()'s) and the larger of the two by one packed max (for e >= 0 it is
// e, below 0 the slope's product, as act() selects), so each value is
// act()'s bit for bit.
template <bool kBf16>
__device__ __forceinline__ float2 act2(float s0, float s1) {
  if constexpr (kBf16) {
    const __nv_bfloat162 e = __floats2bfloat162_rn(s0, s1);
    const __nv_bfloat162 slope = __float2bfloat162_rn(kSlopeBf16);
    return __bfloat1622float2(__hmax2(e, __hmul2(e, slope)));
  } else {
    return make_float2(leaky(s0), leaky(s1));
  }
}

// The logit of pair (i, j) by the forward's operations in the forward's
// order (gat_common.cuh, logit()), and in the same loop over the features
// the dot g_i . xl_j (four partial sums, added as the logit's), returned
// in dot.
template <bool kBf16>
__device__ __forceinline__ float logit_dot(const float* xl_j,
                                           const float* xr_i,
                                           const float* g_i, const float* att,
                                           int f, float& dot) {
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
  if ((f & 1) == 0) {
    const float2* x2 = reinterpret_cast<const float2*>(xl_j);
    const float2* r2 = reinterpret_cast<const float2*>(xr_i);
    const float2* a2 = reinterpret_cast<const float2*>(att);
    const float2* g2 = reinterpret_cast<const float2*>(g_i);
    const int h = f >> 1;
    int q = 0;
#pragma unroll 1
    for (; q + 1 < h; q += 2) {
      const float2 x0 = x2[q], x1 = x2[q + 1];
      const float2 r0 = r2[q], r1 = r2[q + 1];
      const float2 a0 = a2[q], a1 = a2[q + 1];
      const float2 g0 = g2[q], g1 = g2[q + 1];
      const float2 p0 = act2<kBf16>(x0.x + r0.x, x0.y + r0.y);
      const float2 p1 = act2<kBf16>(x1.x + r1.x, x1.y + r1.y);
      c0 = fmaf(p0.x, a0.x, c0);
      c1 = fmaf(p0.y, a0.y, c1);
      c2 = fmaf(p1.x, a1.x, c2);
      c3 = fmaf(p1.y, a1.y, c3);
      d0 = fmaf(g0.x, x0.x, d0);
      d1 = fmaf(g0.y, x0.y, d1);
      d2 = fmaf(g1.x, x1.x, d2);
      d3 = fmaf(g1.y, x1.y, d3);
    }
    if (q < h) {
      const float2 x0 = x2[q], r0 = r2[q], a0 = a2[q], g0 = g2[q];
      const float2 p0 = act2<kBf16>(x0.x + r0.x, x0.y + r0.y);
      c0 = fmaf(p0.x, a0.x, c0);
      c1 = fmaf(p0.y, a0.y, c1);
      d0 = fmaf(g0.x, x0.x, d0);
      d1 = fmaf(g0.y, x0.y, d1);
    }
  } else {
    int k = 0;
#pragma unroll 1
    for (; k + 3 < f; k += 4) {
      const float2 p0 =
          act2<kBf16>(xl_j[k] + xr_i[k], xl_j[k + 1] + xr_i[k + 1]);
      const float2 p1 =
          act2<kBf16>(xl_j[k + 2] + xr_i[k + 2], xl_j[k + 3] + xr_i[k + 3]);
      c0 = fmaf(p0.x, att[k], c0);
      c1 = fmaf(p0.y, att[k + 1], c1);
      c2 = fmaf(p1.x, att[k + 2], c2);
      c3 = fmaf(p1.y, att[k + 3], c3);
      d0 = fmaf(g_i[k], xl_j[k], d0);
      d1 = fmaf(g_i[k + 1], xl_j[k + 1], d1);
      d2 = fmaf(g_i[k + 2], xl_j[k + 2], d2);
      d3 = fmaf(g_i[k + 3], xl_j[k + 3], d3);
    }
#pragma unroll 1
    for (; k < f; ++k) {
      c0 = fmaf(act<kBf16>(xl_j[k] + xr_i[k]), att[k], c0);
      d0 = fmaf(g_i[k], xl_j[k], d0);
    }
  }
  dot = (d0 + d1) + (d2 + d3);
  return (c0 + c1) + (c2 + c3);
}

// The logits and dots of pairs (i, j0 + p), p < 4, from xl transposed
// (xlT [f][ldx], the four columns read as one float4): each logit by the
// forward's operations in its order, feature k into partial sum k mod 4
// (for odd f the last f mod 4 features into the first, as logit() adds
// them), each dot one sum over the features in order.
template <bool kBf16>
__device__ __forceinline__ void logits4(const float* xlT, int ldx,
                                        const float* xr_i, const float* g_i,
                                        const float* att, int f, int j0,
                                        float (&lg)[4], float (&dq)[4]) {
  float c[4][4], d[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    d[p] = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) c[p][m] = 0.f;
  }
  int k = 0;
#pragma unroll 1
  for (; k + 3 < f; k += 4) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 x =
          *reinterpret_cast<const float4*>(xlT + (k + m) * ldx + j0);
      const float r = xr_i[k + m], a = att[k + m], gg = g_i[k + m];
      const float2 p0 = act2<kBf16>(x.x + r, x.y + r);
      const float2 p1 = act2<kBf16>(x.z + r, x.w + r);
      c[0][m] = fmaf(p0.x, a, c[0][m]);
      c[1][m] = fmaf(p0.y, a, c[1][m]);
      c[2][m] = fmaf(p1.x, a, c[2][m]);
      c[3][m] = fmaf(p1.y, a, c[3][m]);
      d[0] = fmaf(gg, x.x, d[0]);
      d[1] = fmaf(gg, x.y, d[1]);
      d[2] = fmaf(gg, x.z, d[2]);
      d[3] = fmaf(gg, x.w, d[3]);
    }
  }
  const bool even = (f & 1) == 0;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    if (k + m < f) {
      const float4 x =
          *reinterpret_cast<const float4*>(xlT + (k + m) * ldx + j0);
      const float r = xr_i[k + m], a = att[k + m], gg = g_i[k + m];
      const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (even)
          c[p][m] = fmaf(act<kBf16>(v[p] + r), a, c[p][m]);
        else
          c[p][0] = fmaf(act<kBf16>(v[p] + r), a, c[p][0]);
        d[p] = fmaf(gg, v[p], d[p]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    lg[p] = (c[p][0] + c[p][1]) + (c[p][2] + c[p][3]);
    dq[p] = d[p];
  }
}

// The row's dalpha = dot / d_i, the pivot at its largest weight and dl,
// for the weights a[m] and dots q[m] of source nodes j = lane + 32 m (m <
// kM, those with j < n): dalpha into q, dl into q's place on return.
// The pivot is each lane's first largest weight, then the first lane
// holding the row's.
template <int kM>
__device__ __forceinline__ void row_dl(const float (&a)[kM], float (&q)[kM],
                                       int n, float inv_d, int lane) {
  float a_max = -1.f;
  int m_max = 0;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    q[m] *= inv_d;
    if (lane + 32 * m < n && a[m] > a_max) {
      a_max = a[m];
      m_max = m;
    }
  }
  const float row_max = warp_max(a_max);
  const int src = __ffs(__ballot_sync(kFull, a_max == row_max)) - 1;
  const int m_p = __shfl_sync(kFull, m_max, src);
  float mine = q[0];
#pragma unroll
  for (int m = 1; m < kM; ++m)
    if (m == m_p) mine = q[m];
  const float pivot = __shfl_sync(kFull, mine, src);
  float t = 0.f;
#pragma unroll
  for (int m = 0; m < kM; ++m)
    if (lane + 32 * m < n) t = fmaf(a[m], q[m] - pivot, t);
  t = warp_sum(t);
#pragma unroll
  for (int m = 0; m < kM; ++m) q[m] = a[m] * ((q[m] - pivot) - t);
}

// A target row of a graph of up to 32 nodes, by one warp, lane j holding
// the pair's logit l (the forward's, before the adjacency mask) and dot q:
// the forward's softmax by row_softmax()'s operations for n <= 32 in its
// order (the degree from the adjacency's ballot, the row max, one expf,
// selected to 0 off the adjacency, the shuffle sum, the floored
// denominator, one division), so the weights are the forward's bit for
// bit; then dl (row_dl).  arow gets the weights the aggregation sums
// (bf16(alpha) in bf16), drow dl, both 0 in the pad columns n .. np - 1;
// g / d_i (0 on a row without a neighbour) into do_i and the degree into
// *deg_i.
template <bool kBf16>
__device__ __forceinline__ void row_grad(float l, float q, float* arow,
                                         float* drow,
                                         const unsigned char* adj_i,
                                         const float* g_i, float* do_i,
                                         int* deg_i, int n, int np, int f,
                                         int mean_aggr, int lane) {
  const bool in = lane < n;
  const bool nb = in && adj_i[lane];
  const int deg = __popc(__ballot_sync(kFull, nb));
  float a[1] = {0.f};
  if (deg > 0) {
    const float lg = nb ? l : kNegInf;
    const float e = expf(lg - warp_max(lg));
    const float ex = nb ? e : 0.f;
    const float denom = fmaxf(warp_sum(ex), 1e-30f);
    if (in) a[0] = ex / denom;
  }
  const float inv_d =
      mean_aggr ? 1.f / static_cast<float>(max(deg, 1)) : 1.f;
  float qq[1] = {in ? q : 0.f};
  row_dl<1>(a, qq, n, inv_d, lane);
  if (lane < np) {
    drow[lane] = in ? qq[0] : 0.f;
    arow[lane] = in ? (kBf16 ? round_bf16(a[0]) : a[0]) : 0.f;
  }
  if (lane == 0) *deg_i = deg;
#pragma unroll 1
  for (int k = lane; k < f; k += 32)
    do_i[k] = deg > 0 ? g_i[k] * inv_d : 0.f;
}

// A target row of a graph of 33 to 32 kM nodes, by one warp, the row in
// registers (node j = lane + 32 m in slot m): the forward's softmax by
// row_softmax()'s operations in its order (the degree from the ballots of
// the adjacency, the row max, one expf per node, selected to 0 off the
// adjacency, the lane's sum in order of m, the warp's shuffle sum, the
// floored denominator, one division per weight), so the weights are the
// forward's bit for bit; then as row_grad.
template <bool kBf16, int kM>
__device__ __forceinline__ void row_grad_wide(float* arow, float* drow,
                                              const unsigned char* adj_i,
                                              const float* g_i, float* do_i,
                                              int* deg_i, int n, int np,
                                              int f, int mean_aggr,
                                              int lane) {
  float a[kM], q[kM];
  unsigned int nb = 0;  // bit m: node lane + 32 m is a neighbour
  int deg = 0;
  float mx = kNegInf;
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int j = lane + 32 * m;
    const bool in = j < n;
    a[m] = in ? arow[j] : kNegInf;
    q[m] = in ? drow[j] : 0.f;
    const bool e = in && adj_i[j];
    nb |= static_cast<unsigned int>(e) << m;
    if (32 * m < n) deg += __popc(__ballot_sync(kFull, e));
    if (in) mx = fmaxf(mx, a[m]);
  }
  if (deg > 0) {
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      if (lane + 32 * m < n) {
        const float e = expf(a[m] - mx);
        a[m] = (nb >> m) & 1u ? e : 0.f;
        s += a[m];
      } else {
        a[m] = 0.f;
      }
    }
    const float denom = fmaxf(warp_sum(s), 1e-30f);
#pragma unroll
    for (int m = 0; m < kM; ++m) a[m] = a[m] / denom;
  } else {
#pragma unroll
    for (int m = 0; m < kM; ++m) a[m] = 0.f;
  }
  const float inv_d =
      mean_aggr ? 1.f / static_cast<float>(max(deg, 1)) : 1.f;
  row_dl<kM>(a, q, n, inv_d, lane);
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const int j = lane + 32 * m;
    if (j < np) {
      const bool in = j < n;
      drow[j] = in ? q[m] : 0.f;
      arow[j] = in ? (kBf16 ? round_bf16(a[m]) : a[m]) : 0.f;
    }
  }
  if (lane == 0) *deg_i = deg;
#pragma unroll 1
  for (int k = lane; k < f; k += 32)
    do_i[k] = deg > 0 ? g_i[k] * inv_d : 0.f;
}

// The triples (i, j0 + q, f), q < 4, of one row i and feature f: e =
// xl_jf + xr_if, the d_xr row term and the d_xl de terms s = dl
// LeakyReLU'(e) (into r and lde[q]), the d_att terms dl LeakyReLU(e)
// (into a; in f32 as s e, the same product) and the aggregation terms w
// g_if / d_i (into lagg[q]), for xl x[q], dl d and weights w of the four
// columns.
template <bool kBf16>
__device__ __forceinline__ void triples4(const float (&x)[4], float xr,
                                         float4 d, float4 w, float dout,
                                         float& r, float (&lde)[4],
                                         float (&lagg)[4], float& a) {
  const float e[4] = {x[0] + xr, x[1] + xr, x[2] + xr, x[3] + xr};
  const float dl[4] = {d.x, d.y, d.z, d.w};
  const float wt[4] = {w.x, w.y, w.z, w.w};
  float av[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (kBf16) {
    const float2 p0 = act2<kBf16>(e[0], e[1]), p1 = act2<kBf16>(e[2], e[3]);
    av[0] = p0.x;
    av[1] = p0.y;
    av[2] = p1.x;
    av[3] = p1.y;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float s = slope_times<kBf16>(e[q], dl[q]);
    r += s;
    lde[q] += s;
    a = kBf16 ? fmaf(dl[q], av[q], a) : fmaf(s, e[q], a);
    lagg[q] = fmaf(wt[q], dout, lagg[q]);
  }
}

// One graph's (or CTA's) d_att and d_bias terms, sum k < 2 f by kSumLanes
// lanes in double, each over strided terms, then a fixed butterfly: d_att
// over the terms pa [terms][f], d_bias over the rows' g [rows][f] where
// deg > 0.  Threads u = u0, u0 + stride, ... (u0 = the lane modulo 32,
// stride a multiple of 32); the group's first lane writes out[k].
__device__ __forceinline__ void term_sums(const float* pa, int terms,
                                          const float* g, const int* deg,
                                          int rows, int f, double* out,
                                          int u0, int stride) {
#pragma unroll 1
  for (int u = u0; u < 2 * f * kSumLanes; u += stride) {
    const int k = u / kSumLanes, p = u % kSumLanes;
    double acc = 0.0;
    if (k < f) {
#pragma unroll 4
      for (int t = p; t < terms; t += kSumLanes) acc += pa[t * f + k];
    } else {
#pragma unroll 4
      for (int i = p; i < rows; i += kSumLanes)
        if (deg[i] > 0) acc += g[i * f + k - f];
    }
    const unsigned mask = 0xffu << (u & 24);
    acc += __shfl_xor_sync(mask, acc, 4);
    acc += __shfl_xor_sync(mask, acc, 2);
    acc += __shfl_xor_sync(mask, acc, 1);
    if (p == 0) out[k] = acc;
  }
}

// The counting thread, after a barrier behind every write of its CTA's
// sums: the count, a release (cumulative over those writes).
__device__ __forceinline__ unsigned int count_in(unsigned int* counter) {
  unsigned int old;
  asm volatile("atom.release.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// The last CTA: d_att and d_bias from the graphs' partials [count][2 f],
// kLastLanes lanes per sum over graphs c = p, p + kLastLanes, ... (eight
// loads issued at a time), then a fixed butterfly.
__device__ __forceinline__ void last_sums(const double* partials, int count,
                                          int f, float* d_att,
                                          float* d_bias) {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
#pragma unroll 1
  for (int u = threadIdx.x; u < 2 * f * kLastLanes; u += blockDim.x) {
    const int k = u / kLastLanes, p = u % kLastLanes;
    double acc = 0.0;
#pragma unroll 1
    for (int c0 = p; c0 < count; c0 += 8 * kLastLanes) {
      double v[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int c = c0 + m * kLastLanes;
        v[m] = c < count
                   ? __ldcg(partials + static_cast<size_t>(c) * 2 * f + k)
                   : 0.0;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) acc += v[m];
    }
    const unsigned mask = 0xffffu << (threadIdx.x & 16);
    acc += __shfl_xor_sync(mask, acc, 8);
    acc += __shfl_xor_sync(mask, acc, 4);
    acc += __shfl_xor_sync(mask, acc, 2);
    acc += __shfl_xor_sync(mask, acc, 1);
    if (p == 0) {
      if (k < f)
        d_att[k] = static_cast<float>(acc);
      else
        d_bias[k - f] = static_cast<float>(acc);
    }
  }
}

template <bool kBf16>
__device__ __forceinline__ Feat<kBf16> out_of(float v) {
  if constexpr (kBf16)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// A graph of up to 32 nodes: one CTA of kThreads threads.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
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
                              float inv_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = row_stride(n);
  float* s_xl = reinterpret_cast<float*>(smem + L.xl);
  float* s_xr = reinterpret_cast<float*>(smem + L.xr);
  float* s_g = reinterpret_cast<float*>(smem + L.g);
  float* s_do = reinterpret_cast<float*>(smem + L.dout);
  unsigned char* s_adj = smem + L.adj;
  float* s_att = reinterpret_cast<float*>(smem + L.att);
  float* s_alpha = reinterpret_cast<float*>(smem + L.alpha);
  float* s_dl = reinterpret_cast<float*>(smem + L.dl);
  int* s_deg = reinterpret_cast<int*>(smem + L.deg);
  float* s_pa = reinterpret_cast<float*>(smem + L.pa);
  float* s_pr = reinterpret_cast<float*>(smem + L.pr);
  float* s_pl = reinterpret_cast<float*>(smem + L.pl);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  __nv_bfloat16* s_hxl = reinterpret_cast<__nv_bfloat16*>(smem + L.hxl);
  __nv_bfloat16* s_hxr = reinterpret_cast<__nv_bfloat16*>(smem + L.hxr);
  __nv_bfloat16* s_hg = reinterpret_cast<__nv_bfloat16*>(smem + L.hg);
  GAT_CLOCK(0);

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

  // 1-2. one warp per target row, lane j: the pair's logit (the
  //      forward's, bit for bit) and dot g_i . xl_j, then the row's
  //      softmax, dl and g / d_i
  const int warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
#pragma unroll 1
  for (int i = warp; i < n; i += nwarps) {
    float q = 0.f, l = kNegInf;
    if (lane < n)
      l = logit_dot<kBf16>(s_xl + lane * f, s_xr + i * f, s_g + i * f, s_att,
                           f, q);
    row_grad<kBf16>(l, q, s_alpha + i * np, s_dl + i * np, s_adj + i * n,
                    s_g + i * f, s_do + i * f, s_deg + i, n, np, f,
                    mean_aggr, lane);
  }
  __syncthreads();
  GAT_CLOCK(3);

  // 3. tiles of 4 rows x 4 columns x 1 feature, fc features at a time:
  //    row sums pr [column tile][i][k], column sums pl [row tile][j][k]
  //    (aggregation + att de), d_att terms pa [tile][f]; then d_xr and d_xl
  //    of those features out, adding the tiles in order, beside (in the
  //    last chunk) the graph's d_att and d_bias terms in the top warps,
  //    which then count the graph in
  const int nt = np >> 2;
  const int fcm = static_cast<int>(L.fc);
  Feat<kBf16>* d_xl_b = d_xl + static_cast<size_t>(b) * nf;
  Feat<kBf16>* d_xr_b = d_xr + static_cast<size_t>(b) * nf;
  const int sum_warp0 =
      max(0, nwarps - (2 * f * kSumLanes + 31) / 32);
  unsigned int ticket = 0;
#pragma unroll 1
  for (int f0 = 0; f0 < f; f0 += fcm) {
    const int fc = min(fcm, f - f0);
    const float inv_fc = 1.f / static_cast<float>(fc);
#pragma unroll 1
    for (int t = tid; t < nt * nt * fc; t += blockDim.x) {
      const int tile = div_floor(t, inv_fc);
      const int k = t - tile * fc;
      const int it = tile / nt, jt = tile - it * nt;
      const int i0 = 4 * it, j0 = 4 * jt, fk = f0 + k;
      float xv[4], lagg[4], lde[4], a = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        xv[q] = j0 + q < n ? s_xl[(j0 + q) * f + fk] : 0.f;
        lagg[q] = lde[q] = 0.f;
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = i0 + ii;
        if (i < n) {
          const float xri = s_xr[i * f + fk], doi = s_do[i * f + fk];
          const float4 d4 =
              *reinterpret_cast<const float4*>(s_dl + i * np + j0);
          const float4 w4 =
              *reinterpret_cast<const float4*>(s_alpha + i * np + j0);
          float r = 0.f;
          triples4<kBf16>(xv, xri, d4, w4, doi, r, lde, lagg, a);
          s_pr[(jt * n + i) * fcm + k] = r;
        }
      }
      const float a_f = s_att[fk];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + q < n)
          s_pl[(it * np + j0 + q) * fcm + k] = lagg[q] + a_f * lde[q];
      s_pa[tile * f + fk] = a;
    }
    __syncthreads();
    GAT_CLOCK(4);
    const bool last_chunk = f0 + fcm >= f;
    if (last_chunk && warp >= sum_warp0) {
      term_sums(s_pa, nt * nt, s_g, s_deg, n, f,
                partials + static_cast<size_t>(b) * 2 * f,
                tid - 32 * sum_warp0, blockDim.x - 32 * sum_warp0);
      asm volatile("bar.sync 1, %0;" ::"r"(blockDim.x - 32 * sum_warp0)
                   : "memory");
      if (tid == 32 * sum_warp0) ticket = count_in(counter);
    }
#pragma unroll 1
    for (int t = tid; t < n * fc; t += blockDim.x) {
      const int i = div_floor(t, inv_fc);
      const int k = t - i * fc;
      float r = 0.f, l = 0.f;
#pragma unroll 8
      for (int c = 0; c < nt; ++c) {
        r += s_pr[(c * n + i) * fcm + k];
        l += s_pl[(c * np + i) * fcm + k];
      }
      d_xr_b[i * f + f0 + k] = out_of<kBf16>(s_att[f0 + k] * r);
      d_xl_b[i * f + f0 + k] = out_of<kBf16>(l);
    }
    if (!last_chunk) __syncthreads();
  }
  GAT_CLOCK(5);
  const bool last = __syncthreads_or(tid == 32 * sum_warp0 &&
                                     ticket == gridDim.x - 1);
  GAT_CLOCK(6);

  // 4. the last graph to count itself in adds the graphs' sums in order
  if (!last) return;
  last_sums(partials, gridDim.x, f, d_att, d_bias);
  if (tid == 0) *counter = 0u;
}

// A graph of more than 32 nodes: its tiles of kTileRows target rows run as
// one thread block cluster (rank = tile).  Each CTA computes its rows'
// pairs, rows and triples over every column; the CTAs' column sums meet
// in the d_xl of each CTA's own columns (rows = columns: tile c's rows
// are the graph's nodes i0 .. i0 + r - 1).
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
                              float inv_f) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = row_stride(n);
  const int ldx = static_cast<int>(L.ldx);
  float* s_xlT = reinterpret_cast<float*>(smem + L.xl);
  float* s_xr = reinterpret_cast<float*>(smem + L.xr);
  float* s_g = reinterpret_cast<float*>(smem + L.g);
  float* s_do = reinterpret_cast<float*>(smem + L.dout);
  unsigned char* s_adj = smem + L.adj;
  float* s_att = reinterpret_cast<float*>(smem + L.att);
  float* s_alpha = reinterpret_cast<float*>(smem + L.alpha);
  float* s_dl = reinterpret_cast<float*>(smem + L.dl);
  int* s_deg = reinterpret_cast<int*>(smem + L.deg);
  float* s_pa = reinterpret_cast<float*>(smem + L.pa);
  double* s_part = reinterpret_cast<double*>(smem + L.part);
  float* s_pr = reinterpret_cast<float*>(smem + L.pr);
  float* s_lt = reinterpret_cast<float*>(smem + L.pl);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);
  __nv_bfloat16* s_hxr = reinterpret_cast<__nv_bfloat16*>(smem + L.hxr);
  __nv_bfloat16* s_hg = reinterpret_cast<__nv_bfloat16*>(smem + L.hg);
  unsigned int ticket = 0;
  GAT_CLOCK(0);

  // graph b, target rows (and d_xl's columns) i0 .. i0 + r - 1
  const int tid = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  const int tiles = (n + kTileRows - 1) / kTileRows;
  const int b = static_cast<int>(blockIdx.x) / tiles;
  const int rank = static_cast<int>(blockIdx.x) - b * tiles;
  const int i0 = rank * kTileRows;
  const int r = min(kTileRows, n - i0);
  const int nf = n * f, rf = r * f;
  const size_t fs = sizeof(Feat<kBf16>);
  // this CTA's rows of a [B, N, F] tensor
  const size_t go = static_cast<size_t>(b) * nf + static_cast<size_t>(i0) * f;
  const auto dst = [](void* h, float* w) {
    return kBf16 ? h : static_cast<void*>(w);
  };
  const Block blocks[3] = {
      {dst(s_hxr, s_xr), xr + go, static_cast<uint32_t>(rf * fs)},
      {dst(s_hg, s_g), grad + go, static_cast<uint32_t>(rf * fs)},
      {s_adj, adj + static_cast<size_t>(b) * n * n +
                  static_cast<size_t>(i0) * n,
       static_cast<uint32_t>(r * n)}};
  const uint32_t tx = stage(blocks, bar);
  // xl of the whole graph, transposed (columns 0 in the pad n .. np - 1)
  const Feat<kBf16>* xl_b = xl + static_cast<size_t>(b) * nf;
#pragma unroll 4
  for (int t = tid; t < nf; t += blockDim.x) {
    const int j = div_floor(t, inv_f), k = t - j * f;
    if constexpr (kBf16)
      s_xlT[k * ldx + j] = __bfloat162float(xl_b[t]);
    else
      s_xlT[k * ldx + j] = xl_b[t];
  }
#pragma unroll 1
  for (int t = tid; t < f * (np - n); t += blockDim.x) {
    const int k = t / (np - n);
    s_xlT[k * ldx + n + t - k * (np - n)] = 0.f;
  }
#pragma unroll 1
  for (int k = tid; k < f; k += blockDim.x)
    s_att[k] = kBf16 ? round_bf16(att[k]) : att[k];
  // rows r .. kTileRows - 1 of a short last tile are zeros, which the
  // triples read without a guard
#pragma unroll 1
  for (int t = tid; t < (kTileRows - r) * f; t += blockDim.x) {
    s_xr[rf + t] = 0.f;
    s_do[rf + t] = 0.f;
  }
#pragma unroll 1
  for (int t = tid; t < (kTileRows - r) * np; t += blockDim.x) {
    s_alpha[r * np + t] = 0.f;
    s_dl[r * np + t] = 0.f;
  }
  __syncthreads();
  if (tx) barrier_wait(bar);
  if constexpr (kBf16) {
    widen_bf16(s_xr, s_hxr, rf);
    widen_bf16(s_g, s_hg, rf);
    __syncthreads();
  }
  GAT_CLOCK(1);

  // 1. the rows' logits (the forward's, bit for bit) and dots, a thread
  //    per (row, four columns)
  const int nq = np >> 2;
#pragma unroll 1
  for (int t = tid; t < r * nq; t += blockDim.x) {
    const int i = t / nq, j0 = 4 * (t - i * nq);
    const unsigned char* adj_i = s_adj + i * n;
    const bool e0 = j0 < n && adj_i[j0], e1 = j0 + 1 < n && adj_i[j0 + 1],
               e2 = j0 + 2 < n && adj_i[j0 + 2],
               e3 = j0 + 3 < n && adj_i[j0 + 3];
    float lg[4] = {0.f, 0.f, 0.f, 0.f}, dq[4] = {0.f, 0.f, 0.f, 0.f};
    // a pair off the adjacency has weight 0 and dl 0 whatever its logit
    // and dot
    if (e0 || e1 || e2 || e3)
      logits4<kBf16>(s_xlT, ldx, s_xr + i * f, s_g + i * f, s_att, f, j0,
                     lg, dq);
    *reinterpret_cast<float4*>(s_alpha + i * np + j0) =
        make_float4(e0 ? lg[0] : kNegInf, e1 ? lg[1] : kNegInf,
                    e2 ? lg[2] : kNegInf, e3 ? lg[3] : kNegInf);
    *reinterpret_cast<float4*>(s_dl + i * np + j0) =
        make_float4(dq[0], dq[1], dq[2], dq[3]);
  }
  __syncthreads();
  GAT_CLOCK(2);

  // 2. softmax, dl and g / d_i, one warp per row
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
#pragma unroll 1
  for (int i = warp; i < r; i += nwarps) {
    if (n <= 128)
      row_grad_wide<kBf16, 4>(s_alpha + i * np, s_dl + i * np, s_adj + i * n,
                              s_g + i * f, s_do + i * f, s_deg + i, n, np, f,
                              mean_aggr, lane);
    else
      row_grad_wide<kBf16, 8>(s_alpha + i * np, s_dl + i * np, s_adj + i * n,
                              s_g + i * f, s_do + i * f, s_deg + i, n, np, f,
                              mean_aggr, lane);
  }
  __syncthreads();
  GAT_CLOCK(3);

  // 3. triples, a warp per (feature, chunk of kChunkCols columns) over
  //    all r rows: lane (lj, li) takes columns c0 .. c0 + 3 and, in steps
  //    of 8 rows, rows 4 li .. 4 li + 3; the row sums of the 16 lanes lj
  //    by a fixed butterfly into pr [chunk][i][k]; the column sums of the
  //    CTA's rows (aggregation + att de) into lt [k][j]; the d_att terms
  //    into pa [chunk][f].  4. then d_xl of the CTA's own columns from
  //    every CTA's lt in rank order, and d_xr of its rows.
  const int fcm = static_cast<int>(L.fc);
  const int chunks = np / kChunkCols;
  const int lj = lane & 15, li = lane >> 4;
  Feat<kBf16>* d_xl_b = d_xl + static_cast<size_t>(b) * nf;
  Feat<kBf16>* d_xr_r = d_xr + go;
#pragma unroll 1
  for (int f0 = 0; f0 < f; f0 += fcm) {
    const int fc = min(fcm, f - f0);
#pragma unroll 1
    for (int item = warp; item < fc * chunks; item += nwarps) {
      const int k = item / chunks, ch = item - k * chunks;
      const int fk = f0 + k;
      const int c0 = ch * kChunkCols + 4 * lj;
      const float4 x4 =
          *reinterpret_cast<const float4*>(s_xlT + fk * ldx + c0);
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
      float lagg[4] = {0.f, 0.f, 0.f, 0.f}, lde[4] = {0.f, 0.f, 0.f, 0.f};
      float a = 0.f;
#pragma unroll 1
      for (int s = 0; s < r; s += 8) {
        float rr[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = s + 4 * li + ii;
          const float xri = s_xr[i * f + fk];
          const float doi = s_do[i * f + fk];
          const float4 d4 =
              *reinterpret_cast<const float4*>(s_dl + i * np + c0);
          const float4 w4 =
              *reinterpret_cast<const float4*>(s_alpha + i * np + c0);
          rr[ii] = 0.f;
          triples4<kBf16>(xv, xri, d4, w4, doi, rr[ii], lde, lagg, a);
        }
        // the 4 rows' sums over the 16 lanes lj, reduced and scattered:
        // lanes lj = 4 q .. 4 q + 3 end with row q's
        const bool h8 = lj & 8, h4 = lj & 4;
        float k0 = h8 ? rr[2] : rr[0], k1 = h8 ? rr[3] : rr[1];
        k0 += __shfl_xor_sync(kFull, h8 ? rr[0] : rr[2], 8);
        k1 += __shfl_xor_sync(kFull, h8 ? rr[1] : rr[3], 8);
        float kk = h4 ? k1 : k0;
        kk += __shfl_xor_sync(kFull, h4 ? k0 : k1, 4);
        kk += __shfl_xor_sync(kFull, kk, 2);
        kk += __shfl_xor_sync(kFull, kk, 1);
        const int i = s + 4 * li + (lj >> 2);
        if ((lj & 3) == 0 && i < r)
          s_pr[(ch * kTileRows + i) * fcm + k] = kk;
      }
      const float a_f = s_att[fk];
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = lagg[q] + a_f * lde[q];
        v[q] += __shfl_xor_sync(kFull, v[q], 16);
      }
      if (li == 0)
        *reinterpret_cast<float4*>(s_lt + k * np + c0) =
            make_float4(v[0], v[1], v[2], v[3]);
      a = warp_sum(a);
      if (lane == 0) s_pa[ch * f + fk] = a;
    }
    const bool last_chunk = f0 + fcm >= f;
    if (last_chunk) {
      // this CTA's d_att and d_bias terms, for rank 0 to add
      __syncthreads();
      term_sums(s_pa, chunks, s_g, s_deg, r, f, s_part, tid, blockDim.x);
    }
    GAT_CLOCK(4);
    // every CTA's lt (and, in the last chunk, its d_att and d_bias terms)
    // is ready
    cluster.sync();
    GAT_CLOCK(5);
    const int part_threads = min(blockDim.x, (2 * f + 31) / 32 * 32);
    if (last_chunk && rank == 0 && tid < part_threads) {
      // the graph's d_att and d_bias terms, its CTAs' in rank order, out;
      // then the graph is counted in
#pragma unroll 1
      for (int k = tid; k < 2 * f; k += part_threads) {
        double acc = 0.0;
#pragma unroll 1
        for (int c = 0; c < tiles; ++c)
          acc += cluster.map_shared_rank(s_part, c)[k];
        partials[static_cast<size_t>(b) * 2 * f + k] = acc;
      }
      asm volatile("bar.sync 1, %0;" ::"r"(part_threads) : "memory");
      if (tid == 0) ticket = count_in(counter);
    }
    const int r2 = (r + 1) >> 1;
#pragma unroll 1
    for (int t = tid; t < fc * r2; t += blockDim.x) {
      const int k = t / r2, jq = t - k * r2;
      const int j = i0 + 2 * jq;
      // in rank order, the loads four at a time
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int c0 = 0; c0 < kMaxCluster; c0 += 4) {
        float2 v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < tiles)
            v[c] = *reinterpret_cast<const float2*>(
                cluster.map_shared_rank(s_lt, c0 + c) + k * np + j);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c0 + c < tiles) {
            acc.x = c0 + c == 0 ? v[c].x : acc.x + v[c].x;
            acc.y = c0 + c == 0 ? v[c].y : acc.y + v[c].y;
          }
      }
      d_xl_b[static_cast<size_t>(j) * f + f0 + k] = out_of<kBf16>(acc.x);
      if (2 * jq + 1 < r)
        d_xl_b[static_cast<size_t>(j + 1) * f + f0 + k] =
            out_of<kBf16>(acc.y);
    }
#pragma unroll 1
    for (int t = tid; t < r * fc; t += blockDim.x) {
      const int i = t / fc, k = t - i * fc;
      float s = 0.f;
#pragma unroll 4
      for (int ch = 0; ch < chunks; ++ch)
        s += s_pr[(ch * kTileRows + i) * fcm + k];
      d_xr_r[i * f + f0 + k] = out_of<kBf16>(s_att[f0 + k] * s);
    }
    // no CTA of the cluster overwrites or leaves while another still
    // reads its memory
    cluster.sync();
  }
  GAT_CLOCK(6);

  // the last graph to count itself in adds the graphs' sums in order
  if (rank != 0) return;
  if (!__syncthreads_or(tid == 0 && ticket == gridDim.x / tiles - 1)) return;
  last_sums(partials, gridDim.x / tiles, f, d_att, d_bias);
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

// The current device's SM count (cached per device).
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0)
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

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
  const float inv_f = 1.f / static_cast<float>(f);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiles == 1) {
    kernel<<<batch, kThreads, L.total, st>>>(
        grad, xl, xr, att, adj_b, d_xl, d_xr, d_att, d_bias, part, count, L,
        n, f, mean_aggr, inv_f);
    return static_cast<int>(cudaGetLastError());
  }
  // CTAs of 512 threads, two on an SM, where their shared memory fits and
  // the grid is more than one CTA per SM; else 1,024 threads (at batch
  // 100 and N = 128 the two-CTA form was 1.26x faster, at batch 4 and N =
  // 64 0.88x as fast)
  const bool two = 2 * (static_cast<size_t>(L.total) + 1024) <= 233472 &&
                   batch * tiles > sm_count();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * tiles));
  cfg.blockDim = dim3(two ? 512u : 1024u);
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
      part, count, L, n, f, mean_aggr, inv_f);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`.  d_att and d_bias [f] f32; partials [batch, 2 f]
// doubles (8-byte aligned); counter one unsigned int that is 0 between
// launches.  Returns the cudaError_t of the launch, 0 on success.
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
