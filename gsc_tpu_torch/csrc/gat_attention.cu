// Fused GATv2 attention stage, f32, for Hopper (sm_90a).
//
// Replaces the TPU kernel gsc_tpu/ops/pallas_gat.py::_gat_kernel (launched
// by _gatv2_pallas_impl).  Given projected features xl, xr [B, N, F], the
// attention vector att [F], bias [F] and the adjacency adj [B, N, N]
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
// What bounds it on this card: at the serving shapes (B = 1..8 graphs,
// N = 24, F = 22, three calls per actor forward) one call moves a few KB and
// does a few hundred thousand flops, so it is bound by the launch itself,
// not by memory or arithmetic.  The design therefore does the whole stage
// in ONE launch with no intermediate in device memory: the pairwise
// [N, N, F] tensor, the logits and the softmax live in registers and shared
// memory only.  It is written for correctness first:
//
// - one CTA (8 warps) per graph; xl[b], xr[b], att and bias are staged in
//   shared memory once;
// - one warp per target row i (warps stride over rows), lanes over source
//   j in chunks of 32 with a running max and sum (online softmax), so any
//   N works; the warp combines lanes with shuffles;
// - each warp keeps its row's alpha in a shared buffer of N floats, then
//   the output loop puts lanes over f;
// - shared memory is sized from N and F at launch; above 48 KB the launch
//   raises the kernel's dynamic shared-memory limit first.
//
// The host function returns the CUDA error of the launch (0 = success);
// the Python wrapper raises on anything else.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr float kNegInf = -1e30f;
constexpr float kSlope = 0.2f;

__global__ void __launch_bounds__(kWarps * 32)
gat_attention_kernel(const float* __restrict__ xl,
                     const float* __restrict__ xr,
                     const float* __restrict__ att,
                     const float* __restrict__ bias,
                     const unsigned char* __restrict__ adj,
                     float* __restrict__ out, int n, int f, int mean_aggr) {
  extern __shared__ float smem[];
  float* s_xl = smem;                 // [n * f]
  float* s_xr = s_xl + n * f;         // [n * f]
  float* s_att = s_xr + n * f;        // [f]
  float* s_bias = s_att + f;          // [f]
  float* s_alpha = s_bias + f;        // [kWarps * n]

  const int b = blockIdx.x;
  const size_t feat_base = static_cast<size_t>(b) * n * f;
  for (int k = threadIdx.x; k < n * f; k += blockDim.x) {
    s_xl[k] = xl[feat_base + k];
    s_xr[k] = xr[feat_base + k];
  }
  for (int k = threadIdx.x; k < f; k += blockDim.x) {
    s_att[k] = att[k];
    s_bias[k] = bias[k];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* alpha = s_alpha + warp * n;
  const unsigned char* adj_b = adj + static_cast<size_t>(b) * n * n;

  for (int i = warp; i < n; i += kWarps) {
    const unsigned char* arow = adj_b + static_cast<size_t>(i) * n;
    const float* xr_i = s_xr + i * f;

    // pass 1: logits, with a running max and rescaled running sum per lane
    float run_max = kNegInf;
    float run_sum = 0.f;
    int deg = 0;
    for (int j = lane; j < n; j += 32) {
      float logit = kNegInf;
      if (arow[j]) {
        const float* xl_j = s_xl + j * f;
        float acc = 0.f;
        for (int k = 0; k < f; ++k) {
          float e = xl_j[k] + xr_i[k];
          e = e >= 0.f ? e : kSlope * e;
          acc += e * s_att[k];
        }
        logit = acc;
        ++deg;
        if (logit > run_max) {
          run_sum = run_sum * expf(run_max - logit) + 1.f;
          run_max = logit;
        } else {
          run_sum += expf(logit - run_max);
        }
      }
      alpha[j] = logit;
    }
    // combine the lanes' (max, sum) pairs and degrees
    for (int off = 16; off > 0; off >>= 1) {
      const float o_max = __shfl_xor_sync(0xffffffffu, run_max, off);
      const float o_sum = __shfl_xor_sync(0xffffffffu, run_sum, off);
      const float m = fmaxf(run_max, o_max);
      run_sum = run_sum * expf(run_max - m) + o_sum * expf(o_max - m);
      run_max = m;
      deg += __shfl_xor_sync(0xffffffffu, deg, off);
    }
    const float denom = fmaxf(run_sum, 1e-30f);
    __syncwarp();

    // pass 2: normalised attention weights (exact zeros off the adjacency)
    for (int j = lane; j < n; j += 32) {
      alpha[j] = arow[j] ? expf(alpha[j] - run_max) / denom : 0.f;
    }
    __syncwarp();

    // pass 3: aggregation, lanes over features
    const float deg_f = mean_aggr ? static_cast<float>(max(deg, 1)) : 1.f;
    float* out_i = out + feat_base + static_cast<size_t>(i) * f;
    for (int k = lane; k < f; k += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc += alpha[j] * s_xl[j * f + k];
      out_i[k] = deg > 0 ? acc / deg_f + s_bias[k] : 0.f;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one launch, in bytes.
long long gat_attention_smem_bytes(int n, int f) {
  return (2LL * n * f + 2LL * f + static_cast<long long>(kWarps) * n) *
         static_cast<long long>(sizeof(float));
}

// Launch on `stream`; adj is one byte per entry (torch.bool).  Returns the
// cudaError_t of the launch, 0 on success.
int gat_attention_f32(const float* xl, const float* xr, const float* att,
                      const float* bias, const void* adj, float* out,
                      int batch, int n, int f, int mean_aggr, void* stream) {
  const long long smem = gat_attention_smem_bytes(n, f);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gat_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (batch == 0) return 0;
  gat_attention_kernel<<<batch, kWarps * 32, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      xl, xr, att, bias, static_cast<const unsigned char*>(adj), out, n, f,
      mean_aggr);
  return static_cast<int>(cudaGetLastError());
}

const char* gat_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
