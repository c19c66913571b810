// A check of rf_math.cuh on the card, never on the main path: one thread
// per element evaluates every function of the header on (x[i], y[i]) and
// writes RF_PROBE_OUTPUTS results per element, in the order of
// gsc_tpu_torch/ops/rf_math.py's PROBE_ORDER, for the tests and
// chip_smoke.py to hold against the plain version bit for bit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rf_math.cuh"

#define RF_PROBE_OUTPUTS 10

__global__ void rf_math_probe_kernel(const float* x, const float* y,
                                     float* out, long long n) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float a = x[i], b = y[i];
    float* o = out + i * RF_PROBE_OUTPUTS;
    o[0] = rf_exp(a);
    o[1] = rf_expm1(a);
    o[2] = rf_exp2(a);
    o[3] = rf_log(a);
    o[4] = rf_log1p(a);
    o[5] = rf_log2(a);
    o[6] = rf_log10(a);
    o[7] = rf_tanh(a);
    o[8] = rf_sigmoid(a);
    o[9] = rf_pow(a, b);
}

extern "C" int rf_math_probe_outputs() { return RF_PROBE_OUTPUTS; }

extern "C" int rf_math_probe(const float* x, const float* y, float* out,
                             long long n, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    rf_math_probe_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(x, y, out, n);
    return (int)cudaGetLastError();
}
