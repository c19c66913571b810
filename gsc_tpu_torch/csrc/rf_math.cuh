// Elementwise functions of kernel #2's resource-function plugins, for the
// plugin build only (SUBSTEP_RF_PLUGINS; substep_megakernel.cu includes
// this header before the generated resource_plugins.cuh).
//
// Each function widens its f32 argument to double, evaluates a fixed
// sequence of IEEE double operations (range reduction, a fixed polynomial
// in Horner form, exact scaling by a power of two) with __dadd_rn /
// __dsub_rn / __dmul_rn / __ddiv_rn and rint, floor, comparisons and bit
// moves, none of which depends on the compiler's contraction or on a
// library, and rounds the result once to f32 with __double2float_rn.  The
// plain engine runs the same sequence in float64 numpy operations
// (gsc_tpu_torch/ops/rf_math.py, whose constants are these, checked by
// tests/test_torch_resource_math.py), so the kernel and the plain engine
// agree bit for bit for every f32 input, zeros, subnormals, infinities
// and NaN included.  libdevice's exp()/log() are not used: their last bits
// differ from the CPU's libm.  The double results lie within a few double
// ulps of the exact values, so the f32 results are the correctly rounded
// ones except where the exact value lies within ~1e-16 of a rounding
// boundary.
//
//   exp(x)   = 2^n * (1 + r*q(r)),  n = rint(x / ln2), r = x - n*ln2 (ln2
//              in two parts, n*LN2_HI exact), q(r) = sum r^k / (k+1)!
//   expm1(x) = (2^n - 1) + 2^n * r*q(r)   (r*q(r) alone when n = 0)
//   exp2(x)  = 2^n * (1 + t*q(t)),  n = rint(x), t = (x - n) * ln2
//   log(x)   = e*ln2 + L(f),  x = m*2^e, m in (sqrt(1/2), sqrt(2)],
//              f = m - 1, L(f) = log1p(f) = 2 atanh(s), s = f / (2 + f)
//   log1p(x) = L(x) for x in [-1/4, 3/8], else log(1 + x)
//   log2(x)  = e + L(f)/ln2,  log10(x) = e*log10(2) + L(f)/ln10
//   tanh(x)  = sign(x) * E / (E + 2),  E = expm1(2|x|)  (+-1 past |x| 20)
//   sigmoid(x) = 1 / (1 + T) for x >= 0, T / (1 + T) below, T = exp(-|x|)
//   pow(x, y) = exp(y * log|x|) with the special cases of C99's pow: y = 0
//              or x = 1 give 1; a negative finite x takes an integer y
//              (the sign of |x|^y from y's parity) and gives NaN otherwise;
//              zeros, infinities and NaN as C99 Annex F (and jnp.power)
//              has them.
#pragma once

#define RFM_LN2 0x1.62e42fefa39efp-1
#define RFM_LN2_HI 0x1.62e42fee00000p-1
#define RFM_LN2_LO 0x1.a39ef35793c76p-33
#define RFM_INV_LN2 0x1.71547652b82fep+0
#define RFM_INV_LN10 0x1.bcb7b1526e50ep-2
#define RFM_LOG10_2 0x1.34413509f79ffp-2
#define RFM_SQRT2 0x1.6a09e667f3bcdp+0
// past these |x| exp, expm1 and exp2 round to 0, -1 or inf in f32; the
// reduction is clamped to them so that n stays small
#define RFM_EXP_LIMIT 200.0
#define RFM_EXP2_LIMIT 300.0
#define RFM_TANH_ONE 20.0
// log1p's direct range (L(x) without forming 1 + x)
#define RFM_LOG1P_LO -0.25
#define RFM_LOG1P_HI 0.375

__device__ __forceinline__ float rfm_qnan() {
    return __int_as_float(0x7fc00000);
}

__device__ __forceinline__ float rfm_inf() {
    return __int_as_float(0x7f800000);
}

// 2^n for an integral double n in [-1022, 1023], exact
__device__ __forceinline__ double rfm_pow2(double n) {
    return __longlong_as_double((long long)((int)n + 1023) << 52);
}

#define RFM_H(p, r, c) __dadd_rn(__dmul_rn((p), (r)), (c))

// r * q(r) = e^r - 1 for |r| <= ~0.35: Taylor to r^13 / 13!
__device__ __forceinline__ double rfm_em1_poly(double r) {
    double p = 0x1.6124613a86d09p-33;
    p = RFM_H(p, r, 0x1.1eed8eff8d898p-29);
    p = RFM_H(p, r, 0x1.ae64567f544e4p-26);
    p = RFM_H(p, r, 0x1.27e4fb7789f5cp-22);
    p = RFM_H(p, r, 0x1.71de3a556c734p-19);
    p = RFM_H(p, r, 0x1.a01a01a01a01ap-16);
    p = RFM_H(p, r, 0x1.a01a01a01a01ap-13);
    p = RFM_H(p, r, 0x1.6c16c16c16c17p-10);
    p = RFM_H(p, r, 0x1.1111111111111p-7);
    p = RFM_H(p, r, 0x1.5555555555555p-5);
    p = RFM_H(p, r, 0x1.5555555555555p-3);
    p = RFM_H(p, r, 0x1.0000000000000p-1);
    p = RFM_H(p, r, 0x1.0000000000000p+0);
    return __dmul_rn(r, p);
}

// L(f) = log1p(f) for f in [sqrt(1/2) - 1, sqrt(2) - 1]: s = f / (2 + f),
// 2 atanh(s) = s * sum 2 s^2k / (2k + 1), to k = 10
__device__ __forceinline__ double rfm_log1p_core(double f) {
    const double s = __ddiv_rn(f, __dadd_rn(2.0, f));
    const double z = __dmul_rn(s, s);
    double p = 0x1.8618618618618p-4;
    p = RFM_H(p, z, 0x1.af286bca1af28p-4);
    p = RFM_H(p, z, 0x1.e1e1e1e1e1e1ep-4);
    p = RFM_H(p, z, 0x1.1111111111111p-3);
    p = RFM_H(p, z, 0x1.3b13b13b13b14p-3);
    p = RFM_H(p, z, 0x1.745d1745d1746p-3);
    p = RFM_H(p, z, 0x1.c71c71c71c71cp-3);
    p = RFM_H(p, z, 0x1.2492492492492p-2);
    p = RFM_H(p, z, 0x1.999999999999ap-2);
    p = RFM_H(p, z, 0x1.5555555555555p-1);
    p = RFM_H(p, z, 0x1.0000000000000p+1);
    return __dmul_rn(s, p);
}

// x = m * 2^e for a positive finite normal double x; returns e and sets
// *L = L(m - 1), m in (sqrt(1/2), sqrt(2)]
__device__ __forceinline__ double rfm_log_parts(double x, double* L) {
    const long long b = __double_as_longlong(x);
    double e = (double)((int)(b >> 52) - 1023);
    double m = __longlong_as_double((b & 0x000fffffffffffffLL)
                                    | 0x3ff0000000000000LL);
    if (m > RFM_SQRT2) {
        m = __dmul_rn(m, 0.5);
        e = __dadd_rn(e, 1.0);
    }
    *L = rfm_log1p_core(__dsub_rn(m, 1.0));
    return e;
}

// log(x) of a positive finite normal double
__device__ __forceinline__ double rfm_log_d(double x) {
    double L;
    const double e = rfm_log_parts(x, &L);
    return __dadd_rn(__dmul_rn(e, RFM_LN2), L);
}

// n = rint(x / ln2) and r = x - n ln2 of a finite x clamped to the limit
__device__ __forceinline__ double rfm_reduce(double x, double* n) {
    x = x > RFM_EXP_LIMIT ? RFM_EXP_LIMIT
        : (x < -RFM_EXP_LIMIT ? -RFM_EXP_LIMIT : x);
    const double k = rint(__dmul_rn(x, RFM_INV_LN2));
    *n = k;
    return __dsub_rn(__dsub_rn(x, __dmul_rn(k, RFM_LN2_HI)),
                     __dmul_rn(k, RFM_LN2_LO));
}

// e^x of a double that is not NaN (infinities clamp to the limit)
__device__ __forceinline__ double rfm_exp_d(double x) {
    double n;
    const double r = rfm_reduce(x, &n);
    return __dmul_rn(__dadd_rn(1.0, rfm_em1_poly(r)), rfm_pow2(n));
}

// e^x - 1 of a double that is not NaN
__device__ __forceinline__ double rfm_expm1_d(double x) {
    double n;
    const double r = rfm_reduce(x, &n);
    const double p = rfm_em1_poly(r);
    if (n == 0.0) return p;
    const double t = rfm_pow2(n);
    return __dadd_rn(__dsub_rn(t, 1.0), __dmul_rn(t, p));
}

__device__ __forceinline__ float rf_exp(float xf) {
    const double x = xf;
    if (x != x) return rfm_qnan();
    return __double2float_rn(rfm_exp_d(x));
}

__device__ __forceinline__ float rf_expm1(float xf) {
    const double x = xf;
    if (x != x) return rfm_qnan();
    if (x == 0.0) return xf;
    return __double2float_rn(rfm_expm1_d(x));
}

__device__ __forceinline__ float rf_exp2(float xf) {
    double x = xf;
    if (x != x) return rfm_qnan();
    x = x > RFM_EXP2_LIMIT ? RFM_EXP2_LIMIT
        : (x < -RFM_EXP2_LIMIT ? -RFM_EXP2_LIMIT : x);
    const double n = rint(x);
    const double t = __dmul_rn(__dsub_rn(x, n), RFM_LN2);
    return __double2float_rn(__dmul_rn(__dadd_rn(1.0, rfm_em1_poly(t)),
                                       rfm_pow2(n)));
}

// NaN below 0 (and for NaN), -inf at +-0, inf at inf, else 0 with the
// log's parts of x in e and L
__device__ __forceinline__ bool rfm_log_special(double x, float* out) {
    if (!(x >= 0.0)) { *out = rfm_qnan(); return true; }
    if (x == 0.0) { *out = -rfm_inf(); return true; }
    if (x == (double)rfm_inf()) { *out = rfm_inf(); return true; }
    return false;
}

__device__ __forceinline__ float rf_log(float xf) {
    float s;
    if (rfm_log_special(xf, &s)) return s;
    return __double2float_rn(rfm_log_d(xf));
}

__device__ __forceinline__ float rf_log2(float xf) {
    float s;
    if (rfm_log_special(xf, &s)) return s;
    double L;
    const double e = rfm_log_parts(xf, &L);
    return __double2float_rn(__dadd_rn(e, __dmul_rn(L, RFM_INV_LN2)));
}

__device__ __forceinline__ float rf_log10(float xf) {
    float s;
    if (rfm_log_special(xf, &s)) return s;
    double L;
    const double e = rfm_log_parts(xf, &L);
    return __double2float_rn(__dadd_rn(__dmul_rn(e, RFM_LOG10_2),
                                       __dmul_rn(L, RFM_INV_LN10)));
}

__device__ __forceinline__ float rf_log1p(float xf) {
    const double x = xf;
    if (x != x || x < -1.0) return rfm_qnan();
    if (x == -1.0) return -rfm_inf();
    if (x == (double)rfm_inf()) return rfm_inf();
    if (x == 0.0) return xf;
    if (x >= RFM_LOG1P_LO && x <= RFM_LOG1P_HI)
        return __double2float_rn(rfm_log1p_core(x));
    return __double2float_rn(rfm_log_d(__dadd_rn(1.0, x)));
}

__device__ __forceinline__ float rf_tanh(float xf) {
    const double x = xf;
    if (x != x) return rfm_qnan();
    if (x == 0.0) return xf;
    const double a = fabs(x);
    double t = 1.0;
    if (a <= RFM_TANH_ONE) {
        const double e = rfm_expm1_d(__dadd_rn(a, a));
        t = __ddiv_rn(e, __dadd_rn(e, 2.0));
    }
    return __double2float_rn(x < 0.0 ? -t : t);
}

__device__ __forceinline__ float rf_sigmoid(float xf) {
    const double x = xf;
    if (x != x) return rfm_qnan();
    const double t = rfm_exp_d(-fabs(x));
    const double d = __dadd_rn(1.0, t);
    return __double2float_rn(x >= 0.0 ? __ddiv_rn(1.0, d) : __ddiv_rn(t, d));
}

__device__ __forceinline__ float rf_pow(float xf, float yf) {
    const double x = xf, y = yf;
    if (y == 0.0 || x == 1.0) return 1.0f;
    if (x != x || y != y) return rfm_qnan();
    const double inf = (double)rfm_inf();
    const double ax = fabs(x);
    if (fabs(y) == inf) {
        if (ax == 1.0) return 1.0f;
        return ((ax > 1.0) == (y > 0.0)) ? rfm_inf() : 0.0f;
    }
    const bool yint = floor(y) == y;
    const double half = __dmul_rn(y, 0.5);
    const bool yodd = yint && floor(half) != half;
    const bool neg = signbit(x) != 0;
    if (x == 0.0 || ax == inf) {
        // |x|^y is 0 or inf; an odd integer y keeps x's sign
        const float mag = ((x == 0.0) == (y < 0.0)) ? rfm_inf() : 0.0f;
        return (neg && yodd) ? -mag : mag;
    }
    if (neg && !yint) return rfm_qnan();
    const double r = rfm_exp_d(__dmul_rn(y, rfm_log_d(ax)));
    return __double2float_rn(neg && yodd ? -r : r);
}

#undef RFM_H
