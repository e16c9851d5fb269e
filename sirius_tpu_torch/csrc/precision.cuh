// The element types of the fp64 and fp32 instantiations of the port's
// kernels.
//
// A kernel templated on its real type R runs on complex blocks of
// cplx_t<R> (double2 for complex128, float2 for complex64, the layouts of
// cuDoubleComplex and cuFloatComplex) with tables of R. The *_rn helpers
// are the rounded multiply / add / subtract of that type, which the
// compiler may not contract into a fused multiply-add, and sincospi_ is
// sincospi / sincospif.
#pragma once

#include <cuda_runtime.h>

template <typename R>
struct Cplx;
template <>
struct Cplx<double> {
    using type = double2;
};
template <>
struct Cplx<float> {
    using type = float2;
};
template <typename R>
using cplx_t = typename Cplx<R>::type;

template <typename R>
__device__ __forceinline__ cplx_t<R> make_cplx(R re, R im) {
    cplx_t<R> z;
    z.x = re;
    z.y = im;
    return z;
}

__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ void sincospi_(double x, double* s, double* c) {
    sincospi(x, s, c);
}
__device__ __forceinline__ void sincospi_(float x, float* s, float* c) {
    sincospif(x, s, c);
}
