// K17: the pointwise passes of the effective potential,
// dft/potential.py::generate_potential (every collinear path: the fused
// step, the host loop, the initial potential) and the Hartree + V_eff pass
// of dft/potential_nc.py::generate_potential_nc.
//
// Replaces the XLA fusions of sirius_tpu/dft/potential.py::
// generate_potential_device (:256-383) between its transforms and its XC
// call:
//   K17a xc_inputs (:297-304, :332): from the inverse-transformed rho (and
//       m) boxes, complex128, and the core charge rho_core_r:
//         rho_r = Re rho, rho_exc = rho_r + rho_core_r,
//         rho_xc = max(rho_exc, floor)   (floor 0 unpolarized, 1e-20 not)
//       and polarized mag_r = Re m, m' = clip(mag_r, -rho_xc, rho_xc),
//         n_up = 0.5 (rho_xc + m'), n_dn = 0.5 (rho_xc - m');
//   K17b xc_outputs (:318-331, :336-346): from the XC kernel's e and v (or
//       v_up, v_dn) and, for GGA and mGGA, the inverse-transformed
//       divergence boxes (complex128, real parts read):
//         exc_r = e / max(rho_xc, 1e-25),
//         V_xc = v - div (unpolarized), or 0.5 (v_up' + v_dn') and
//         B_z = 0.5 (v_up' - v_dn') with v_s' = v_s - div_s,
//       V_xc also as float64 (the energy integrands read it) and V_xc, B_z
//       as the complex128 boxes (x, +0) that cuFFT takes (r_to_g's cast);
//   K17c hartree_veff (poisson.py:19-23, potential.py:295, :349):
//         vha = glen2 > 1e-12 ? (4 pi rho) / glen2 : 0,
//         veff = (vloc + vha) + vxc
//       and gga_inputs (:306-307, :334), the rows whose gradients K10a
//       takes: rho + rho_core (unpolarized), or
//         0.5 ((rho [+ rho_core]) + m), 0.5 ((rho [+ rho_core]) - m);
//   K17d coarse_fill (:356-358, the gather f_g[c2f] and the scatter into a
//       zeroed coarse box) through a host-built table t [n_coarse_box]:
//         box_f[j] = t[j] >= 0 ? f[t[j]] : 0   (up to four fields f)
//       and coarse_stack (:360-365): from the inverse-transformed coarse
//       boxes, [Re V + Re B, Re V - Re B] (spin) or [Re f] per field.
//
// Bits: those of the plain PyTorch version on the card (kernels/
// hartree_veff.py, xc_inputs.py, xc_outputs.py, coarse_potential.py), NaN
// payloads and signs of zero included:
// - torch.clamp(x, min=lo) is isnan(x) ? x : max(x, lo), and
//   torch.maximum / minimum(a, b) is a != a ? a : b != b ? b : max / min
//   (PyTorch's CUDA lambdas); CUDA's fmax / fmin alone would drop a NaN,
//   which the SCF supervisor's NaN rung reads downstream;
// - a complex tensor times a host scalar s is c10::complex's product
//   (s, 0) * z, and a complex tensor over a float64 one is c10::complex's
//   quotient z / (c, 0) (torch/headeronly/util/complex.h, operator*= and
//   operator/=): the same expressions here, operand for operand, with the
//   scalar's zero imaginary part passed at run time as PyTorch's is, so
//   nvcc compiles the same generic arithmetic;
// - the real -> complex cast writes (x, +0); the coarse fill copies the
//   field's value as K1's store did (a -0 stays -0) and writes +0 + 0i
//   outside the coarse sphere;
// - a complex add is torch's a + alpha * b (alpha = (+-1, 0), the product
//   c10's; a real add is a + b, which its fma(alpha, b, a) rounds alike);
// - sums keep the plain order: (vloc + vha) + vxc, 0.5 * (a +- b).
//
// Bound on the H100: bytes. Each pass reads and writes its boxes once;
// one thread a point (or G, or coarse slot), consecutive threads on
// consecutive elements, over a grid-stride loop; complex inputs whose real
// parts alone are read take 8-byte loads at a 16-byte stride.
//
// Plain C interface (loaded with ctypes); every launch goes on the stream
// passed in, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

int blocks_for(long long n) {
    long long b = (n + kThreads - 1) / kThreads;
    if (b > 65535LL * 32) b = 65535LL * 32;
    return b < 1 ? 1 : static_cast<int>(b);
}

// torch.clamp(x, min=lo)
__device__ __forceinline__ double clamp_min(double x, double lo) {
    return isnan(x) ? x : ::max(x, lo);
}

// torch.maximum(a, b), torch.minimum(a, b)
__device__ __forceinline__ double maximum(double a, double b) {
    return a != a ? a : (b != b ? b : ::max(a, b));
}

__device__ __forceinline__ double minimum(double a, double b) {
    return a != a ? a : (b != b ? b : ::min(a, b));
}

// c10::complex<double>: lhs (a, b) *= rhs (c, d)
__device__ __forceinline__ double2 c10_mul(double a, double b, double2 z) {
    const double c = z.x;
    const double d = z.y;
    return make_double2(a * c - b * d, a * d + b * c);
}

// torch.add / torch.sub on complex128: a + alpha * b with alpha = (+-1,
// 0), the product c10::complex's (PyTorch's CUDA add kernel; sub is add
// with -alpha). For finite operands it is the componentwise sum, but an
// infinite or NaN part of b reaches both parts of the result, and a zero
// part of b may change its sign
__device__ __forceinline__ double2 c10_add(double2 a, double ar, double ai,
                                           double2 b) {
    const double2 t = c10_mul(ar, ai, b);
    return make_double2(a.x + t.x, a.y + t.y);
}

// c10::complex<double>: lhs z /= rhs (c, d)
__device__ __forceinline__ double2 c10_div(double2 z, double c, double d) {
    const double a = z.x;
    const double b = z.y;
    const double abs_c = fabs(c);
    const double abs_d = fabs(d);
    double re, im;
    if (abs_c >= abs_d) {
        if (abs_c == 0.0 && abs_d == 0.0) {
            re = a / abs_c;
            im = b / abs_d;
        } else {
            const double rat = d / c;
            const double scl = 1.0 / (c + d * rat);
            re = (a + b * rat) * scl;
            im = (b - a * rat) * scl;
        }
    } else {
        const double rat = c / d;
        const double scl = 1.0 / (d + c * rat);
        re = (a * rat + b) * scl;
        im = (b * rat - a) * scl;
    }
    return make_double2(re, im);
}

// one = 1 and zero = 0: the imaginary parts of the host scalars and of
// add's alpha, and alpha's real part, all passed at run time as PyTorch's
// are, so nvcc sees the generic expressions
__global__ void hartree_veff_kernel(const double2* __restrict__ rho,
                                    const double* __restrict__ glen2,
                                    const double2* __restrict__ vloc,
                                    const double2* __restrict__ vxc,
                                    double four_pi, double one, double zero,
                                    long long ng, double2* __restrict__ vha,
                                    double2* __restrict__ veff) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < ng; i += (long long)gridDim.x * blockDim.x) {
        const double g = glen2[i];
        const bool nonzero = g > 1e-12;
        const double c = nonzero ? g : 1.0;
        const double2 v = c10_div(c10_mul(four_pi, zero, rho[i]), c, zero);
        const double2 h = nonzero ? v : make_double2(0.0, 0.0);
        vha[i] = h;
        veff[i] = c10_add(c10_add(vloc[i], one, zero, h), one, zero, vxc[i]);
    }
}

__global__ void gga_inputs_kernel(const double2* __restrict__ rho,
                                  const double2* __restrict__ core,
                                  const double2* __restrict__ mag,
                                  double half, double one, double zero,
                                  long long ng, double2* __restrict__ out) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < ng; i += (long long)gridDim.x * blockDim.x) {
        double2 r = rho[i];
        if (core) r = c10_add(r, one, zero, core[i]);
        if (!mag) {
            out[i] = r;
            continue;
        }
        const double2 m = mag[i];
        out[i] = c10_mul(half, zero, c10_add(r, one, zero, m));
        out[ng + i] = c10_mul(half, zero, c10_add(r, -one, zero, m));
    }
}

__global__ void xc_inputs_kernel(const double* __restrict__ rho_box,
                                 const double* __restrict__ core,
                                 const double* __restrict__ mag_box,
                                 double floor, long long n,
                                 double* __restrict__ rho_r,
                                 double* __restrict__ rho_exc,
                                 double* __restrict__ rho_xc,
                                 double* __restrict__ mag_r,
                                 double* __restrict__ n_up,
                                 double* __restrict__ n_dn) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        const double r = rho_box[2 * i];
        // without a core charge the plain version adds its zero table
        const double t = r + (core ? core[i] : 0.0);
        const double x = clamp_min(t, floor);
        rho_r[i] = r;
        rho_exc[i] = t;
        rho_xc[i] = x;
        if (!mag_box) continue;
        const double mr = mag_box[2 * i];
        const double m = minimum(maximum(mr, -x), x);
        mag_r[i] = mr;
        n_up[i] = 0.5 * (x + m);
        n_dn[i] = 0.5 * (x - m);
    }
}

__global__ void xc_outputs_kernel(const double* __restrict__ e,
                                  const double* __restrict__ v0,
                                  const double* __restrict__ v1,
                                  const double* __restrict__ div,
                                  const double* __restrict__ rho_xc,
                                  long long n, double* __restrict__ exc,
                                  double* __restrict__ vxc_r,
                                  double2* __restrict__ vxc_box,
                                  double2* __restrict__ bz_box) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        exc[i] = e[i] / clamp_min(rho_xc[i], 1e-25);
        double vx;
        if (!v1) {
            vx = v0[i];
            if (div) vx = vx - div[2 * i];
        } else {
            double vu = v0[i];
            double vd = v1[i];
            if (div) {
                vu = vu - div[2 * i];
                vd = vd - div[2 * (n + i)];
            }
            vx = 0.5 * (vu + vd);
            bz_box[i] = make_double2(0.5 * (vu - vd), 0.0);
        }
        if (vxc_r) vxc_r[i] = vx;
        vxc_box[i] = make_double2(vx, 0.0);
    }
}

constexpr int kMaxFields = 4;

struct Fields {
    const double2* in[kMaxFields];
    double2* out[kMaxFields];
};

__global__ void coarse_fill_kernel(Fields f, int nf,
                                   const int* __restrict__ table,
                                   long long nbox) {
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         j < nbox; j += (long long)gridDim.x * blockDim.x) {
        const int t = table[j];
        for (int s = 0; s < nf; ++s)
            f.out[s][j] = t >= 0 ? f.in[s][t] : make_double2(0.0, 0.0);
    }
}

struct Boxes {
    const double* in[kMaxFields];
};

__global__ void coarse_stack_kernel(Boxes b, int nf, int spin,
                                    long long nbox,
                                    double* __restrict__ out) {
    for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         j < nbox; j += (long long)gridDim.x * blockDim.x) {
        if (spin) {
            const double v = b.in[0][2 * j];
            const double bz = b.in[1][2 * j];
            out[j] = v + bz;
            out[nbox + j] = v - bz;
        } else {
            for (int s = 0; s < nf; ++s) out[s * nbox + j] = b.in[s][2 * j];
        }
    }
}

}  // namespace

// rho, vloc, vxc [ng] complex128, glen2 [ng] float64; four_pi = 4 pi,
// one = 1, zero = 0; vha, veff [ng] complex128
extern "C" int hartree_veff(const void* rho, const void* glen2,
                            const void* vloc, const void* vxc, double four_pi,
                            double one, double zero, long long ng, void* vha,
                            void* veff, void* stream) {
    hartree_veff_kernel<<<blocks_for(ng), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const double2*)rho, (const double*)glen2, (const double2*)vloc,
        (const double2*)vxc, four_pi, one, zero, ng, (double2*)vha,
        (double2*)veff);
    return (int)cudaGetLastError();
}

// rho [ng] complex128, core and mag [ng] complex128 or null; half = 0.5,
// one = 1, zero = 0; out [1 or 2, ng] complex128 (2 where mag is given)
extern "C" int gga_inputs(const void* rho, const void* core, const void* mag,
                          double half, double one, double zero, long long ng,
                          void* out, void* stream) {
    gga_inputs_kernel<<<blocks_for(ng), kThreads, 0, (cudaStream_t)stream>>>(
        (const double2*)rho, (const double2*)core, (const double2*)mag, half,
        one, zero, ng, (double2*)out);
    return (int)cudaGetLastError();
}

// rho_box [n] complex128, core [n] float64 or null, mag_box [n] complex128
// or null; rho_r, rho_exc, rho_xc [n] float64, and where mag_box is given
// mag_r, n_up, n_dn [n] float64
extern "C" int xc_inputs(const void* rho_box, const void* core,
                         const void* mag_box, double floor, long long n,
                         void* rho_r, void* rho_exc, void* rho_xc,
                         void* mag_r, void* n_up, void* n_dn, void* stream) {
    xc_inputs_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)rho_box, (const double*)core, (const double*)mag_box,
        floor, n, (double*)rho_r, (double*)rho_exc, (double*)rho_xc,
        (double*)mag_r, (double*)n_up, (double*)n_dn);
    return (int)cudaGetLastError();
}

// e, v0, rho_xc [n] float64, v1 [n] float64 or null (unpolarized), div
// [1 or 2, n] complex128 or null (LDA); exc [n] float64, vxc_r [n] float64
// or null, vxc_box [n] complex128, bz_box [n] complex128 (with v1)
extern "C" int xc_outputs(const void* e, const void* v0, const void* v1,
                          const void* div, const void* rho_xc, long long n,
                          void* exc, void* vxc_r, void* vxc_box, void* bz_box,
                          void* stream) {
    xc_outputs_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const double*)e, (const double*)v0, (const double*)v1,
        (const double*)div, (const double*)rho_xc, n, (double*)exc,
        (double*)vxc_r, (double2*)vxc_box, (double2*)bz_box);
    return (int)cudaGetLastError();
}

// in0..in3 [ng] complex128 fine-G fields (the first nf used), table [nbox]
// int32 (coarse box slot -> fine G, -1 outside the coarse sphere);
// out0..out3 [nbox] complex128
extern "C" int coarse_fill(const void* in0, const void* in1, const void* in2,
                           const void* in3, int nf, const void* table,
                           long long nbox, void* out0, void* out1, void* out2,
                           void* out3, void* stream) {
    if (nf < 1 || nf > kMaxFields) return (int)cudaErrorInvalidValue;
    Fields f = {{(const double2*)in0, (const double2*)in1,
                 (const double2*)in2, (const double2*)in3},
                {(double2*)out0, (double2*)out1, (double2*)out2,
                 (double2*)out3}};
    coarse_fill_kernel<<<blocks_for(nbox), kThreads, 0,
                         (cudaStream_t)stream>>>(f, nf, (const int*)table,
                                                 nbox);
    return (int)cudaGetLastError();
}

// in0..in3 [nbox] complex128 transformed coarse boxes (the first nf used);
// spin = 1 takes nf = 2 (V, B) and writes [V + B, V - B], else [Re in_s];
// out [ns, nbox] float64
extern "C" int coarse_stack(const void* in0, const void* in1, const void* in2,
                            const void* in3, int nf, int spin, long long nbox,
                            void* out, void* stream) {
    if (nf < 1 || nf > kMaxFields || (spin && nf != 2))
        return (int)cudaErrorInvalidValue;
    Boxes b = {{(const double*)in0, (const double*)in1, (const double*)in2,
                (const double*)in3}};
    coarse_stack_kernel<<<blocks_for(nbox), kThreads, 0,
                          (cudaStream_t)stream>>>(b, nf, spin, nbox,
                                                  (double*)out);
    return (int)cudaGetLastError();
}
