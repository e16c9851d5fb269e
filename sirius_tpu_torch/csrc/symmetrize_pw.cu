// K6: plane-wave symmetrization over the space group, as a gather.
//
// Replaces sirius_tpu/dft/density.py::symmetrize_pw_device (:348-358) and
// its host twin symmetrize_pw (:155-187). For every target G' of the set:
//   out[g'] = (1/nops) sum_op  f[g(op, g')] * (e^{-2 pi i m_g' . t_op} s_op)
// where g(op, g') is the G whose Miller index is w_k^{-1} m_g' (the JAX
// package scatters f[g] to its image w_k m_g, the same sum read from the
// target side), t_op the fractional translation and s_op the spin sign of
// the op for the z-component of an axial field (1 otherwise).
//
// The JAX package builds dense [nops, ng] index and phase tables: at the
// 16-atom cell (384 ops, 291,693 G) that is 2.2 GB. Here each thread
// rotates its own Miller index with the op's integer matrix, wraps it into
// the fine FFT box, reads the source G from a box -> G lookup table
// ([N_fine] int32, -1 off the sphere) and generates the phase with
// sincospi. The host checks once, when the tables are built, that every
// rotated Miller lands in the G set; the kernel traps on a -1 slot rather
// than read a wrong coefficient.
//
// Bound on the H100: operations. f (16 B per G) fits in the 50 MB L2, so
// device memory moves f, the Millers, the lookup table and out once; the
// work is nops gathers from L2 and nops sincospi per G.
//
// Design: one thread per target G (grid stride) sums the ops in index
// order 0..nops-1, the order in which the JAX package's scatter meets each
// target, then divides by nops: no atomics, bit-reproducible.
//
// K6v (symmetrize_vector_pw) is the axial-vector form, replacing the host
// scatter of sirius_tpu/dft/potential_nc.py::symmetrize_vector_pw (:47-67):
//   out_i[g'] = (1/nops) sum_op sum_j A_op[i][j] f_j[g(op, g')] e^{-2 pi i m_g' . t_op}
// over the three components f [3, ng] in one launch, with A_op = det(R) R the
// op's Cartesian rotation of an axial vector. The JAX package scatters the
// rotated vector of g to its image w_k g; read from the target side the
// source is g = w_k^{-1} g' and the rotation applied to it is the same
// A_op (the op moves both the point and the vector). One thread per target G
// sums the ops in order, all three components at once.
//
// Plain C interface (loaded with ctypes); launches on the stream passed in,
// allocates nothing, returns cudaGetLastError().
#include <cuda_runtime.h>
#include <cuComplex.h>

namespace {

__device__ __forceinline__ int wrap(int m, int n) {
    const int r = m % n;
    return r < 0 ? r + n : r;
}

__global__ void symmetrize_pw_kernel(const cuDoubleComplex* __restrict__ f,
                                     const int* __restrict__ millers,
                                     const int* __restrict__ lut,
                                     const int* __restrict__ rot,
                                     const double* __restrict__ trans,
                                     const double* __restrict__ sign,
                                     cuDoubleComplex* __restrict__ out,
                                     int nops, long long ng, int n1, int n2,
                                     int n3) {
    for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         g < ng; g += (long long)gridDim.x * blockDim.x) {
        const int m0 = millers[3 * g], m1 = millers[3 * g + 1],
                  m2 = millers[3 * g + 2];
        double acc_re = 0.0, acc_im = 0.0;
        for (int op = 0; op < nops; ++op) {
            const int* r = rot + 9 * op;
            const int s0 = r[0] * m0 + r[1] * m1 + r[2] * m2;
            const int s1 = r[3] * m0 + r[4] * m1 + r[5] * m2;
            const int s2 = r[6] * m0 + r[7] * m1 + r[8] * m2;
            const int src = lut[((long long)wrap(s0, n1) * n2 + wrap(s1, n2)) * n3
                                + wrap(s2, n3)];
            if (src < 0) __trap();
            const double* t = trans + 3 * op;
            const double x = (double)m0 * t[0] + (double)m1 * t[1] + (double)m2 * t[2];
            double sn, cs;
            sincospi(-2.0 * x, &sn, &cs);
            if (sign != nullptr) {
                cs *= sign[op];
                sn *= sign[op];
            }
            const cuDoubleComplex v = f[src];
            acc_re += v.x * cs - v.y * sn;
            acc_im += v.x * sn + v.y * cs;
        }
        out[g] = make_cuDoubleComplex(acc_re / nops, acc_im / nops);
    }
}

__global__ void symmetrize_vector_kernel(const cuDoubleComplex* __restrict__ f,
                                         const int* __restrict__ millers,
                                         const int* __restrict__ lut,
                                         const int* __restrict__ rot,
                                         const double* __restrict__ trans,
                                         const double* __restrict__ srot,
                                         cuDoubleComplex* __restrict__ out,
                                         int nops, long long ng, int n1,
                                         int n2, int n3) {
    for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         g < ng; g += (long long)gridDim.x * blockDim.x) {
        const int m0 = millers[3 * g], m1 = millers[3 * g + 1],
                  m2 = millers[3 * g + 2];
        double acc_re[3] = {0.0, 0.0, 0.0}, acc_im[3] = {0.0, 0.0, 0.0};
        for (int op = 0; op < nops; ++op) {
            const int* r = rot + 9 * op;
            const int s0 = r[0] * m0 + r[1] * m1 + r[2] * m2;
            const int s1 = r[3] * m0 + r[4] * m1 + r[5] * m2;
            const int s2 = r[6] * m0 + r[7] * m1 + r[8] * m2;
            const int src = lut[((long long)wrap(s0, n1) * n2 + wrap(s1, n2)) * n3
                                + wrap(s2, n3)];
            if (src < 0) __trap();
            const double* t = trans + 3 * op;
            const double x = (double)m0 * t[0] + (double)m1 * t[1] + (double)m2 * t[2];
            double sn, cs;
            sincospi(-2.0 * x, &sn, &cs);
            cuDoubleComplex v[3];
            for (int j = 0; j < 3; ++j) v[j] = f[j * ng + src];
            const double* a = srot + 9 * op;
            for (int i = 0; i < 3; ++i) {
                const double vr = a[3 * i] * v[0].x + a[3 * i + 1] * v[1].x
                                  + a[3 * i + 2] * v[2].x;
                const double vi = a[3 * i] * v[0].y + a[3 * i + 1] * v[1].y
                                  + a[3 * i + 2] * v[2].y;
                acc_re[i] += vr * cs - vi * sn;
                acc_im[i] += vr * sn + vi * cs;
            }
        }
        for (int i = 0; i < 3; ++i)
            out[i * ng + g] = make_cuDoubleComplex(acc_re[i] / nops,
                                                   acc_im[i] / nops);
    }
}

}  // namespace

extern "C" int symmetrize_vector_pw(const void* f, const int* millers,
                                    const int* lut, const int* rot,
                                    const double* trans, const double* srot,
                                    void* out, int nops, long long ng, int n1,
                                    int n2, int n3, void* stream) {
    const int threads = 256;
    long long blocks = (ng + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks > 0)
        symmetrize_vector_kernel<<<(int)blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
            (const cuDoubleComplex*)f, millers, lut, rot, trans, srot,
            (cuDoubleComplex*)out, nops, ng, n1, n2, n3);
    return (int)cudaGetLastError();
}

extern "C" int symmetrize_pw(const void* f, const int* millers, const int* lut,
                             const int* rot, const double* trans,
                             const double* sign, void* out, int nops,
                             long long ng, int n1, int n2, int n3,
                             void* stream) {
    const int threads = 256;
    long long blocks = (ng + threads - 1) / threads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks > 0)
        symmetrize_pw_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const cuDoubleComplex*)f, millers, lut, rot, trans, sign,
            (cuDoubleComplex*)out, nops, ng, n1, n2, n3);
    return (int)cudaGetLastError();
}
